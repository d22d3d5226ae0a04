"""The one traffic generator: reads a mix's parameters, draws its stream.

A mix (`traffic/<name>.json`) is data. Its `kind` names the stream:

* `query`: (s, t) pairs, each end drawn uniformly from the largest
  connected component (Graph500 likewise draws its roots among connected
  vertices; a pair with no path would keep a bidirectional search
  running to `max_steps`). A pool of `pool` pairs is drawn once; query i
  is pair i of it, round the pool again if a window outruns it. The
  queries go in microbatches of `microbatch`, back to back.
* `update`: batches of `deletes` deletions and `inserts` insertions.
  Deletions take the graph's edges in one permutation drawn from the
  configuration's `graph_seed`, so batch k deletes the same edges of the
  graph in every run, under the run's names: a seed changes the names
  and not the work; insertions take new pairs (u < v, not an edge of the
  graph, each once) in an order drawn from the run's seed.

Streams depend on the seed alone: the same seed gives the same stream.
The graph is the configuration's own (its `graph_seed`), named anew from
each run's seed by `relabel`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The op codes of an update row, in the program's batch format.
OP_INS, OP_DEL = 0, 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A torch generator on `device` for one named stream of a seed: the
    streams of a seed are independent, and each repeats with the seed."""
    seed %= 1 << 64
    words = [seed & 0xFFFFFFFF, seed >> 32] + [ord(c) for c in stream]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def relabel(edges: torch.Tensor, n: int, gen: torch.Generator,
            keep_order: bool = False) -> torch.Tensor:
    """The same graph under a random naming of its `n` vertices: every
    seed serves one deployment's graph (the same degrees, distances and
    work), with its ids in another order. int64 [E, 2], u < v, sorted;
    with `keep_order`, edge i is edge i of `edges` renamed."""
    perm = torch.randperm(n, generator=gen, device=edges.device)
    a, b = perm[edges[:, 0]], perm[edges[:, 1]]
    u, v = torch.minimum(a, b), torch.maximum(a, b)
    if keep_order:
        return torch.stack([u, v], dim=1)
    key, _ = torch.sort(u * n + v)
    return torch.stack([key // n, key % n], dim=1)


@dataclasses.dataclass
class QueryStream:
    qs: np.ndarray          # int32 [pool]
    qt: np.ndarray          # int32 [pool]
    microbatch: int

    def batch(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Microbatch k: (sources, targets), int32 [microbatch] each."""
        lo = (k * self.microbatch) % self.qs.shape[0]
        hi = lo + self.microbatch
        return self.qs[lo:hi], self.qt[lo:hi]

    def take(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Queries `idx`: (sources, targets), int32 each."""
        idx = np.asarray(idx) % self.qs.shape[0]
        return self.qs[idx], self.qt[idx]


def query_stream(mix: dict, seed: int, component: torch.Tensor
                 ) -> QueryStream:
    """The query mix's stream over the vertices of `component` (int64)."""
    mb, pool = int(mix["microbatch"]), int(mix["pool"])
    if pool % mb:
        raise ValueError(f"pool {pool} is not a multiple of the microbatch "
                         f"{mb}")
    gen = generator(seed, "queries", component.device)
    pick = torch.randint(0, component.shape[0], (2, pool), generator=gen,
                         device=component.device)
    ends = component[pick].to(torch.int32).cpu().numpy()
    return QueryStream(ends[0].copy(), ends[1].copy(), mb)


@dataclasses.dataclass
class UpdateStream:
    deletes: np.ndarray     # int64 [D, 2], in deletion order
    inserts: np.ndarray     # int64 [I, 2], in insertion order
    n_del: int
    n_ins: int

    @property
    def batch_size(self) -> int:
        return self.n_del + self.n_ins

    def batches(self) -> int:
        """How many whole batches the stream holds."""
        by_del = (self.deletes.shape[0] // self.n_del if self.n_del
                  else 1 << 62)
        by_ins = (self.inserts.shape[0] // self.n_ins if self.n_ins
                  else 1 << 62)
        return min(by_del, by_ins)

    def rows(self, k: int) -> list[tuple[int, int, int]]:
        """Batch k as the program's update rows (u, v, op): its deletions,
        then its insertions."""
        if k >= self.batches():
            raise IndexError(f"the update stream holds {self.batches()} "
                             f"batches, batch {k} was asked for")
        d = self.deletes[k * self.n_del:(k + 1) * self.n_del].tolist()
        i = self.inserts[k * self.n_ins:(k + 1) * self.n_ins].tolist()
        return ([(u, v, OP_DEL) for u, v in d]
                + [(u, v, OP_INS) for u, v in i])

    def edges_after(self, edges: torch.Tensor, n: int, k: int
                    ) -> torch.Tensor:
        """The edge set after batches 0..k-1 applied to `edges` (int64
        [E, 2], u < v, vertex ids below n), as int64 [E', 2]."""
        gone = torch.as_tensor(self.deletes[:k * self.n_del],
                               device=edges.device)
        added = torch.as_tensor(self.inserts[:k * self.n_ins],
                                device=edges.device)
        keep = ~torch.isin(edges[:, 0] * n + edges[:, 1],
                           gone[:, 0] * n + gone[:, 1])
        return torch.cat([edges[keep], added.reshape(-1, 2)])


def update_stream(mix: dict, seed: int, edges: torch.Tensor, n: int,
                  deletion_seed: int) -> UpdateStream:
    """The update mix's stream over the graph's `edges` (int64 [E, 2],
    u < v, on the device): deletions in a permutation of `edges` drawn
    from `deletion_seed`, insertions drawn from `seed`."""
    n_del, n_ins = int(mix["deletes"]), int(mix["inserts"])
    if n_del + n_ins <= 0:
        raise ValueError("an update batch needs a deletion or an insertion")
    gen = generator(seed, "updates", edges.device)
    order = torch.randperm(edges.shape[0], generator=generator(
        deletion_seed, "deletions", edges.device), device=edges.device)
    deletes = edges[order].cpu().numpy()
    inserts = np.zeros((0, 2), np.int64)
    if n_ins:
        want = int(mix["insert_pool"])
        ends = torch.randint(0, n, (2, 2 * want + 1024), generator=gen,
                             device=edges.device)
        u, v = torch.minimum(ends[0], ends[1]), torch.maximum(ends[0],
                                                              ends[1])
        key = (u * n + v)[u != v]
        key = key[~torch.isin(key, edges[:, 0] * n + edges[:, 1])]
        # Each new pair once, in the order it was drawn.
        uniq, inv = torch.unique(key, return_inverse=True)
        first = torch.full((uniq.shape[0],), key.shape[0],
                           device=key.device).scatter_reduce_(
            0, inv, torch.arange(key.shape[0], device=key.device), "amin")
        key = key[torch.sort(first).values][:want]
        inserts = torch.stack([key // n, key % n], 1).cpu().numpy()
    return UpdateStream(deletes, inserts, n_del, n_ins)
