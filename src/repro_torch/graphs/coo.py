"""Padded COO graph structures for batch-dynamic graphs, in PyTorch.

The port of `repro.graphs.coo`. Shapes are static: a graph owns a fixed
edge *capacity*; edges live in slots with a validity mask. Undirected
edges are stored as both directions in adjacent slot pairs (slot 2k holds
u->v, slot 2k+1 holds v->u). Every slot carries an int32 weight in
`Graph.w` (real edges in [1, INF_D], free slots 0); `w ≡ 1` is the
unweighted metric. A batch holds inserts, deletes and re-weights.

The batch matching is written for one GPU at the main path's size: the
reference compares every slot with every batch row ([E2, U], which XLA
fuses away), but eager PyTorch would materialise those compares (17 GB
at 2^24 slots × 1024 rows). Here each slot and each batch row gets one
canonical int64 key of its (min, max) endpoints, and the matches are a
`torch.isin` or a sort of the batch plus a `searchsorted` of the slots —
with the same answers: `any` for deletions over every slot, the *first*
matching row for re-weights, the *max* live weight for seed weights, and
(-1, -1) as the key of a masked row; the seed weights' slot match is one
pass over the slots (`kernels/seed_match`, a CUDA kernel on the card).
Inserts go to the same first-free slot pairs as the reference, and writes
that the reference drops (`mode="drop"`) land on a scratch slot past the
end that is cut away.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.kernels.seed_match import ops as seed_match
from repro_torch.kernels.seed_match.kernel import slot_key

# Large-but-safe int32 infinity for distances (headroom for +w relaxations).
INF_D = 1 << 28

# Batch-update op codes (make_batch third tuple element; a bool is_del from
# the legacy 3-tuple format maps onto OP_INS/OP_DEL unchanged).
OP_INS, OP_DEL, OP_REW = 0, 1, 2


class CapacityError(ValueError):
    """A graph's static slots cannot hold the requested edges/vertices.

    Carries the numbers a caller needs to grow (or to size a fresh build):
    the tick that overflowed (None outside a serve stream), the current
    and required edge capacities (slot pairs), and the current and
    required vertex counts.
    """

    def __init__(self, message: str, *, tick: int | None = None,
                 capacity: int | None = None,
                 required_capacity: int | None = None,
                 n: int | None = None, required_n: int | None = None):
        super().__init__(message)
        self.tick = tick
        self.capacity = capacity
        self.required_capacity = required_capacity
        self.n = n
        self.required_n = required_n


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded undirected graph in COO form (both directions stored)."""
    src: torch.Tensor    # int32[2*cap]
    dst: torch.Tensor    # int32[2*cap]
    valid: torch.Tensor  # bool[2*cap]
    w: torch.Tensor      # int32[2*cap] edge weight; 0 on free/padding slots
    n: int               # vertex count

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def capacity(self) -> int:
        return self.src.shape[0] // 2

    def num_edges(self) -> torch.Tensor:
        """Live undirected edges: live slots // 2, a 0-d int64 tensor."""
        return self.valid.sum() // 2


@dataclasses.dataclass(frozen=True)
class BatchUpdate:
    """A padded batch of edge updates (insert / delete / re-weight)."""
    src: torch.Tensor     # int32[U]
    dst: torch.Tensor     # int32[U]
    is_del: torch.Tensor  # bool[U]
    valid: torch.Tensor   # bool[U]  (padding mask)
    w: torch.Tensor       # int32[U] weight (insert: new edge's; rew: new value)
    is_rew: torch.Tensor  # bool[U]  re-weight op (neither insert nor delete)


def from_edges(n: int, edges: np.ndarray, capacity: int, *,
               device: str | torch.device | None = None) -> Graph:
    """Build a padded Graph from a numpy edge array (undirected).

    `edges` is [m, 2] (unit weights) or [m, 3] with an int weight column.
    `device=None` is the GPU (see `repro_torch.device`).
    """
    device = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int32)
    edges = edges.reshape(-1, 2) if (edges.ndim < 2 or edges.shape[1] == 2) \
        else edges.reshape(-1, 3)
    m = edges.shape[0]
    if m > capacity:
        raise CapacityError(f"{m} edges exceed capacity {capacity}",
                            capacity=capacity, required_capacity=m, n=n)
    src = np.zeros(2 * capacity, np.int32)
    dst = np.zeros(2 * capacity, np.int32)
    valid = np.zeros(2 * capacity, bool)
    w = np.zeros(2 * capacity, np.int32)
    src[0:2 * m:2], dst[0:2 * m:2] = edges[:, 0], edges[:, 1]
    src[1:2 * m:2], dst[1:2 * m:2] = edges[:, 1], edges[:, 0]
    ew = edges[:, 2] if edges.shape[1] == 3 else np.ones(m, np.int32)
    w[0:2 * m:2] = ew
    w[1:2 * m:2] = ew
    valid[:2 * m] = True
    return Graph(*(torch.from_numpy(a).to(device) for a in (src, dst, valid, w)),
                 n)


def grow(g: Graph, *, capacity: int | None = None,
         n: int | None = None) -> Graph:
    """Return `g` with larger static slots: the same edge set, more room.

    New edge slots are free (valid False, src/dst/w zeroed, as
    `from_edges` pads), and a larger `n` only widens the vertex id space;
    no existing slot moves. Shrinking is refused: slots past the new
    capacity could hold live edges, and vertex ids past the new n could be
    referenced by them. The result shares no storage with `g` once the
    capacity grows, so `g`'s tensors are never written.
    """
    capacity = g.capacity if capacity is None else capacity
    n = g.n if n is None else n
    if capacity < g.capacity or n < g.n:
        raise ValueError(
            f"grow cannot shrink: capacity {g.capacity}->{capacity}, "
            f"n {g.n}->{n}")
    pad = 2 * (capacity - g.capacity)
    if pad == 0:
        return Graph(g.src, g.dst, g.valid, g.w, n)
    return Graph(*(torch.cat([col, col.new_zeros(pad)])
                   for col in (g.src, g.dst, g.valid, g.w)), n)


def batch_requirements(g: Graph, b: BatchUpdate) -> tuple[int, int]:
    """(required_capacity, required_n) to apply `b` to `g`, on the host.

    `required_capacity` is exact for `apply_batch`'s semantics: occupied
    slot pairs, minus the pairs the batch's own deletions free (deletions
    are applied before insertions, with `apply_batch`'s canonical-key
    match), plus the batch's valid insertions; re-weights take no slot.
    `required_n` is one past the largest vertex id a valid row touches
    (0 for a batch with no valid row). The counts are formed on the device
    and read in one host sync (site "batch_requirements").
    """
    valid = b.valid
    n_ins = ((~b.is_del) & (~b.is_rew) & valid).sum()
    hit = torch.isin(_canon_key(g.src, g.dst),
                     _canon_key(b.src, b.dst, b.is_del & valid)) & g.valid
    top = torch.where(valid, torch.maximum(b.src, b.dst), -1)
    top = top.max() if top.numel() else top.new_tensor(-1)
    occupied, freed, n_ins, top = trace.host_read(
        "batch_requirements",
        torch.stack([g.valid.sum(), hit.sum(), n_ins, top.to(torch.int64)]))
    return occupied // 2 - freed // 2 + n_ins, top + 1


def make_batch(updates, pad_to: int | None = None, *,
               device: str | torch.device | None = None) -> BatchUpdate:
    """updates: iterable of (u, v, op) or (u, v, op, weight).

    `op` is OP_INS/OP_DEL/OP_REW (a bool is_del from the legacy 3-tuple
    format coerces to OP_DEL/OP_INS). `weight` defaults to 1; it is the
    inserted edge's weight for OP_INS and the new value for OP_REW
    (ignored for OP_DEL). Pads to `pad_to` slots.
    """
    device = resolve_device(device)
    ups = list(updates)
    size = pad_to or max(len(ups), 1)
    src = np.zeros(size, np.int32)
    dst = np.zeros(size, np.int32)
    is_del = np.zeros(size, bool)
    valid = np.zeros(size, bool)
    w = np.ones(size, np.int32)
    is_rew = np.zeros(size, bool)
    for i, up in enumerate(ups):
        a, b, op = up[0], up[1], int(up[2])
        src[i], dst[i], valid[i] = a, b, True
        is_del[i] = op == OP_DEL
        is_rew[i] = op == OP_REW
        if len(up) > 3:
            w[i] = int(up[3])
    return BatchUpdate(*(torch.from_numpy(a).to(device)
                         for a in (src, dst, is_del, valid, w, is_rew)))


def _canon_key(a: torch.Tensor, b: torch.Tensor,
               keep: torch.Tensor | None = None) -> torch.Tensor:
    """int64 key of the undirected pair (min, max); (-1, -1) off `keep`."""
    return slot_key(a, b, "pair", keep)


def _first_match(row_keys: torch.Tensor, slot_keys: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """For each slot key: (the first batch row with that key, matched?).

    A stable sort keeps equal keys in row order, so the left
    `searchsorted` position is the lowest matching row — `argmax` over
    the reference's [E2, U] compare.
    """
    sorted_k, order = torch.sort(row_keys, stable=True)
    pos = torch.searchsorted(sorted_k, slot_keys).clamp_max(
        row_keys.shape[0] - 1)
    return order[pos], sorted_k[pos] == slot_keys


def apply_batch(g: Graph, b: BatchUpdate) -> Graph:
    """Apply a batch update, returning G'.

    Deletions: clear validity of matching slots (both directions).
    Re-weights: set the weight of matching live slots in place (a
    re-weight of a non-edge is a no-op, like an unmatched deletion).
    Insertions: write both directions (src/dst/weight) into the first
    free slot pair. Invalid (padded) updates are ignored.
    """
    u_slots = b.src.shape[0]
    e2 = g.src.shape[0]
    if u_slots == 0:
        return g
    g_key = _canon_key(g.src, g.dst)

    # --- deletions: any matching row, over every slot ------------------
    hit = torch.isin(g_key, _canon_key(b.src, b.dst, b.is_del & b.valid))
    valid = g.valid & ~hit
    # Freed slots drop their weight with their validity, so a graph's slot
    # arrays are a pure function of its update history.
    w = torch.where(hit, 0, g.w)

    # --- re-weights: the first matching row, gated on post-delete validity
    rrow, rmatch = _first_match(
        _canon_key(b.src, b.dst, b.is_rew & b.valid), g_key)
    w = torch.where(rmatch & valid, b.w[rrow], w)

    # --- insertions ------------------------------------------------------
    ins_mask = (~b.is_del) & (~b.is_rew) & b.valid
    pair_free = ~(valid[0::2] | valid[1::2])
    n_pairs = pair_free.shape[0]
    ins_rank = torch.cumsum(ins_mask, 0) - 1
    # The k-th free pair for k < U, filled with the last pair index
    # (the reference's `nonzero(size=U, fill_value=n_pairs - 1)`).
    free_rank = torch.cumsum(pair_free, 0) - 1
    into = torch.where(pair_free & (free_rank < u_slots), free_rank, u_slots)
    free_pair_idx = torch.full((u_slots + 1,), n_pairs - 1, dtype=torch.int64,
                               device=g.device)
    free_pair_idx.scatter_(0, into, torch.arange(n_pairs, device=g.device))
    pair_for_ins = free_pair_idx[ins_rank.clamp(0, u_slots - 1)]
    # Non-insert rows write to scratch slot e2, cut away below: the
    # reference drops those writes, and must never land on slot 0.
    even = torch.where(ins_mask, 2 * pair_for_ins, e2)
    odd = torch.where(ins_mask, 2 * pair_for_ins + 1, e2)

    def put(col: torch.Tensor, at_even, at_odd) -> torch.Tensor:
        ext = torch.cat([col, col.new_zeros(1)])
        ext[even] = at_even
        ext[odd] = at_odd
        return ext[:e2]

    return Graph(put(g.src, b.src, b.dst), put(g.dst, b.dst, b.src),
                 put(valid, True, True), put(w, b.w, b.w), g.n)


def resolve_seed_weights(g_old: Graph, b: BatchUpdate, *,
                         directed: bool = False) -> BatchUpdate:
    """Replace `b.w` with the *seed* weight of each row against G (pre-update).

    Insert: the new edge's weight; delete: the removed edge's weight in G;
    re-weight: min(old, new). The old weight is the max over the live
    slots that match the row, and 1 when none does (unmatched rows are
    no-ops in `apply_batch` anyway). Padding rows get 1.

    A row matches a slot by the canonical undirected pair; `directed`
    matches by the exact arc instead (`core/directed.py`). The slot side is
    one pass over the slots (`kernels/seed_match`).
    """
    u_slots = b.src.shape[0]
    if u_slots == 0:
        return b
    key = "arc" if directed else "pair"
    need_old = (b.is_del | b.is_rew) & b.valid
    w_old = seed_match.max_live_weight(
        g_old.src, g_old.dst, g_old.valid, g_old.w,
        slot_key(b.src, b.dst, key, need_old), key)
    w_old = torch.where(w_old == 0, 1, w_old)
    w_eff = torch.where(b.is_del, w_old,
                        torch.where(b.is_rew, torch.minimum(w_old, b.w), b.w))
    return dataclasses.replace(
        b, w=torch.where(b.valid, w_eff, 1).to(torch.int32))


def to_numpy_adj(g: Graph) -> dict[int, set[int]]:
    """Adjacency dict for the oracle / tests (host only)."""
    src, dst, valid = (t.cpu().numpy() for t in (g.src, g.dst, g.valid))
    adj: dict[int, set[int]] = {v: set() for v in range(g.n)}
    for s, d, ok in zip(src, dst, valid):
        if ok:
            adj[int(s)].add(int(d))
    return adj


def to_numpy_wadj(g: Graph) -> dict[int, dict[int, int]]:
    """Weighted adjacency dict {u: {v: w}} for the Dijkstra oracle (host).

    Parallel slots for the same arc keep the minimum weight.
    """
    src, dst, valid, w = (t.cpu().numpy()
                          for t in (g.src, g.dst, g.valid, g.w))
    adj: dict[int, dict[int, int]] = {v: {} for v in range(g.n)}
    for s, d, ok, wi in zip(src, dst, valid, w):
        if ok:
            row = adj[int(s)]
            d = int(d)
            row[d] = min(row[d], int(wi)) if d in row else int(wi)
    return adj
