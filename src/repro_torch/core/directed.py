"""Directed-graph BatchHL (paper §6, Table 6).

The port of `repro.core.directed`. Two labellings are kept:
  * forward  L_f[r, v] = δ(r → v), relaxed along the arcs,
  * backward L_b[r, v] = δ(v → r), relaxed along the reversed arcs,
with forward/backward highways H_f = H_bᵀ. A query (s, t) combines
    d⊤ = min_{i,j} L_b[i, s] + H_f[i, j] + L_f[j, t]
with a distance-bounded directed bidirectional search (forward from s,
backward from t) on G[V \\ R].

An arc a→b only creates or destroys paths through b on the forward
planes (through a on the backward ones), so the search's anchor is the
arc's head on each orientation; search and repair then run as in the
undirected case on that orientation. All R planes of an orientation run
together on the plane axis of each sweep (the reference vmaps one plane
per call), and the BiBFS runs all B queries of a batch as planes.

Storage: one padded arc table (src, dst, valid, w) holds each arc once;
the backward planes relax it with src and dst swapped (`rev()`). The two
orientations are two topologies to the tiler, so each takes its own
`RelaxPlan`, from its own `RelaxEngine`.

`apply_batch_directed` and `resolve_seed_weights_directed` match rows to
slots by one int64 key per arc, (src << 32) | dst, with `torch.isin` or a
batch sort and `searchsorted`, where the reference compares every slot
with every row ([cap, U]; XLA fuses that away, eager PyTorch would not:
4.3 GB of bools per compare at 4.2 M arcs × 1024 rows). The rules are the
reference's: `any` over every slot for deletions, the first matching row
for a re-weight, the max live weight for a seed weight (1 unmatched), and
-1 keys for masked rows. Inserts take the k-th free slot; past the free
slots they land on the last slot, as the reference's `nonzero(size=U,
fill_value=cap-1)` puts them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.batch import _per_plane_hub_mask, batch_repair
from repro_torch.core.construct import build_labelling
from repro_torch.core.engine import RelaxPlan, fixpoint, relax_sweep
from repro_torch.core.labelling import (HighwayLabelling, INF_KEY4,
                                        key4_beta, key4_extend,
                                        key4_from_key2)
from repro_torch.core.query import bounded_bibfs, effective_labels
from repro_torch.device import resolve_device
from repro_torch.graphs.coo import (INF_D, BatchUpdate, Graph, _first_match,
                                    resolve_seed_weights)
from repro_torch.kernels.seed_match import kernel as seed_match


@dataclasses.dataclass(frozen=True)
class DirectedGraph:
    src: torch.Tensor    # int32[cap] arc tails
    dst: torch.Tensor    # int32[cap] arc heads
    valid: torch.Tensor  # bool[cap]
    w: torch.Tensor      # int32[cap] arc weight; 0 on free slots
    n: int

    def fwd(self) -> Graph:
        return Graph(self.src, self.dst, self.valid, self.w, self.n)

    def rev(self) -> Graph:
        return Graph(self.dst, self.src, self.valid, self.w, self.n)


def from_arcs(n: int, arcs: np.ndarray, capacity: int, *,
              device: str | torch.device | None = None) -> DirectedGraph:
    """[m, 2] arcs (unit weight) or [m, 3] (tail, head, weight) rows in a
    table of `capacity` slots. `device=None` is the GPU."""
    device = resolve_device(device)
    arcs = np.asarray(arcs, np.int32)
    arcs = (arcs.reshape(-1, 2) if arcs.ndim < 2 or arcs.shape[1] == 2
            else arcs.reshape(-1, 3))
    m = arcs.shape[0]
    if m > capacity:
        raise ValueError(f"{m} arcs exceed capacity {capacity}")
    src = np.zeros(capacity, np.int32)
    dst = np.zeros(capacity, np.int32)
    valid = np.zeros(capacity, bool)
    w = np.zeros(capacity, np.int32)
    src[:m], dst[:m] = arcs[:, 0], arcs[:, 1]
    w[:m] = arcs[:, 2] if arcs.shape[1] == 3 else 1
    valid[:m] = True
    return DirectedGraph(*(torch.from_numpy(a).to(device)
                           for a in (src, dst, valid, w)), n)


def _arc_key(a: torch.Tensor, b: torch.Tensor,
             keep: torch.Tensor | None = None) -> torch.Tensor:
    """int64 key of the arc (a, b); (-1, -1) off `keep`."""
    return seed_match.slot_key(a, b, "arc", keep)


def apply_batch_directed(g: DirectedGraph, b: BatchUpdate) -> DirectedGraph:
    """Exact-arc deletion, in-place re-weight, free-slot insertion."""
    u = b.src.shape[0]
    cap = g.src.shape[0]
    if u == 0:
        return g
    slot_key = _arc_key(g.src, g.dst)
    hit = torch.isin(slot_key, _arc_key(b.src, b.dst, b.is_del & b.valid))
    valid = g.valid & ~hit
    w = torch.where(hit, 0, g.w)   # freed slots drop their weight

    rrow, rmatch = _first_match(_arc_key(b.src, b.dst, b.is_rew & b.valid),
                                slot_key)
    w = torch.where(rmatch & valid, b.w[rrow], w)

    ins_mask = (~b.is_del) & (~b.is_rew) & b.valid
    free = ~valid
    # The k-th free slot for k < U, filled with the last slot (the
    # reference's `nonzero(size=U, fill_value=cap - 1)`).
    free_rank = torch.cumsum(free, 0) - 1
    into = torch.where(free & (free_rank < u), free_rank, u)
    free_idx = torch.full((u + 1,), cap - 1, dtype=torch.int64,
                          device=g.src.device)
    free_idx.scatter_(0, into, torch.arange(cap, device=g.src.device))
    rank = torch.cumsum(ins_mask, 0) - 1
    # Non-insert rows write to scratch slot `cap`, cut away below (the
    # reference drops those writes).
    slot = torch.where(ins_mask, free_idx[rank.clamp(0, u - 1)], cap)

    def put(col: torch.Tensor, vals) -> torch.Tensor:
        ext = torch.cat([col, col.new_zeros(1)])
        ext[slot] = vals
        return ext[:cap]

    return DirectedGraph(put(g.src, b.src), put(g.dst, b.dst),
                         put(valid, True), put(w, b.w), g.n)


def resolve_seed_weights_directed(g_old: DirectedGraph,
                                  b: BatchUpdate) -> BatchUpdate:
    """Directed twin of `coo.resolve_seed_weights`, by exact arc: deletions
    seed at the arc's pre-update weight, re-weights at min(old, new),
    insertions at the batch's weight."""
    return resolve_seed_weights(g_old, b, directed=True)


@dataclasses.dataclass(frozen=True)
class DirectedLabelling:
    fwd: HighwayLabelling   # L_f, H_f (distances r → v)
    bwd: HighwayLabelling   # L_b, H_b (distances v → r)


def build_directed_labelling(g: DirectedGraph, landmarks: torch.Tensor,
                             plan_fwd: RelaxPlan | None = None,
                             plan_bwd: RelaxPlan | None = None
                             ) -> DirectedLabelling:
    """Both orientations' labellings: `plan_fwd` prepared on `g.fwd()`,
    `plan_bwd` on `g.rev()` (None runs the COO path)."""
    return DirectedLabelling(build_labelling(g.fwd(), landmarks,
                                             plan=plan_fwd),
                             build_labelling(g.rev(), landmarks,
                                             plan=plan_bwd))


def _directed_search(g_new: Graph, batch_src: torch.Tensor,
                     batch_dst: torch.Tensor, batch_e: torch.Tensor,
                     batch_valid: torch.Tensor, batch_w: torch.Tensor,
                     labelling: HighwayLabelling,
                     plan: RelaxPlan | None = None) -> torch.Tensor:
    """Improved batch search on one orientation, anchors at the arc heads;
    returns aff [R, V].

    `batch_e` is the key4 e-flag (deletions and re-weights, which can
    lengthen paths); `batch_w` the per-row seed weight
    (`resolve_seed_weights_directed`).
    """
    n = g_new.n
    dist_g = labelling.dist
    key2_g = labelling.key2()
    beta = key4_beta(key2_g)
    hub_mask = _per_plane_hub_mask(labelling, n)
    bs, bd = batch_src.to(torch.int64), batch_dst.to(torch.int64)

    da = dist_g[:, bs]                                       # [R, U] (pre)
    db = dist_g[:, bd]
    # Arc a→b can change paths only through b: skip a row that cannot
    # shorten, or was not possibly on, a shortest path at its seed weight.
    # da, w ≤ INF_D keep the sum in int32.
    nontrivial = ((da + batch_w[None, :] <= db) & (da < INF_D)
                  & batch_valid[None, :])
    k4 = key4_from_key2(key2_g[:, bs], batch_e[None, :])
    seed_k4 = key4_extend(k4, hub_mask[:, bd], w=batch_w[None, :])
    seed_k4 = torch.where(nontrivial, seed_k4, INF_KEY4)
    r = dist_g.shape[0]
    seed = torch.full((r, n), INF_KEY4, dtype=torch.int32,
                      device=dist_g.device)
    seed.scatter_reduce_(1, bd.expand(r, -1), seed_k4, "amin")

    def sweep(best: torch.Tensor) -> torch.Tensor:
        cand = relax_sweep(plan, g_new, best, 4, INF_KEY4, hub=hub_mask,
                           clear_bit=2)
        cand = torch.where(cand <= beta, cand, INF_KEY4)
        return torch.minimum(best, torch.minimum(cand, seed))

    best = fixpoint("directed_search", sweep, seed)
    return (seed < INF_KEY4) | (best < INF_KEY4)


def batchhl_update_directed(g: DirectedGraph, batch: BatchUpdate,
                            lab: DirectedLabelling,
                            plan_fwd: RelaxPlan | None = None,
                            plan_bwd: RelaxPlan | None = None,
                            g_new: DirectedGraph | None = None
                            ) -> tuple[DirectedGraph, DirectedLabelling,
                                       torch.Tensor]:
    """One directed BatchHL step: both orientations searched and repaired.

    Plans must be prepared from the post-update snapshot, `plan_fwd` on
    `apply_batch_directed(g, batch).fwd()` and `plan_bwd` on its `.rev()`;
    None runs the COO path. A caller that already built that snapshot (for
    the prepares) passes it as `g_new`.
    """
    g2 = apply_batch_directed(g, batch) if g_new is None else g_new
    seed_w = resolve_seed_weights_directed(g, batch).w
    e_flag = batch.is_del | batch.is_rew
    # forward planes: arcs as they are, anchor = head
    aff_f = _directed_search(g2.fwd(), batch.src, batch.dst, e_flag,
                             batch.valid, seed_w, lab.fwd, plan_fwd)
    new_f = batch_repair(g2.fwd(), aff_f, lab.fwd, plan_fwd)
    # backward planes: reversed arcs, anchor = tail
    aff_b = _directed_search(g2.rev(), batch.dst, batch.src, e_flag,
                             batch.valid, seed_w, lab.bwd, plan_bwd)
    new_b = batch_repair(g2.rev(), aff_b, lab.bwd, plan_bwd)
    return g2, DirectedLabelling(new_f, new_b), aff_f | aff_b


def directed_query(g: DirectedGraph, lab: DirectedLabelling,
                   s: torch.Tensor, t: torch.Tensor, max_steps: int = 64,
                   plan_fwd: RelaxPlan | None = None,
                   plan_bwd: RelaxPlan | None = None) -> torch.Tensor:
    """Exact directed distances d(s → t) for a batch of queries; INF_D
    where t is unreachable.

    The bound d⊤ is taken in PyTorch ops, as the reference takes it in
    jnp ([B, R, R] per batch). The BiBFS expands the s side along the arcs
    (`plan_fwd`) and the t side along the reversed arcs (`plan_bwd`),
    counted under `WAVES["directed_bibfs"]`.
    """
    s, t = s.to(torch.int64), t.to(torch.int64)
    lb = effective_labels(lab.bwd)                           # δ(· → r_i)
    lf = effective_labels(lab.fwd)                           # δ(r_j → ·)
    s_lab = lb[:, s].T.clamp_max(INF_D)                      # [B, R]
    t_lab = lf[:, t].T.clamp_max(INF_D)
    # Three terms ≤ INF_D = 2^28 sum below 2^31: int32 holds them.
    mid = (s_lab[:, :, None] + lab.fwd.highway[None, :, :]).amin(dim=1)
    d_top = (mid + t_lab).amin(dim=1).clamp_max(INF_D)
    best = bounded_bibfs(g.fwd(), lab.fwd.landmarks, s, t, d_top, max_steps,
                         plan_fwd, rev=g.rev(), plan_rev=plan_bwd,
                         kind="directed_bibfs")
    out = torch.minimum(best, d_top)
    return torch.where(out >= INF_D, INF_D, out)
