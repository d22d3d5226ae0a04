"""BatchHL: batch search (Algorithms 2 & 3) and batch repair (Algorithm 4).

The port of `repro.core.batch`. The paper's priority-queue searches are
monotone fixpoints of relaxation sweeps (DESIGN.md §2); all landmark
planes run together on the plane axis of each sweep, where the reference
vmaps one plane per sweep. Pass a `RelaxPlan` (from `RelaxEngine.prepare`
on the post-update snapshot) to run the tiled kernel; `plan=None` runs
the COO reference. Both give the same planes. A plan that carries
`FrontierTiles` runs search and repair in the frontier mode (below), with
the same planes again.

Variants (paper §7 naming):
  BHL   = basic batch search (Algo 2) + batch repair (Algo 4)
  BHL+  = improved batch search (Algo 3) + batch repair (Algo 4)
  BHLˢ  = BHL⁺ on the insertions, then on the deletions and re-weights
          (`batchhl_update_split`)
  UHL⁺  = BHL⁺ one update at a time (`uhl_update`)

With `trace.enable(True)` (`repro_torch/trace.py`) an update's stages run
under the spans `bhl.seed_weights` (`batchhl_update`'s seed weights),
`bhl.search`, `bhl.repair_base`, `bhl.edge_masks` (each
derivation of the [P, E2] edge masks), `bhl.repair` and `bhl.commit`, and
each frontier wave under `wave.<kind>`; the frontier mode's host reads
count at site "frontier".
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.core.engine import (MAX_WAVES, WAVES, RelaxEngine,
                                     RelaxPlan, fixpoint, gather_rows,
                                     relax_rows, relax_sweep)
from repro_torch.core.labelling import (
    HighwayLabelling, INF_KEY2, INF_KEY4, key2_dist, key2_hub, key2_make,
    key4_beta, key4_extend, key4_from_key2, per_plane_hub_mask,
)
from repro_torch.graphs.coo import (INF_D, BatchUpdate, Graph, apply_batch,
                                    resolve_seed_weights)


def check_labelling_width(g: Graph, dist: torch.Tensor) -> None:
    """The labelling planes must span exactly g.n vertices."""
    if dist.shape[1] != g.n:
        raise ValueError(
            f"labelling planes span {dist.shape[1]} vertices but the graph "
            f"has n={g.n}; grow them together before updating")


def _per_plane_hub_mask(labelling: HighwayLabelling, n: int) -> torch.Tensor:
    """[R, V] hub mask over the full plane set of a labelling."""
    return per_plane_hub_mask(labelling.landmarks, labelling.landmarks, n)


def _scatter_min_planes(anchor: torch.Tensor, vals: torch.Tensor, n: int,
                        fill: int) -> torch.Tensor:
    """Per plane, scatter-min `vals` [P, U] at `anchor` [P, U] into a
    `fill` plane [P, n]."""
    plane = torch.full((vals.shape[0], n), fill, dtype=torch.int32,
                       device=vals.device)
    return plane.scatter_reduce_(1, anchor.to(torch.int64), vals, "amin")


# ---------------------------------------------------------------------------
# Frontier-proportional waves (change propagation, DESIGN.md §10)
# ---------------------------------------------------------------------------
#
# Every fixpoint here is a monotone Bellman-Ford iteration, so a vertex can
# improve at wave k only through an edge whose source changed at wave k-1
# (the acceptance bounds do not change from wave to wave). Relaxing only
# the tile rows one block-hop ahead of the changed blocks is therefore
# exact: the masked wave gives the full sweep's planes bit for bit. When
# those rows number more than the plan's `rows_cap`, the wave is the full
# sweep instead, and the frontier is still tracked, so later sparse waves
# go back to masked. The reference gathers a static `rows_cap` rows padded
# with a sentinel; here a masked wave gathers exactly the active rows, and
# the choice between masked and full is the reference's `count <=
# rows_cap`.

def frontier_active_rows(plan: RelaxPlan, front: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(active-row flags [NR], count) one propagation hop ahead of the
    changed-block bitmap `front` [P, NBf]."""
    ft = plan.frontier
    rows = ft.active_rows(ft.propagate(front.any(0)))
    return rows, rows.sum()


def active_index(rows: torch.Tensor, count: int) -> torch.Tensor:
    """The indices of the `count` set flags of `rows`, ascending.

    `nonzero` would sync the host for its output size; the count is
    already on the host, so a stable sort of the flags gives the same
    indices without a second sync.
    """
    order = torch.sort(rows.to(torch.uint8), descending=True, stable=True)
    return order.indices[:count]


def frontier_probe(plan: RelaxPlan, front: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A frontier wave's device half before its host read: (active-row
    flags [NR], [live, count]), `live` whether `front` is not empty and
    `count` how many rows it activates."""
    rows, count = frontier_active_rows(plan, front)
    return rows, torch.stack([front.any().to(count.dtype), count])


def frontier_wave(kind: str, plan: RelaxPlan, g: Graph, full_step,
                  masked_step, x: torch.Tensor, front: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """One frontier wave: propagate, relax (masked or full), re-derive.

    `full_step(x)` is the whole-plane wave; `masked_step(x, rows_g)` the
    same wave over the gathered rows (`engine.gather_rows`). Returns (x',
    front', ran), front' marking the blocks whose values changed. One host
    read brings back both whether the frontier `front` is empty and how
    many rows it activates; an empty frontier runs nothing and returns
    (x, front, False), the no-op the reference's masked wave computes.
    (`FrontierTiles.propagate`, a boolean gather of the changed blocks'
    rows, syncs the host once more on the GPU.)
    """
    rows, flags = frontier_probe(plan, front)
    live, count = trace.host_read("frontier", flags)
    return frontier_apply(kind, plan, g, full_step, masked_step, x, front,
                          rows, live, count)


def frontier_apply(kind: str, plan: RelaxPlan, g: Graph, full_step,
                   masked_step, x: torch.Tensor, front: torch.Tensor,
                   rows: torch.Tensor, live: int, count: int
                   ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """`frontier_wave` after its host read of `frontier_probe`'s flags."""
    ft = plan.frontier
    if not live:
        return x, front, False
    with trace.span(trace.wave_span(kind)):
        WAVES[kind] += 1
        if count <= ft.rows_cap:
            WAVES[kind + ".masked"] += 1
            nx = masked_step(x, gather_rows(plan, g,
                                            active_index(rows, count)))
        else:
            nx = full_step(x)
        return nx, ft.changed_blocks(nx != x), True


def _frontier_fixpoint(kind: str, plan: RelaxPlan, g: Graph, full_step,
                       masked_step, init: torch.Tensor,
                       front0: torch.Tensor) -> torch.Tensor:
    """Iterate `frontier_wave` until the changed-block frontier empties:
    one host read per wave."""
    x, front = init, front0
    for _ in range(MAX_WAVES):
        x, front, ran = frontier_wave(kind, plan, g, full_step, masked_step,
                                      x, front)
        if not ran:
            break
    return x


def search_step_rows(rows_g, best: torch.Tensor, bound_g: torch.Tensor,
                     hub_mask: torch.Tensor | None, *,
                     improved: bool) -> torch.Tensor:
    """Masked twin of `search_{basic,improved}_step` over gathered rows.

    The full step's trailing `min(·, seed)` is dropped: the fixpoint
    starts at `best = seed` and only decreases, so the seed term changes
    nothing. The acceptance filter moves per slot, via
    `relax_rows(bound=...)`.
    """
    src_g, dstg, valid_g, w_g = rows_g
    if improved:
        return relax_rows(best, best, src_g, dstg, valid_g, w_g, 4,
                          INF_KEY4, hub=hub_mask, clear_bit=2, bound=bound_g)
    return relax_rows(best, best, src_g, dstg, valid_g, w_g, 1, INF_D,
                      bound=bound_g)


def repair_step_rows(rows_g, cur: torch.Tensor, aff: torch.Tensor,
                     hub_mask: torch.Tensor) -> torch.Tensor:
    """Masked twin of `repair_step`: interior relaxation over the rows."""
    src_g, dstg, valid_g, w_g = rows_g
    emask = valid_g & aff[:, src_g] & aff[:, dstg]            # [P, K, BE]
    return relax_rows(cur, cur, src_g, dstg, emask, w_g, 2, INF_KEY2,
                      hub=hub_mask, clear_bit=1)


def use_frontier(plan: RelaxPlan | None, g: Graph) -> bool:
    """The plan carries the frontier tiling and the graph has edge slots
    (a zero-capacity snapshot has nothing to gather)."""
    return (plan is not None and plan.frontier is not None
            and g.src.shape[0] > 0)


# ---------------------------------------------------------------------------
# Batch Search — Algorithm 2 (basic, returns CP-affected superset)
# ---------------------------------------------------------------------------
#
# Each search is a *seed* (scatter the batch's anchor keys into the
# planes) and a *step* (one relaxation wave over all planes); the search
# result is the step's fixpoint from the seed.

def search_basic_seed(g_new: Graph, batch: BatchUpdate, dist_g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algo-2 seeds for a plane slice: (seed keys [P, V], seeded [P, V])."""
    src, dst = batch.src.to(torch.int64), batch.dst.to(torch.int64)
    da = dist_g[:, src]                                       # [P, U]
    db = dist_g[:, dst]
    nontrivial = (da != db) & batch.valid[None, :]
    anchor = torch.where(da < db, dst[None, :], src[None, :])
    # The anchor's candidate distance crosses the update's edge at its
    # seed weight; d_pre ≤ INF_D and w ≤ INF_D keep the sum in int32.
    seed_d = (torch.minimum(da, db) + batch.w[None, :]).clamp_max(INF_D)
    seed_d = torch.where(nontrivial, seed_d, INF_D)
    seed = _scatter_min_planes(anchor, seed_d, g_new.n, INF_D)
    return seed, seed < INF_D           # anchors join V_AFF+ unconditionally


def search_basic_step(plan: RelaxPlan | None, g_new: Graph,
                      best: torch.Tensor, seed: torch.Tensor,
                      dist_g: torch.Tensor) -> torch.Tensor:
    """One Algo-2 relaxation wave over all planes of a slice [P, V]."""
    cand = relax_sweep(plan, g_new, best, 1, INF_D)
    cand = torch.where(cand <= dist_g, cand, INF_D)           # Algo2 line 12
    return torch.minimum(best, torch.minimum(cand, seed))


def search_basic_planes(g_new: Graph, batch: BatchUpdate,
                        dist_g: torch.Tensor,
                        plan: RelaxPlan | None = None) -> torch.Tensor:
    """Algo-2 search over a plane slice `dist_g` [P, V]; returns aff."""
    seed, seeded = search_basic_seed(g_new, batch, dist_g)

    def full(b):
        return search_basic_step(plan, g_new, b, seed, dist_g)
    if use_frontier(plan, g_new):
        best = _frontier_fixpoint(
            "search_basic", plan, g_new, full,
            lambda b, rows_g: search_step_rows(rows_g, b, dist_g, None,
                                               improved=False),
            seed, plan.frontier.changed_blocks(seeded))
    else:
        best = fixpoint("search_basic", full, seed)
    return seeded | (best < INF_D)


def batch_search_basic(g_old: Graph, g_new: Graph, batch: BatchUpdate,
                       labelling: HighwayLabelling,
                       plan: RelaxPlan | None = None) -> torch.Tensor:
    """Returns aff[R, V] bool — the CP-affected supersets, per landmark.
    Runs under the span `bhl.search`."""
    with trace.span("bhl.search"):
        return search_basic_planes(g_new, batch, labelling.dist, plan)


# ---------------------------------------------------------------------------
# Batch Search — Algorithm 3 (improved, extended landmark lengths)
# ---------------------------------------------------------------------------

def search_improved_seed(g_new: Graph, batch: BatchUpdate,
                         dist_g: torch.Tensor, hub_g: torch.Tensor,
                         hub_mask: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algo-3 seeds for a plane slice: (seed key4 [P, V], seeded, beta)."""
    key2_g = key2_make(dist_g, hub_g)                         # [P, V]
    beta = key4_beta(key2_g)

    src, dst = batch.src.to(torch.int64), batch.dst.to(torch.int64)
    da = dist_g[:, src]
    db = dist_g[:, dst]
    nontrivial = (da != db) & batch.valid[None, :]
    a_is_pre = da < db
    anchor = torch.where(a_is_pre, dst[None, :], src[None, :])
    pre = torch.where(a_is_pre, src[None, :], dst[None, :])

    key2_pre = key2_g.gather(1, pre)                          # [P, U]
    # Re-weights take the deletion-flavoured e-flag: like deletions they
    # can lengthen shortest paths, and e=True is the more inclusive key4.
    k4 = key4_from_key2(key2_pre, (batch.is_del | batch.is_rew)[None, :])
    anchor_is_hub = hub_mask.gather(1, anchor)
    seed_k4 = key4_extend(k4, anchor_is_hub, w=batch.w[None, :])
    seed_k4 = torch.where(nontrivial, seed_k4, INF_KEY4)
    seed = _scatter_min_planes(anchor, seed_k4, g_new.n, INF_KEY4)
    return seed, seed < INF_KEY4, beta


def search_improved_step(plan: RelaxPlan | None, g_new: Graph,
                         best: torch.Tensor, seed: torch.Tensor,
                         beta: torch.Tensor,
                         hub_mask: torch.Tensor) -> torch.Tensor:
    """One Algo-3 relaxation wave over all planes of a slice [P, V]."""
    cand = relax_sweep(plan, g_new, best, 4, INF_KEY4, hub=hub_mask,
                       clear_bit=2)
    cand = torch.where(cand <= beta, cand, INF_KEY4)          # Algo3 line 14
    return torch.minimum(best, torch.minimum(cand, seed))


def search_improved_planes(g_new: Graph, batch: BatchUpdate,
                           dist_g: torch.Tensor, hub_g: torch.Tensor,
                           hub_mask: torch.Tensor,
                           plan: RelaxPlan | None = None) -> torch.Tensor:
    """Algo-3 search over a plane slice (dist/hub/hub_mask [P, V])."""
    seed, seeded, beta = search_improved_seed(g_new, batch, dist_g, hub_g,
                                              hub_mask)

    def full(b):
        return search_improved_step(plan, g_new, b, seed, beta, hub_mask)
    if use_frontier(plan, g_new):
        best = _frontier_fixpoint(
            "search_improved", plan, g_new, full,
            lambda b, rows_g: search_step_rows(rows_g, b, beta, hub_mask,
                                               improved=True),
            seed, plan.frontier.changed_blocks(seeded))
    else:
        best = fixpoint("search_improved", full, seed)
    return seeded | (best < INF_KEY4)


def batch_search_improved(g_old: Graph, g_new: Graph, batch: BatchUpdate,
                          labelling: HighwayLabelling,
                          plan: RelaxPlan | None = None) -> torch.Tensor:
    """Returns aff[R, V] bool ⊇ LD-affected vertices, per landmark.
    Runs under the span `bhl.search`."""
    with trace.span("bhl.search"):
        hub_mask = _per_plane_hub_mask(labelling, g_new.n)
        return search_improved_planes(g_new, batch, labelling.dist,
                                      labelling.hub, hub_mask, plan)


# ---------------------------------------------------------------------------
# Batch Repair — Algorithm 4
# ---------------------------------------------------------------------------

def _edge_ends(g: Graph, aff: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per plane and slot: (source affected, destination affected)."""
    return aff[:, g.src.to(torch.int64)], aff[:, g.dst.to(torch.int64)]


def repair_base(plan: RelaxPlan | None, g_new: Graph, aff: torch.Tensor,
                key2_g: torch.Tensor, hub_mask: torch.Tensor) -> torch.Tensor:
    """Algo-4 boundary seeds: landmark-distance bounds from *unaffected*
    neighbours (line 3), INF_KEY2 off the affected sets. [P, V]."""
    with trace.span("bhl.edge_masks"):
        src_aff, dst_aff = _edge_ends(g_new, aff)
        bou_mask = g_new.valid & ~src_aff & dst_aff
    base = relax_sweep(plan, g_new, key2_g, 2, INF_KEY2, hub=hub_mask,
                       clear_bit=1, edge_mask=bou_mask)
    return torch.where(aff, base, INF_KEY2)


def repair_base_frontier(plan: RelaxPlan, g_new: Graph, aff: torch.Tensor,
                         key2_g: torch.Tensor, hub_mask: torch.Tensor
                         ) -> torch.Tensor:
    """Masked `repair_base`: one sweep over the affected sets' blocks.

    Boundary edges end on affected vertices, so the rows of the blocks
    that hold *any* plane's affected vertices cover every boundary edge
    of every plane, with no propagation hop. The full sweep runs instead
    when those rows outgrow the row budget.
    """
    rows, count = repair_base_rows(plan, aff)
    return repair_base_apply(plan, g_new, aff, key2_g, hub_mask, rows,
                             int(trace.host_read("frontier", count)))


def repair_base_rows(plan: RelaxPlan, aff: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`repair_base_frontier`'s device half before its host read: (the
    tile rows of the blocks holding affected vertices [NR], their
    count)."""
    ft = plan.frontier
    rows = ft.active_rows(ft.changed_blocks(aff.any(0)))
    return rows, rows.sum()


def repair_base_apply(plan: RelaxPlan, g_new: Graph, aff: torch.Tensor,
                      key2_g: torch.Tensor, hub_mask: torch.Tensor,
                      rows: torch.Tensor, count: int) -> torch.Tensor:
    """`repair_base_frontier` after its host read of the row count."""
    if count > plan.frontier.rows_cap:
        return repair_base(plan, g_new, aff, key2_g, hub_mask)
    WAVES["repair_base.masked"] += 1
    src_g, dstg, valid_g, w_g = gather_rows(plan, g_new,
                                            active_index(rows, count))
    emask = valid_g & ~aff[:, src_g] & aff[:, dstg]
    base = relax_rows(key2_g, torch.full_like(key2_g, INF_KEY2), src_g, dstg,
                      emask, w_g, 2, INF_KEY2, hub=hub_mask, clear_bit=1)
    return torch.where(aff, base, INF_KEY2)


def repair_step(plan: RelaxPlan | None, g_new: Graph, cur: torch.Tensor,
                aff: torch.Tensor, hub_mask: torch.Tensor,
                int_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One Algo-4 interior relaxation wave (lines 5-15) over a slice.

    `int_mask` [P, E2] (edges with both ends affected) is a function of
    aff alone; a fixpoint passes it in once instead of re-deriving it
    every wave.
    """
    if int_mask is None:
        with trace.span("bhl.edge_masks"):
            src_aff, dst_aff = _edge_ends(g_new, aff)
            int_mask = g_new.valid & src_aff & dst_aff
    cand = relax_sweep(plan, g_new, cur, 2, INF_KEY2, hub=hub_mask,
                       clear_bit=1, edge_mask=int_mask)
    return torch.minimum(cur, cand)


def repair_merge(aff: torch.Tensor, settled: torch.Tensor,
                 key2_g: torch.Tensor) -> torch.Tensor:
    """Rewrite only affected entries; unaffected labels are untouched."""
    return torch.where(aff, settled, key2_g)


def repair_settle(g_new: Graph, aff: torch.Tensor, key2_g: torch.Tensor,
                  hub_mask: torch.Tensor,
                  plan: RelaxPlan | None = None) -> torch.Tensor:
    """Algo-4 repair over a plane slice before its merge: the settled
    key2 [P, V] on the affected sets, INF_KEY2 off them.

    The paper's ascending-distance wavefront is a boundary-seeded
    relaxation fixpoint: identical final values by Lemma 5.20 and
    monotonicity. The boundary sweep runs under the span
    `bhl.repair_base`, the interior waves under `bhl.repair`.
    """
    frontier = use_frontier(plan, g_new)
    with trace.span("bhl.repair_base"):
        base = (repair_base_frontier if frontier else repair_base)(
            plan, g_new, aff, key2_g, hub_mask)
    WAVES["repair_base"] += 1
    with trace.span("bhl.edge_masks"):
        src_aff, dst_aff = _edge_ends(g_new, aff)
        int_mask = g_new.valid & src_aff & dst_aff
        del src_aff, dst_aff

    def full(c):
        return repair_step(plan, g_new, c, aff, hub_mask, int_mask)
    with trace.span("bhl.repair"):
        if frontier:
            return _frontier_fixpoint(
                "repair", plan, g_new, full,
                lambda c, rows_g: repair_step_rows(rows_g, c, aff, hub_mask),
                base, plan.frontier.changed_blocks(base < INF_KEY2))
        return fixpoint("repair", full, base)


def repair_planes(g_new: Graph, aff: torch.Tensor, key2_g: torch.Tensor,
                  hub_mask: torch.Tensor,
                  plan: RelaxPlan | None = None) -> torch.Tensor:
    """Algo-4 repair over a plane slice; returns new key2 [P, V]."""
    return repair_merge(aff, repair_settle(g_new, aff, key2_g, hub_mask,
                                           plan), key2_g)


def batch_repair(g_new: Graph, aff: torch.Tensor,
                 labelling: HighwayLabelling,
                 plan: RelaxPlan | None = None) -> HighwayLabelling:
    """Settle d^L_{G'} on the affected sets and rewrite labels minimally;
    the rewrite runs under the span `bhl.commit`."""
    hub_mask = _per_plane_hub_mask(labelling, g_new.n)
    key2_g = labelling.key2()
    settled = repair_settle(g_new, aff, key2_g, hub_mask, plan)
    with trace.span("bhl.commit"):
        new_key2 = repair_merge(aff, settled, key2_g)
        dist = key2_dist(new_key2).clamp_max(INF_D)
        hub = key2_hub(new_key2) & (dist < INF_D)
        highway = dist[:, labelling.landmarks.to(torch.int64)].contiguous()
        return HighwayLabelling(labelling.landmarks, dist, hub, highway)


# ---------------------------------------------------------------------------
# BatchHL — Algorithm 1
# ---------------------------------------------------------------------------

def batchhl_update(g_old: Graph, batch: BatchUpdate,
                   labelling: HighwayLabelling, improved: bool = True,
                   plan: RelaxPlan | None = None,
                   g_new: Graph | None = None
                   ) -> tuple[Graph, HighwayLabelling, torch.Tensor]:
    """One BatchHL step: apply B, search, repair. Returns (G', Γ', aff).

    `plan` must be prepared from the *post-update* snapshot G' so the
    tiling covers the edges the batch inserts; plan=None runs the COO
    reference. A caller that already built G' (typically for that
    prepare) passes it as `g_new`; it must equal apply_batch(g_old, batch).
    """
    check_labelling_width(g_old, labelling.dist)
    if g_new is None:
        g_new = apply_batch(g_old, batch)
    # Seeds for deletions / re-weights cross the edge at its pre-update
    # weight (resp. min of old/new), resolved against g_old.
    with trace.span("bhl.seed_weights"):
        batch = resolve_seed_weights(g_old, batch)
    search = batch_search_improved if improved else batch_search_basic
    aff = search(g_old, g_new, batch, labelling, plan)
    new_labelling = batch_repair(g_new, aff, labelling, plan)
    return g_new, new_labelling, aff


def batchhl_update_split(g_old: Graph, batch: BatchUpdate,
                         labelling: HighwayLabelling, improved: bool = True,
                         engine: RelaxEngine | None = None
                         ) -> tuple[Graph, HighwayLabelling, torch.Tensor]:
    """BHLˢ: insertions and deletions as two sequential sub-batches.

    Takes the `RelaxEngine` (not a plan): the tiling must cover the
    insertion-applied snapshot, and the deletion sub-batch reuses it
    unchanged. Re-weights ride the deletion sub-batch: like deletions they
    touch a live slot and never move topology. engine=None runs the COO
    reference.
    """
    ins = dataclasses.replace(
        batch, valid=batch.valid & ~batch.is_del & ~batch.is_rew)
    dele = dataclasses.replace(
        batch, valid=batch.valid & (batch.is_del | batch.is_rew))
    plan = g_ins = None
    if engine is not None:
        g_ins = apply_batch(g_old, ins)
        plan = engine.prepare(g_ins)
    g1, lab1, aff1 = batchhl_update(g_old, ins, labelling, improved, plan,
                                    g_new=g_ins)
    if engine is not None:
        # The deletion sub-batch only flips validity bits of the snapshot
        # just tiled, so the plan is reused without the fingerprint sync.
        plan = engine.prepare(g1, topology_changed=False, verify_cache=False)
    g2, lab2, aff2 = batchhl_update(g1, dele, lab1, improved, plan)
    return g2, lab2, aff1 | aff2


def uhl_update(g_old: Graph, batch: BatchUpdate,
               labelling: HighwayLabelling, improved: bool = True,
               engine: RelaxEngine | None = None
               ) -> tuple[Graph, HighwayLabelling, torch.Tensor]:
    """UHL⁺: the single-update baseline, one BatchHL call per update.

    With an engine it retiles only on insertions; deletions and re-weights
    reuse the cached tiling without the fingerprint sync. The op flags are
    read to the host once for the whole loop.
    """
    g, lab = g_old, labelling
    total_aff = torch.zeros_like(labelling.hub)
    is_del_h, is_rew_h, valid_h = torch.stack(
        [batch.is_del, batch.is_rew, batch.valid]).tolist() \
        if batch.src.numel() else ([], [], [])
    for i in range(batch.src.shape[0]):
        single = BatchUpdate(*(f[i:i + 1] for f in (
            batch.src, batch.dst, batch.is_del, batch.valid, batch.w,
            batch.is_rew)))
        plan = g_next = None
        if engine is not None:
            is_ins = valid_h[i] and not is_del_h[i] and not is_rew_h[i]
            g_next = apply_batch(g, single)
            plan = engine.prepare(g_next, topology_changed=is_ins,
                                  verify_cache=False)
        g, lab, aff = batchhl_update(g, single, lab, improved, plan,
                                     g_new=g_next)
        total_aff = total_aff | aff
    return g, lab, total_aff
