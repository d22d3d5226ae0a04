"""Versioned snapshots and the chunked-update serving pipeline.

The port of `repro.core.snapshot` (DESIGN.md §5). Two pieces keep queries
fast while the graph churns:

* **`Snapshot` / `SnapshotStore`**: an immutable serving unit (graph,
  labelling, prepared `RelaxPlan`, version) behind a single-writer,
  many-reader store. Queries run against the *committed* snapshot; an
  update builds snapshot N+1 beside it and `commit` swaps the pointer. No
  update, growth or chunk here writes into a tensor of a snapshot it was
  given, so queries already queued against snapshot N on the device stay
  exact across the swap (`tests/test_torch_snapshot.py` checks the
  `_version` of every such tensor).

* **`pipelined_update`**: the BatchHL update (batch search, then batch
  repair) as a generator of bounded device work: seed, then fixpoint
  sweeps in chunks of `chunk_sweeps` waves, then the repair likewise,
  then the merge. It yields after *dispatching* each chunk, and reads the
  chunk's `changed` flag only when resumed, so the caller can queue query
  microbatches behind at most one chunk on the device's one stream. A
  chunk of the full sweep syncs the host for nothing but that read; a
  chunk of the frontier mode also reads, once per wave, how many rows its
  frontier activates (the masked-or-full choice), and its wave syncs once
  more in `FrontierTiles.propagate`'s boolean gather. The chunks run the
  same seed and step functions as `core/batch.py`, and the fixpoints are
  monotone, so the committed labelling equals `batchhl_update`'s bit for
  bit.

`fused=True` runs each phase's seed and first `chunk_sweeps` waves as one
step of the generator, and later chunks of the full sweep lower the plane
in place. That plane is private to the update: the fused start returns a
fresh buffer, never the seed (in the unfused path the first chunk's
`best` *is* the seed, so it must stay out of place). Frontier chunks stay
out of place in both modes, since their changed-block map compares the
old plane with the new.

Checkpointing: `save_snapshot` / `restore_snapshot` persist the full
serve state (graph slots, labelling, version) in the reference's format;
the `RelaxPlan` is derived state, prepared again on restore. With
`mesh=`, `pipelined_update` runs the chunks' twins of `core/shard.py`
through the same driver: per-shard planes between chunks, one host read
of the merged `changed` flag per chunk.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import types
import warnings

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.batch import (WAVES, check_labelling_width,
                                    frontier_wave, repair_base,
                                    repair_base_frontier, repair_merge,
                                    repair_step, repair_step_rows,
                                    search_basic_seed, search_basic_step,
                                    search_improved_seed,
                                    search_improved_step, search_step_rows,
                                    use_frontier)
from repro_torch.core.engine import RelaxPlan, relax_sweep
from repro_torch.core.labelling import (HighwayLabelling, INF_KEY2, INF_KEY4,
                                        grow_labelling, key2_dist, key2_hub,
                                        key2_make, per_plane_hub_mask)
from repro_torch.device import resolve_device
from repro_torch.graphs.coo import (INF_D, BatchUpdate, Graph, apply_batch,
                                    grow, resolve_seed_weights)


class UnweightedCheckpointError(FileNotFoundError):
    """A checkpoint from before the weighted-metric format (no graph_w).

    Named so callers can tell "old format" from "no checkpoint": the
    weight column cannot be defaulted (w ≡ 1 would be a guess about the
    stream that produced the state).
    """


# ---------------------------------------------------------------------------
# Snapshot + store
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable serving unit: everything a query needs, versioned.

    `plan` is the `RelaxPlan` prepared for this graph (None on the COO
    path); it rides along so queries at version N keep N's tiling while
    the engine prepares N+1's.
    """
    version: int
    graph: Graph
    labelling: HighwayLabelling
    plan: RelaxPlan | None = None


class SnapshotStore:
    """Single-writer / many-reader versioned snapshot pointer.

    Reads (`committed`) are one attribute load. `commit` swaps the pointer
    and enforces contiguous versions, so "answered at version v" always
    means something.
    """

    def __init__(self, snapshot: Snapshot):
        self._committed = snapshot

    @property
    def committed(self) -> Snapshot:
        return self._committed

    @property
    def version(self) -> int:
        return self._committed.version

    def commit(self, snapshot: Snapshot) -> Snapshot:
        if snapshot.version != self._committed.version + 1:
            raise ValueError(
                f"commit of version {snapshot.version} onto "
                f"{self._committed.version}: versions must be contiguous")
        self._committed = snapshot
        return snapshot


def grow_snapshot(snap: Snapshot, *, capacity: int | None = None,
                  n: int | None = None) -> Snapshot:
    """The grown twin of `snap`: same version, same logical graph, larger
    slots (DESIGN.md §6).

    New vertex columns are what a fresh construction at the larger size
    gives an isolated vertex, so the version stays; the next update
    commits the grown shapes. `plan` is dropped: the engine retiles, since
    a grown snapshot's slot count or n differs from every cached plan's.
    """
    g = grow(snap.graph, capacity=capacity, n=n)
    return Snapshot(snap.version, g, grow_labelling(snap.labelling, g.n),
                    None)


# ---------------------------------------------------------------------------
# Bounded update chunks
# ---------------------------------------------------------------------------
#
# Each chunk returns its `changed` flag as a device tensor; only the
# driver below reads it, after the chunk was dispatched.

def _search_step(plan, g_new, best, seed, bound, hub_mask, improved):
    if improved:
        return search_improved_step(plan, g_new, best, seed, bound, hub_mask)
    return search_basic_step(plan, g_new, best, seed, bound)


def search_kind(improved: bool) -> str:
    return "search_improved" if improved else "search_basic"


def search_seed(g_new: Graph, batch: BatchUpdate, dist: torch.Tensor,
                hub: torch.Tensor, landmarks: torch.Tensor,
                improved: bool = True):
    """Batch-search initial state: (seed keys, seeded, bound, hub_mask).

    `bound` is the accept bound of the search step (β for the improved
    Algo 3, d_G for the basic Algo 2); `hub_mask` serves every later phase
    of the tick. `batch` carries seed weights (`resolve_seed_weights`).
    """
    check_labelling_width(g_new, dist)
    hub_mask = per_plane_hub_mask(landmarks, landmarks, g_new.n)
    if improved:
        seed, seeded, beta = search_improved_seed(g_new, batch, dist, hub,
                                                  hub_mask)
        return seed, seeded, beta, hub_mask
    seed, seeded = search_basic_seed(g_new, batch, dist)
    return seed, seeded, dist, hub_mask


def search_chunk(g_new: Graph, best: torch.Tensor, seed: torch.Tensor,
                 bound: torch.Tensor, hub_mask: torch.Tensor,
                 plan: RelaxPlan | None, improved: bool = True,
                 sweeps: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`sweeps` search waves → (best', changed). Out of place: `best` may
    be the seed."""
    cur = best
    for _ in range(sweeps):
        cur = _search_step(plan, g_new, cur, seed, bound, hub_mask, improved)
        WAVES[search_kind(improved)] += 1
    return cur, (cur != best).any()


def search_finish(best: torch.Tensor, seeded: torch.Tensor,
                  improved: bool = True) -> torch.Tensor:
    """Settled search keys → aff[P, V] (the CP/LD-affected supersets)."""
    return seeded | (best < (INF_KEY4 if improved else INF_D))


def interior_mask(g_new: Graph, aff: torch.Tensor) -> torch.Tensor:
    """Per plane and slot: a live edge with both ends affected [P, E2] —
    a function of aff alone, formed once per repair."""
    return (g_new.valid & aff[:, g_new.src.to(torch.int64)]
            & aff[:, g_new.dst.to(torch.int64)])


def repair_start(g_new: Graph, aff: torch.Tensor, dist: torch.Tensor,
                 hub: torch.Tensor, hub_mask: torch.Tensor,
                 plan: RelaxPlan | None) -> torch.Tensor:
    """Algo-4 boundary seeding (one wave)."""
    WAVES["repair_base"] += 1
    return repair_base(plan, g_new, aff, key2_make(dist, hub), hub_mask)


def repair_chunk(g_new: Graph, cur: torch.Tensor, aff: torch.Tensor,
                 hub_mask: torch.Tensor, plan: RelaxPlan | None,
                 sweeps: int = 1, int_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sweeps` interior repair waves → (cur', changed), out of place.
    `int_mask` is `interior_mask(g_new, aff)`, formed here if None."""
    if int_mask is None:
        int_mask = interior_mask(g_new, aff)
    out = cur
    for _ in range(sweeps):
        out = repair_step(plan, g_new, out, aff, hub_mask, int_mask)
        WAVES["repair"] += 1
    return out, (out != cur).any()


def update_finish(aff: torch.Tensor, settled: torch.Tensor,
                  dist: torch.Tensor, hub: torch.Tensor,
                  landmarks: torch.Tensor) -> HighwayLabelling:
    """Merge repaired keys into the labelling (dist/hub/highway)."""
    new_key2 = repair_merge(aff, settled, key2_make(dist, hub))
    ndist = key2_dist(new_key2).clamp_max(INF_D)
    nhub = key2_hub(new_key2) & (ndist < INF_D)
    highway = ndist[:, landmarks.to(torch.int64)].contiguous()
    return HighwayLabelling(landmarks, ndist, nhub, highway)


# --- fused chunks: seed and first waves in one step, later waves in place ---

def _lower_in_place(x: torch.Tensor, cand: torch.Tensor,
                    changed: torch.Tensor | None) -> torch.Tensor:
    """x ← min(x, cand) in place; returns `changed` or-ed with whether any
    entry fell. For a monotone fixpoint that is `x' != x`."""
    fell = (cand < x).any()
    torch.minimum(x, cand, out=x)
    return fell if changed is None else changed | fell


def _search_cand(plan, g_new, best, seed, bound, hub_mask, improved):
    """A search wave's candidate plane, before the min with `best`."""
    if improved:
        cand = relax_sweep(plan, g_new, best, 4, INF_KEY4, hub=hub_mask,
                           clear_bit=2)
        inf = INF_KEY4
    else:
        cand = relax_sweep(plan, g_new, best, 1, INF_D)
        inf = INF_D
    cand = torch.where(cand <= bound, cand, inf)
    return torch.minimum(cand, seed, out=cand)


def fused_search_chunk(g_new: Graph, best: torch.Tensor, seed: torch.Tensor,
                       bound: torch.Tensor, hub_mask: torch.Tensor,
                       plan: RelaxPlan | None, improved: bool = True,
                       sweeps: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`search_chunk` lowering `best` in place: `best` must be a plane no
    one else reads (the fused start's, never the seed). → (best, changed)."""
    changed = None
    for _ in range(sweeps):
        changed = _lower_in_place(best, _search_cand(
            plan, g_new, best, seed, bound, hub_mask, improved), changed)
        WAVES[search_kind(improved)] += 1
    return best, changed


def fused_search_start(g_new: Graph, batch: BatchUpdate, dist: torch.Tensor,
                       hub: torch.Tensor, landmarks: torch.Tensor,
                       plan: RelaxPlan | None, improved: bool = True,
                       sweeps: int = 1):
    """Seed + first `sweeps` search waves in one step →
    (best, seed, seeded, bound, hub_mask, changed); `best` is a fresh
    buffer, safe to lower in place."""
    seed, seeded, bound, hub_mask = search_seed(g_new, batch, dist, hub,
                                                landmarks, improved)
    best, changed = fused_search_chunk(g_new, seed.clone(), seed, bound,
                                       hub_mask, plan, improved, sweeps)
    return best, seed, seeded, bound, hub_mask, changed


def fused_repair_chunk(g_new: Graph, cur: torch.Tensor, aff: torch.Tensor,
                       hub_mask: torch.Tensor, plan: RelaxPlan | None,
                       sweeps: int = 1, int_mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """`repair_chunk` lowering `cur` in place → (cur, changed)."""
    if int_mask is None:
        int_mask = interior_mask(g_new, aff)
    changed = None
    for _ in range(sweeps):
        cand = relax_sweep(plan, g_new, cur, 2, INF_KEY2, hub=hub_mask,
                           clear_bit=1, edge_mask=int_mask)
        changed = _lower_in_place(cur, cand, changed)
        WAVES["repair"] += 1
    return cur, changed


def fused_repair_start_chunk(g_new: Graph, aff: torch.Tensor,
                             dist: torch.Tensor, hub: torch.Tensor,
                             hub_mask: torch.Tensor, plan: RelaxPlan | None,
                             sweeps: int = 1,
                             int_mask: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algo-4 boundary seeding + first `sweeps` interior waves in one step
    → (cur, changed); `cur` is repair_base's fresh plane."""
    cur = repair_start(g_new, aff, dist, hub, hub_mask, plan)
    return fused_repair_chunk(g_new, cur, aff, hub_mask, plan, sweeps,
                              int_mask)


# --- frontier chunks (change propagation, DESIGN.md §10) --------------------
#
# The masked-sweep twins of the chunks above, used when the plan carries
# `FrontierTiles`. Each threads the per-plane changed-block bitmap `front`
# [P, NBf] through the chunk as extra state; a chunk's `changed` is "the
# frontier is not empty". Fused or not, they build each plane out of place.

def search_wave_fns(plan, g_new, seed, bound, hub_mask, improved):
    """(full_step, masked_step) pair for one search wave (Algo 2/3)."""
    def full(b):
        return _search_step(plan, g_new, b, seed, bound, hub_mask, improved)

    def masked(b, rows_g):
        return search_step_rows(rows_g, b, bound,
                                hub_mask if improved else None,
                                improved=improved)
    return full, masked


def frontier_seed_blocks(plan: RelaxPlan, seeded: torch.Tensor
                         ) -> torch.Tensor:
    """Initial changed-block bitmap: wave 0 'changed' the seeded vertices."""
    return plan.frontier.changed_blocks(seeded)


def search_chunk_frontier(g_new: Graph, best: torch.Tensor,
                          front: torch.Tensor, seed: torch.Tensor,
                          bound: torch.Tensor, hub_mask: torch.Tensor,
                          plan: RelaxPlan, improved: bool = True,
                          sweeps: int = 1):
    """`search_chunk` with frontier waves → (best', front', changed)."""
    full, masked = search_wave_fns(plan, g_new, seed, bound, hub_mask,
                                   improved)
    for _ in range(sweeps):
        best, front, _ = frontier_wave(search_kind(improved), plan, g_new,
                                       full, masked, best, front)
    return best, front, front.any()


#: Out of place: nothing here donates a plane, so the reference's donating
#: variant is `search_chunk_frontier` itself.
fused_search_chunk_frontier = search_chunk_frontier


def repair_start_frontier(g_new: Graph, aff: torch.Tensor,
                          dist: torch.Tensor, hub: torch.Tensor,
                          hub_mask: torch.Tensor, plan: RelaxPlan):
    """`repair_start` masked to the affected blocks → (base, front)."""
    WAVES["repair_base"] += 1
    base = repair_base_frontier(plan, g_new, aff, key2_make(dist, hub),
                                hub_mask)
    return base, plan.frontier.changed_blocks(base < INF_KEY2)


def repair_chunk_frontier(g_new: Graph, cur: torch.Tensor,
                          front: torch.Tensor, aff: torch.Tensor,
                          hub_mask: torch.Tensor, plan: RelaxPlan,
                          sweeps: int = 1,
                          int_mask: torch.Tensor | None = None):
    """`repair_chunk` with frontier waves → (cur', front', changed)."""
    if int_mask is None:
        int_mask = interior_mask(g_new, aff)

    def full(c):
        return repair_step(plan, g_new, c, aff, hub_mask, int_mask)

    def masked(c, rows_g):
        return repair_step_rows(rows_g, c, aff, hub_mask)
    for _ in range(sweeps):
        cur, front, _ = frontier_wave("repair", plan, g_new, full, masked,
                                      cur, front)
    return cur, front, front.any()


#: Out of place: nothing here donates a plane, so the reference's donating
#: variant is `repair_chunk_frontier` itself.
fused_repair_chunk_frontier = repair_chunk_frontier


def fused_search_start_frontier(g_new: Graph, batch: BatchUpdate,
                                dist: torch.Tensor, hub: torch.Tensor,
                                landmarks: torch.Tensor, plan: RelaxPlan,
                                improved: bool = True, sweeps: int = 1):
    """`fused_search_start` with frontier waves →
    (best, front, seed, seeded, bound, hub_mask, changed)."""
    seed, seeded, bound, hub_mask = search_seed(g_new, batch, dist, hub,
                                                landmarks, improved)
    best, front, changed = search_chunk_frontier(
        g_new, seed, frontier_seed_blocks(plan, seeded), seed, bound,
        hub_mask, plan, improved, sweeps)
    return best, front, seed, seeded, bound, hub_mask, changed


def fused_repair_start_chunk_frontier(g_new: Graph, aff: torch.Tensor,
                                      dist: torch.Tensor, hub: torch.Tensor,
                                      hub_mask: torch.Tensor,
                                      plan: RelaxPlan, sweeps: int = 1,
                                      int_mask: torch.Tensor | None = None):
    """`fused_repair_start_chunk` with frontier waves →
    (cur, front, changed)."""
    cur, front = repair_start_frontier(g_new, aff, dist, hub, hub_mask, plan)
    return repair_chunk_frontier(g_new, cur, front, aff, hub_mask, plan,
                                 sweeps, int_mask)


# ---------------------------------------------------------------------------
# The pipelined update
# ---------------------------------------------------------------------------

def pipelined_update(snapshot: Snapshot, batch: BatchUpdate, *,
                     plan: RelaxPlan | None = None,
                     g_new: Graph | None = None, mesh=None,
                     improved: bool = True, chunk_sweeps: int = 1,
                     fused: bool = False):
    """BatchHL update against `snapshot` as a generator of bounded device
    work; returns (snapshot N+1, aff[R, V]) via StopIteration.

    Yields a phase tag ("search-seed", "search", "repair-seed", "repair")
    after dispatching each step, and reads the step's `changed` flag only
    after resuming: the caller serves query microbatches against the
    committed snapshot at every yield, and each queues behind at most one
    chunk (`chunk_sweeps` waves). As for `batchhl_update`, a `plan` must be
    prepared from the post-update graph; pass that graph as `g_new` to
    skip the recompute. `fused=True` runs the fused chunks (module doc).
    With a `mesh` (`launch/mesh.py`) the chunks run through their twins in
    `core/shard.py` on the maintenance plane grouping, and the labelling
    and aff of the result are gathered on the mesh's first device.

    Drive it with `run_pipelined_update`, or by hand:

        gen = pipelined_update(snap, batch, plan=plan)
        for _phase in gen:
            serve_pending_queries()      # interleaved work goes here
    """
    if chunk_sweeps < 1:
        raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
    return _pipelined(snapshot, batch, plan, g_new, improved, chunk_sweeps,
                      fused, _chunk_fns(mesh))


def _chunk_fns(mesh) -> types.SimpleNamespace:
    """The chunk functions `_pipelined` drives: this module's, or with a
    mesh their twins in `core/shard.py`, which keep per-shard plane
    lists between chunks and gather the labelling and aff at the end."""
    if mesh is None:
        return types.SimpleNamespace(
            seed=search_seed, fstart=fused_search_start, chunk=search_chunk,
            fchunk=fused_search_chunk, finish=search_finish,
            interior=interior_mask, rstart=repair_start,
            rchunk=repair_chunk, frstart=fused_repair_start_chunk,
            frchunk=fused_repair_chunk, seed_blocks=frontier_seed_blocks,
            f_fstart=fused_search_start_frontier,
            f_chunk=search_chunk_frontier, f_rstart=repair_start_frontier,
            f_rchunk=repair_chunk_frontier,
            f_frstart=fused_repair_start_chunk_frontier,
            update_finish=update_finish, gather=lambda aff: aff)
    from repro_torch.core import shard
    on = functools.partial
    return types.SimpleNamespace(
        seed=on(shard.shard_search_seed, mesh),
        fstart=on(shard.shard_fused_search_start, mesh),
        chunk=on(shard.shard_search_chunk, mesh),
        fchunk=on(shard.shard_fused_search_chunk, mesh),
        finish=on(shard.shard_search_finish, mesh),
        interior=on(shard.shard_interior_mask, mesh),
        rstart=on(shard.shard_repair_start, mesh),
        rchunk=on(shard.shard_repair_chunk, mesh),
        frstart=on(shard.shard_fused_repair_start_chunk, mesh),
        frchunk=on(shard.shard_fused_repair_chunk, mesh),
        seed_blocks=on(shard.shard_frontier_seed_blocks, mesh),
        f_fstart=on(shard.shard_fused_search_start_frontier, mesh),
        f_chunk=on(shard.shard_search_chunk_frontier, mesh),
        f_rstart=on(shard.shard_repair_start_frontier, mesh),
        f_rchunk=on(shard.shard_repair_chunk_frontier, mesh),
        f_frstart=on(shard.shard_fused_repair_start_chunk_frontier, mesh),
        update_finish=on(shard.shard_update_finish, mesh),
        gather=on(shard.gather_planes, mesh))


def _pipelined(snapshot, batch, plan, g_new, improved, sweeps, fused, fns):
    lab = snapshot.labelling
    if g_new is None:
        g_new = apply_batch(snapshot.graph, batch)
    # Seeds cross deletion/re-weight edges at their pre-update weight;
    # apply_batch above already took the post-update weights.
    batch = resolve_seed_weights(snapshot.graph, batch)
    args = (g_new, batch, lab.dist, lab.hub, lab.landmarks)
    # Each `bool(changed)` below is the one host read of a chunk's flag,
    # made after the chunk was dispatched and the caller resumed us.

    if use_frontier(plan, g_new):
        if fused:
            best, front, seed, seeded, bound, hub_mask, changed = \
                fns.f_fstart(*args, plan, improved, sweeps)
        else:
            seed, seeded, bound, hub_mask = fns.seed(*args, improved)
            best, front, changed = seed, fns.seed_blocks(plan, seeded), True
        yield "search-seed"
        while bool(changed):
            best, front, changed = fns.f_chunk(
                g_new, best, front, seed, bound, hub_mask, plan, improved,
                sweeps)
            yield "search"
        aff = fns.finish(best, seeded, improved)
        del best, seed, bound
        int_mask = fns.interior(g_new, aff)
        if fused:
            cur, front, changed = fns.f_frstart(
                g_new, aff, lab.dist, lab.hub, hub_mask, plan, sweeps,
                int_mask)
        else:
            cur, front = fns.f_rstart(g_new, aff, lab.dist, lab.hub,
                                      hub_mask, plan)
            changed = True
        yield "repair-seed"
        while bool(changed):
            cur, front, changed = fns.f_rchunk(
                g_new, cur, front, aff, hub_mask, plan, sweeps, int_mask)
            yield "repair"
    else:
        if fused:
            best, seed, seeded, bound, hub_mask, changed = \
                fns.fstart(*args, plan, improved, sweeps)
            chunk = fns.fchunk
        else:
            seed, seeded, bound, hub_mask = fns.seed(*args, improved)
            best, changed = seed, True
            chunk = fns.chunk
        yield "search-seed"
        while bool(changed):
            best, changed = chunk(g_new, best, seed, bound, hub_mask, plan,
                                  improved, sweeps)
            yield "search"
        aff = fns.finish(best, seeded, improved)
        del best, seed, bound
        int_mask = fns.interior(g_new, aff)
        if fused:
            cur, changed = fns.frstart(g_new, aff, lab.dist, lab.hub,
                                       hub_mask, plan, sweeps, int_mask)
            chunk = fns.frchunk
        else:
            cur = fns.rstart(g_new, aff, lab.dist, lab.hub, hub_mask, plan)
            changed = True
            chunk = fns.rchunk
        yield "repair-seed"
        while bool(changed):
            cur, changed = chunk(g_new, cur, aff, hub_mask, plan, sweeps,
                                 int_mask)
            yield "repair"

    new_lab = fns.update_finish(aff, cur, lab.dist, lab.hub, lab.landmarks)
    return Snapshot(snapshot.version + 1, g_new, new_lab, plan), \
        fns.gather(aff)


def run_pipelined_update(gen) -> tuple[Snapshot, torch.Tensor]:
    """Drain a `pipelined_update` with no interleaved work."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


# ---------------------------------------------------------------------------
# Full-state checkpointing (graph + labelling + version)
# ---------------------------------------------------------------------------

_CORE_LEAVES = ("graph_src", "graph_dst", "graph_valid", "graph_w", "n",
                "landmarks", "dist", "hub", "highway", "version")


def snapshot_state(snap: Snapshot) -> dict:
    """The restartable serve state as a flat checkpoint tree: the graph's
    slots, the labelling and the version (the plan is derived state)."""
    g, lab = snap.graph, snap.labelling
    return {
        "version": np.int64(snap.version),
        "n": np.int64(g.n),
        "graph_src": g.src, "graph_dst": g.dst, "graph_valid": g.valid,
        "graph_w": g.w,
        "landmarks": lab.landmarks, "dist": lab.dist, "hub": lab.hub,
        "highway": lab.highway,
    }


def save_snapshot(ckpt_dir: str, snap: Snapshot,
                  extra: dict | None = None) -> str:
    """Atomically persist the full serve state as step_<version>.

    `extra` adds caller-owned host state to the same checkpoint (the
    serve loop's edge list: deletion sampling depends on its order).
    """
    state = snapshot_state(snap)
    for k, v in (extra or {}).items():
        if k in state:
            raise ValueError(f"extra key {k!r} collides with snapshot state")
        state[k] = v
    return ckpt.save(ckpt_dir, snap.version, state)


def restore_extra(ckpt_dir: str, names: tuple[str, ...],
                  step: int | None = None) -> dict:
    """Load caller-owned `extra` leaves saved alongside a snapshot."""
    step = step if step is not None else ckpt.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return ckpt.load_leaves(ckpt_dir, step, names)


def publish_snapshot(ckpt_dir: str, snap: Snapshot,
                     extra: dict | None = None) -> str:
    """`save_snapshot`, then flip the CURRENT pointer to it, durably."""
    path = save_snapshot(ckpt_dir, snap, extra=extra)
    ckpt.publish(ckpt_dir, snap.version)
    return path


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.memmap):
        # A read-only mapping: the tensor views the file's pages (the
        # snapshot's tensors are never written), or is copied off them.
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*not writable.*")
            return torch.from_numpy(a).to(device)
    return torch.from_numpy(a).to(device)


def restore_snapshot(ckpt_dir: str, step: int | None = None,
                     mmap: bool = False,
                     device: str | torch.device | None = None) -> Snapshot:
    """Rebuild a `Snapshot` from the newest (or given) checkpoint onto
    `device` (None: the GPU, raising without one).

    Self-describing: shapes and n come from the checkpoint. The snapshot
    has `plan=None`; prepare one with the serving engine. `mmap=True` maps
    the arrays on the host instead of reading them (on the CPU the tensors
    then view the file's pages).
    """
    device = resolve_device(device)
    step = step if step is not None else ckpt.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt.step_dir(ckpt_dir, step)
    try:
        leaves = ckpt.load_leaves(ckpt_dir, step, _CORE_LEAVES, mmap=mmap)
    except FileNotFoundError as e:
        missing = [k for k in ("graph_src", "graph_dst", "graph_valid")
                   if not os.path.exists(os.path.join(d, k + ".npy"))]
        if missing:
            raise FileNotFoundError(
                f"checkpoint {d} lacks graph state {missing}: it predates "
                "the full-state format and cannot resume a serve loop") \
                from e
        if not os.path.exists(os.path.join(d, "graph_w.npy")):
            raise UnweightedCheckpointError(
                f"checkpoint {d} lacks the edge-weight column graph_w: it "
                "predates the weighted-metric format. Re-serve from the "
                "original stream (or re-save the snapshot) to migrate; the "
                "weight column cannot be reconstructed from topology "
                "alone.") from e
        raise

    t = {k: _tensor(leaves[k], device) for k in _CORE_LEAVES
         if k not in ("n", "version")}
    g = Graph(t["graph_src"], t["graph_dst"], t["graph_valid"], t["graph_w"],
              int(leaves["n"]))
    lab = HighwayLabelling(t["landmarks"], t["dist"], t["hub"], t["highway"])
    return Snapshot(int(leaves["version"]), g, lab, None)
