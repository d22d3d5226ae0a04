"""Mesh-sharded BatchHL: construction, batch update and queries on a
`(data, model)` device mesh (DESIGN.md §4).

The port of `repro.core.shard`. The paper's §6 parallelism is landmark
planes: every search, repair and construction fixpoint is independent
per plane. The reference lifts its per-plane functions onto a mesh with
`shard_map`, SPMD under one controller; here this process is that
controller. It holds the mesh (`launch/mesh.py`: a grid of
`torch.device`s, repeats allowed), runs a per-shard body on each grid
cell with that shard's slice of the planes, and runs the collectives as
explicit functions over the per-shard tensors:

* **Maintenance** (`shard_build_labelling`, `shard_batchhl_update`, the
  pipelined chunk twins): landmark planes are split over the whole grid,
  `MAINT_AXES = ("model", "data")`, model-major: the shard at grid (d, m)
  holds plane block m·data + d. Each shard runs the port's plane-slice
  functions (`construct_key2_planes`, `search_*`, `repair_*`, the
  snapshot chunks) on its own planes (`own`) with the full landmark set,
  the graph, the batch and the `RelaxPlan` replicated: `.to()` its device,
  which costs nothing where the device is the graph's.

* **Queries** (`shard_batched_query`): planes over `model`, the query
  batch over `data`. Each (d, m) shard forms its effective labels and its
  queries' label rows; the target rows are all-gathered over `model`; the
  partial bound runs kernel B (`minplus`) on the shard's [P, R] highway
  rows (the plain contraction on the CPU only), and a `pmin` over `model`
  finishes Eq. 3. The bounded BiBFS (kernel A through the plan) runs once
  per data shard on its padded sub-batch, so its batch-wide side choice
  is made over that sub-batch, as in the reference.

* **Cross-plane reductions**: `affected_vertices` OR-merges the per-plane
  affected sets (`pmax`); each chunk's `changed` flags are stacked on the
  mesh's first device and read by the caller once, as the unsharded
  chunk's one flag is. The frontier twins run their waves in lock step
  over the shards, each against its own local frontier (the masked/full
  branch is taken per shard), with one host read of every shard's
  frontier flags per wave.

Bit-parity: per-plane values are exact int32 fixpoints, independent of
the iteration count, and min/OR reductions are associative, so every
output equals the unsharded path's on any mesh (`tests/test_torch_shard
.py` and `tests/test_torch_shard_pipeline.py` pin it on every
factorisation of an 8-shard CPU mesh).

Placement: the reference's outputs stay sharded on the mesh. Here
`shard_build_labelling`, `shard_batchhl_update` and `shard_update_finish`
return an ordinary `HighwayLabelling` (and `aff`) gathered on the mesh's
first device, one `torch.cat` per field, so snapshots, checkpoints,
growth and the readers work unchanged. The chunk twins take and return
per-shard lists, so between chunks a shard's planes stay on its device.
Several shards on one device run one after another on its one stream.

R must divide over the plane groupings (data × model for maintenance,
model for queries); query batches are padded to a multiple of `data`.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.batch import (check_labelling_width, frontier_apply,
                                    frontier_probe, repair_base_apply,
                                    repair_base_rows, repair_planes,
                                    repair_step, repair_step_rows,
                                    search_basic_planes, search_basic_seed,
                                    search_improved_planes,
                                    search_improved_seed)
from repro_torch.core.construct import construct_key2_planes
from repro_torch.core.engine import WAVES, RelaxPlan
from repro_torch.core.labelling import (HighwayLabelling, INF_KEY2,
                                        key2_dist, key2_hub, key2_make,
                                        per_plane_hub_mask)
from repro_torch.core.query import bounded_bibfs, effective_label_planes
from repro_torch.core.snapshot import (frontier_seed_blocks,
                                       fused_repair_chunk, fused_search_chunk,
                                       interior_mask, repair_chunk,
                                       repair_start, search_chunk,
                                       search_finish, search_kind,
                                       search_wave_fns, update_finish)
from repro_torch.graphs.coo import (INF_D, BatchUpdate, Graph, apply_batch,
                                    resolve_seed_weights)
from repro_torch.kernels.minplus import ops as minplus_ops

#: Plane-sharding axes during maintenance: landmark planes over the whole
#: grid (`model` major, `data` minor; the data axis is idle while the
#: labelling is rewritten, so it adds landmark parallelism).
MAINT_AXES = ("model", "data")


def _check_planes(r: int, size: int, what: str) -> None:
    if r % size:
        raise ValueError(
            f"landmark count {r} must be divisible by the {what} "
            f"sharding size {size}; pick R as a multiple (or a smaller "
            f"--shards / mesh)")


def _maint_size(mesh) -> int:
    return mesh.shape["model"] * mesh.shape["data"]


def validate_landmark_sharding(mesh, r: int) -> None:
    """Pre-flight check of R against *both* plane groupings of a mesh.

    Maintenance shards landmark planes over data·model (the idle data
    axis donates its parallelism); queries regroup them over model only.
    Each failing grouping is named, so a caller knows which phase's
    regrouping broke.
    """
    data, model = mesh.shape["data"], mesh.shape["model"]
    failing = []
    if r % (data * model):
        failing.append(f"maintenance grouping data×model = "
                       f"{data}×{model} = {data * model}")
    if r % model:
        failing.append(f"query grouping model = {model}")
    if failing:
        raise ValueError(
            f"landmark count R={r} must be divisible by every plane "
            f"grouping of the mesh; failing: {'; '.join(failing)} — pick "
            f"R as a multiple, or a smaller mesh / --shards")


# ---------------------------------------------------------------------------
# Placement and collectives over per-shard tensors
# ---------------------------------------------------------------------------

def maint_devices(mesh) -> list[torch.device]:
    """The device of each maintenance plane block, in block order: block
    k = m·data + d lives on grid (d, m)."""
    data = mesh.shape["data"]
    return [mesh.grid[k % data][k // data] for k in range(_maint_size(mesh))]


def _maint_blocks(mesh, r: int) -> list[tuple[torch.device, slice]]:
    """(device, plane slice) of each maintenance shard, R validated."""
    _check_planes(r, _maint_size(mesh), "maintenance")
    p = r // _maint_size(mesh)
    return [(dev, slice(k * p, (k + 1) * p))
            for k, dev in enumerate(maint_devices(mesh))]


def _on(dev: torch.device):
    """Make `dev` the current CUDA device for a shard body (the kernels
    launch on the current device); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _to(x, dev: torch.device):
    """`x` replicated onto `dev`: a tensor, or a dataclass of them (a
    `Graph`, a `BatchUpdate`, a `RelaxPlan` and its tilings), moved field
    by field; `x` itself where it is already there, and None stays."""
    if torch.is_tensor(x):
        return x.to(dev)
    if x is None or not dataclasses.is_dataclass(x):
        return x
    moved = {f.name: _to(getattr(x, f.name), dev)
             for f in dataclasses.fields(x)}
    if all(moved[k] is getattr(x, k) for k in moved):
        return x
    return dataclasses.replace(x, **moved)


def _each(shards, body) -> list:
    """`body(k, dev, blk)` for each shard, under its device."""
    out = []
    for k, (dev, blk) in enumerate(shards):
        with _on(dev):
            out.append(body(k, dev, blk))
    return out


def _unzip(outs: list) -> tuple[list, ...]:
    return tuple(list(x) for x in zip(*outs))


def gather_planes(mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """The all-gather of per-shard planes onto the mesh's first device."""
    return torch.cat([x.to(mesh.first) for x in parts])


def _pany(mesh, flags: list[torch.Tensor]) -> torch.Tensor:
    """OR-merge of per-shard scalar flags (`pmax`) on the first device: a
    device tensor, read by the caller once."""
    return torch.stack([f.to(mesh.first) for f in flags]).any()


def _chunk_shards(mesh, state: list) -> list[tuple[torch.device, None]]:
    """The maintenance shards of per-shard chunk state."""
    devs = maint_devices(mesh)
    if len(state) != len(devs):
        raise ValueError(f"{len(state)} plane shards for a mesh of "
                         f"{len(devs)}")
    return [(dev, None) for dev in devs]


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def shard_build_labelling(mesh, g: Graph, landmarks: torch.Tensor,
                          max_iters: int | None = None,
                          plan: RelaxPlan | None = None) -> HighwayLabelling:
    """`build_labelling` on the mesh; bit-identical outputs, gathered on
    the mesh's first device. `plan` (replicated into every shard) runs
    kernel A on each shard's planes."""
    landmarks = landmarks.to(torch.int32)
    shards = _maint_blocks(mesh, landmarks.shape[0])

    def body(k, dev, blk):
        lm = landmarks.to(dev)
        key2 = construct_key2_planes(_to(g, dev), lm[blk], lm, max_iters,
                                     plan=_to(plan, dev))
        dist = key2_dist(key2).clamp_max(INF_D)
        hub = key2_hub(key2) & (dist < INF_D)
        return dist, hub, dist[:, lm.to(torch.int64)]   # local rows [P, R]

    dist, hub, highway = _unzip(_each(shards, body))
    return HighwayLabelling(landmarks.to(mesh.first),
                            gather_planes(mesh, dist),
                            gather_planes(mesh, hub),
                            gather_planes(mesh, highway))


# ---------------------------------------------------------------------------
# Batch update
# ---------------------------------------------------------------------------

def shard_batchhl_update(mesh, g_old: Graph, batch: BatchUpdate,
                         labelling: HighwayLabelling, improved: bool = True,
                         plan: RelaxPlan | None = None,
                         g_new: Graph | None = None
                         ) -> tuple[Graph, HighwayLabelling, torch.Tensor]:
    """`batchhl_update` on the mesh; bit-identical (G', Γ', aff), Γ' and
    aff gathered on the mesh's first device.

    Search and repair run per shard on its plane slice. As for
    `batchhl_update`, a `plan` must be prepared from the post-update
    snapshot; a caller that built it passes it as `g_new`.
    """
    shards = _maint_blocks(mesh, labelling.landmarks.shape[0])
    check_labelling_width(g_old, labelling.dist)
    if g_new is None:
        g_new = apply_batch(g_old, batch)
    # Seeds cross deletion/re-weight edges at their pre-update weight,
    # resolved against g_old; apply_batch above took the original batch.
    batch = resolve_seed_weights(g_old, batch)

    def body(k, dev, blk):
        g, b, pl = _to(g_new, dev), _to(batch, dev), _to(plan, dev)
        lm = labelling.landmarks.to(dev)
        dist, hub = labelling.dist[blk].to(dev), labelling.hub[blk].to(dev)
        hub_mask = per_plane_hub_mask(lm, lm[blk], g.n)
        if improved:
            aff = search_improved_planes(g, b, dist, hub, hub_mask, pl)
        else:
            aff = search_basic_planes(g, b, dist, pl)
        new_key2 = repair_planes(g, aff, key2_make(dist, hub), hub_mask, pl)
        ndist = key2_dist(new_key2).clamp_max(INF_D)
        nhub = key2_hub(new_key2) & (ndist < INF_D)
        return ndist, nhub, ndist[:, lm.to(torch.int64)], aff

    ndist, nhub, highway, aff = _unzip(_each(shards, body))
    lab = HighwayLabelling(labelling.landmarks.to(mesh.first),
                           gather_planes(mesh, ndist),
                           gather_planes(mesh, nhub),
                           gather_planes(mesh, highway))
    return g_new, lab, gather_planes(mesh, aff)


def affected_vertices(mesh, aff: torch.Tensor) -> torch.Tensor:
    """OR-merge the per-plane affected sets aff [R, V] into one bool[V]
    vertex mask: each shard ORs its planes, a `pmax` merges the shards."""
    shards = _maint_blocks(mesh, aff.shape[0])
    parts = _each(shards, lambda k, dev, blk:
                  aff[blk].to(dev).any(0).to(torch.int32))
    return torch.stack([x.to(mesh.first) for x in parts]).amax(0) > 0


# ---------------------------------------------------------------------------
# Bounded update chunks (the serving pipeline's mesh path, DESIGN.md §5)
# ---------------------------------------------------------------------------
#
# The mesh twins of the chunks of `core/snapshot.py`, driven by the same
# `pipelined_update`. dist/hub/landmarks are the labelling's full tensors;
# every other plane argument and result is a list with one tensor per
# maintenance shard, in block order (`maint_devices`). A chunk's
# `changed` is the `pmax` of the shards' flags, on the first device.

def shard_search_seed(mesh, g_new: Graph, batch: BatchUpdate,
                      dist: torch.Tensor, hub: torch.Tensor,
                      landmarks: torch.Tensor, improved: bool = True):
    """Mesh twin of `snapshot.search_seed` → per-shard lists (seed,
    seeded, bound, hub_mask)."""
    shards = _maint_blocks(mesh, landmarks.shape[0])
    check_labelling_width(g_new, dist)

    def body(k, dev, blk):
        g, b, lm = _to(g_new, dev), _to(batch, dev), landmarks.to(dev)
        d = dist[blk].to(dev)
        hub_mask = per_plane_hub_mask(lm, lm[blk], g.n)
        if improved:
            seed, seeded, beta = search_improved_seed(
                g, b, d, hub[blk].to(dev), hub_mask)
            return seed, seeded, beta, hub_mask
        seed, seeded = search_basic_seed(g, b, d)
        return seed, seeded, d, hub_mask

    return _unzip(_each(shards, body))


def shard_search_chunk(mesh, g_new: Graph, best: list, seed: list,
                       bound: list, hub_mask: list, plan: RelaxPlan | None,
                       improved: bool = True, sweeps: int = 1):
    """Mesh twin of `snapshot.search_chunk` → (best', changed)."""
    best, changed = _unzip(_each(_chunk_shards(mesh, best), lambda k, dev, _:
                                 search_chunk(_to(g_new, dev), best[k],
                                              seed[k], bound[k], hub_mask[k],
                                              _to(plan, dev), improved,
                                              sweeps)))
    return best, _pany(mesh, changed)


def shard_search_finish(mesh, best: list, seeded: list,
                        improved: bool = True) -> list:
    """Mesh twin of `snapshot.search_finish` → per-shard aff."""
    return _each(_chunk_shards(mesh, best), lambda k, dev, _:
                 search_finish(best[k], seeded[k], improved))


def shard_interior_mask(mesh, g_new: Graph, aff: list) -> list:
    """Mesh twin of `snapshot.interior_mask` → per-shard [P, E2] masks."""
    return _each(_chunk_shards(mesh, aff), lambda k, dev, _:
                 interior_mask(_to(g_new, dev), aff[k]))


def shard_repair_start(mesh, g_new: Graph, aff: list, dist: torch.Tensor,
                       hub: torch.Tensor, hub_mask: list,
                       plan: RelaxPlan | None) -> list:
    """Mesh twin of `snapshot.repair_start` (Algo-4 boundary seeding)."""
    shards = _maint_blocks(mesh, dist.shape[0])
    return _each(shards, lambda k, dev, blk: repair_start(
        _to(g_new, dev), aff[k], dist[blk].to(dev), hub[blk].to(dev),
        hub_mask[k], _to(plan, dev)))


def shard_repair_chunk(mesh, g_new: Graph, cur: list, aff: list,
                       hub_mask: list, plan: RelaxPlan | None,
                       sweeps: int = 1, int_mask: list | None = None):
    """Mesh twin of `snapshot.repair_chunk` → (cur', changed)."""
    cur, changed = _unzip(_each(_chunk_shards(mesh, cur), lambda k, dev, _:
                                repair_chunk(_to(g_new, dev), cur[k], aff[k],
                                             hub_mask[k], _to(plan, dev),
                                             sweeps, _at(int_mask, k))))
    return cur, _pany(mesh, changed)


def _at(parts: list | None, k: int):
    return None if parts is None else parts[k]


# --- fused chunk twins (seed and first waves in one step, later in place) ---
#
# Mesh versions of `snapshot.fused_*`, with the same contract: the fused
# starts return fresh planes, and the later chunks lower them in place,
# so the caller rebinds them after every chunk.

def shard_fused_search_start(mesh, g_new: Graph, batch: BatchUpdate,
                             dist: torch.Tensor, hub: torch.Tensor,
                             landmarks: torch.Tensor,
                             plan: RelaxPlan | None, improved: bool = True,
                             sweeps: int = 1):
    """Mesh twin of `snapshot.fused_search_start` →
    (best, seed, seeded, bound, hub_mask, changed)."""
    seed, seeded, bound, hub_mask = shard_search_seed(
        mesh, g_new, batch, dist, hub, landmarks, improved)
    best, changed = shard_fused_search_chunk(
        mesh, g_new, [s.clone() for s in seed], seed, bound, hub_mask, plan,
        improved, sweeps)
    return best, seed, seeded, bound, hub_mask, changed


def shard_fused_search_chunk(mesh, g_new: Graph, best: list, seed: list,
                             bound: list, hub_mask: list,
                             plan: RelaxPlan | None, improved: bool = True,
                             sweeps: int = 1):
    """`shard_search_chunk` lowering each shard's `best` in place."""
    best, changed = _unzip(_each(_chunk_shards(mesh, best), lambda k, dev, _:
                                 fused_search_chunk(_to(g_new, dev), best[k],
                                                    seed[k], bound[k],
                                                    hub_mask[k],
                                                    _to(plan, dev), improved,
                                                    sweeps)))
    return best, _pany(mesh, changed)


def shard_fused_repair_start_chunk(mesh, g_new: Graph, aff: list,
                                   dist: torch.Tensor, hub: torch.Tensor,
                                   hub_mask: list, plan: RelaxPlan | None,
                                   sweeps: int = 1,
                                   int_mask: list | None = None):
    """Mesh twin of `snapshot.fused_repair_start_chunk` → (cur, changed)."""
    cur = shard_repair_start(mesh, g_new, aff, dist, hub, hub_mask, plan)
    return shard_fused_repair_chunk(mesh, g_new, cur, aff, hub_mask, plan,
                                    sweeps, int_mask)


def shard_fused_repair_chunk(mesh, g_new: Graph, cur: list, aff: list,
                             hub_mask: list, plan: RelaxPlan | None,
                             sweeps: int = 1, int_mask: list | None = None):
    """`shard_repair_chunk` lowering each shard's `cur` in place."""
    cur, changed = _unzip(_each(_chunk_shards(mesh, cur), lambda k, dev, _:
                                fused_repair_chunk(_to(g_new, dev), cur[k],
                                                   aff[k], hub_mask[k],
                                                   _to(plan, dev), sweeps,
                                                   _at(int_mask, k))))
    return cur, _pany(mesh, changed)


# --- frontier chunk twins (change propagation, DESIGN.md §10) --------------
#
# Mesh versions of `snapshot.*_frontier`. The per-plane changed-block
# bitmap `front` [P, NBf] is per-shard state like the planes, so each
# shard propagates and relaxes the frontier of its own planes, and takes
# the masked/full branch against that local frontier. The waves run in
# lock step: every shard's frontier flags are read in one host read per
# wave. Fused or not, the frontier twins build each plane out of place,
# as the unsharded frontier chunks do.

def _frontier_waves(mesh, kind: str, plan: RelaxPlan, g_new: Graph,
                    fns: list, xs: list, fronts: list, sweeps: int):
    """`sweeps` lock-step frontier waves over the shards; `fns[k]` is
    shard k's (full_step, masked_step). → (xs', fronts', changed)."""
    shards = _chunk_shards(mesh, xs)
    xs, fronts = list(xs), list(fronts)
    for _ in range(sweeps):
        probes = _each(shards, lambda k, dev, _:
                       frontier_probe(_to(plan, dev), fronts[k]))
        flags = torch.stack([f.to(mesh.first) for _, f in probes]).tolist()

        def body(k, dev, _):
            return frontier_apply(kind, _to(plan, dev), _to(g_new, dev),
                                  *fns[k], xs[k], fronts[k], probes[k][0],
                                  *flags[k])[:2]
        xs, fronts = _unzip(_each(shards, body))
    return xs, fronts, _pany(mesh, [f.any() for f in fronts])


def shard_search_chunk_frontier(mesh, g_new: Graph, best: list, front: list,
                                seed: list, bound: list, hub_mask: list,
                                plan: RelaxPlan, improved: bool = True,
                                sweeps: int = 1):
    """Mesh twin of `snapshot.search_chunk_frontier` →
    (best', front', changed)."""
    fns = _each(_chunk_shards(mesh, best), lambda k, dev, _: search_wave_fns(
        _to(plan, dev), _to(g_new, dev), seed[k], bound[k], hub_mask[k],
        improved))
    return _frontier_waves(mesh, search_kind(improved), plan, g_new, fns,
                           best, front, sweeps)


def shard_repair_start_frontier(mesh, g_new: Graph, aff: list,
                                dist: torch.Tensor, hub: torch.Tensor,
                                hub_mask: list, plan: RelaxPlan):
    """Mesh twin of `snapshot.repair_start_frontier` → (base, front), one
    host read of every shard's row count."""
    shards = _maint_blocks(mesh, dist.shape[0])
    probes = _each(shards, lambda k, dev, blk:
                   repair_base_rows(_to(plan, dev), aff[k]))
    counts = torch.stack([c.to(mesh.first) for _, c in probes]).tolist()

    def body(k, dev, blk):
        WAVES["repair_base"] += 1
        pl = _to(plan, dev)
        base = repair_base_apply(
            pl, _to(g_new, dev), aff[k],
            key2_make(dist[blk].to(dev), hub[blk].to(dev)), hub_mask[k],
            probes[k][0], counts[k])
        return base, pl.frontier.changed_blocks(base < INF_KEY2)
    return _unzip(_each(shards, body))


def shard_repair_chunk_frontier(mesh, g_new: Graph, cur: list, front: list,
                                aff: list, hub_mask: list, plan: RelaxPlan,
                                sweeps: int = 1,
                                int_mask: list | None = None):
    """Mesh twin of `snapshot.repair_chunk_frontier` →
    (cur', front', changed)."""
    if int_mask is None:
        int_mask = shard_interior_mask(mesh, g_new, aff)

    def fns(k, dev, _):
        g, pl = _to(g_new, dev), _to(plan, dev)
        return (lambda c: repair_step(pl, g, c, aff[k], hub_mask[k],
                                      int_mask[k]),
                lambda c, rows_g: repair_step_rows(rows_g, c, aff[k],
                                                   hub_mask[k]))
    return _frontier_waves(mesh, "repair", plan, g_new,
                           _each(_chunk_shards(mesh, cur), fns), cur, front,
                           sweeps)


def shard_fused_search_start_frontier(mesh, g_new: Graph,
                                      batch: BatchUpdate, dist: torch.Tensor,
                                      hub: torch.Tensor,
                                      landmarks: torch.Tensor,
                                      plan: RelaxPlan, improved: bool = True,
                                      sweeps: int = 1):
    """Mesh twin of `snapshot.fused_search_start_frontier` →
    (best, front, seed, seeded, bound, hub_mask, changed)."""
    seed, seeded, bound, hub_mask = shard_search_seed(
        mesh, g_new, batch, dist, hub, landmarks, improved)
    best, front, changed = shard_search_chunk_frontier(
        mesh, g_new, seed, shard_frontier_seed_blocks(mesh, plan, seeded),
        seed, bound, hub_mask, plan, improved, sweeps)
    return best, front, seed, seeded, bound, hub_mask, changed


#: Out of place, as the unsharded frontier chunks are in both modes.
shard_fused_search_chunk_frontier = shard_search_chunk_frontier


def shard_fused_repair_start_chunk_frontier(mesh, g_new: Graph, aff: list,
                                            dist: torch.Tensor,
                                            hub: torch.Tensor,
                                            hub_mask: list, plan: RelaxPlan,
                                            sweeps: int = 1,
                                            int_mask: list | None = None):
    """Mesh twin of `snapshot.fused_repair_start_chunk_frontier` →
    (cur, front, changed)."""
    cur, front = shard_repair_start_frontier(mesh, g_new, aff, dist, hub,
                                             hub_mask, plan)
    return shard_repair_chunk_frontier(mesh, g_new, cur, front, aff,
                                       hub_mask, plan, sweeps, int_mask)


#: Out of place, as the unsharded frontier chunks are in both modes.
shard_fused_repair_chunk_frontier = shard_repair_chunk_frontier


def shard_frontier_seed_blocks(mesh, plan: RelaxPlan, seeded: list) -> list:
    """Mesh twin of `snapshot.frontier_seed_blocks`, per shard."""
    return _each(_chunk_shards(mesh, seeded), lambda k, dev, _:
                 frontier_seed_blocks(_to(plan, dev), seeded[k]))


def shard_update_finish(mesh, aff: list, settled: list, dist: torch.Tensor,
                        hub: torch.Tensor,
                        landmarks: torch.Tensor) -> HighwayLabelling:
    """Mesh twin of `snapshot.update_finish`; the labelling is gathered on
    the mesh's first device, like `shard_batchhl_update`'s."""
    shards = _maint_blocks(mesh, landmarks.shape[0])
    parts = _each(shards, lambda k, dev, blk: update_finish(
        aff[k], settled[k], dist[blk].to(dev), hub[blk].to(dev),
        landmarks.to(dev)))
    return HighwayLabelling(
        landmarks.to(mesh.first),
        *(gather_planes(mesh, [getattr(lab, f) for lab in parts])
          for f in ("dist", "hub", "highway")))


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def shard_batched_query(mesh, g: Graph, labelling: HighwayLabelling,
                        s: torch.Tensor, t: torch.Tensor,
                        max_steps: int = 64, use_kernel: bool | None = None,
                        plan: RelaxPlan | None = None) -> torch.Tensor:
    """`batched_query` on the mesh; exact distances on the first device.

    Landmark planes over `model`, the query batch over `data`: the batch
    is padded with (0, 0) pairs to a multiple of the data-axis size and
    the padding sliced off. `use_kernel` (None: on a CUDA shard) runs the
    partial bound through kernel B; the plain contraction is the CPU's,
    and asking for it on a CUDA shard raises. Each data shard's BiBFS
    expands its own padded sub-batch, choosing its side over that
    sub-batch as the reference does, so with `max_steps` binding the
    answers can differ from an unsharded run's.
    """
    b = s.shape[0]
    pad = (-b) % mesh.shape["data"]
    if pad:
        s = torch.cat([s, s.new_zeros(pad)])
        t = torch.cat([t, t.new_zeros(pad)])
    out = _shard_query_core(mesh, g, labelling, s, t, max_steps, use_kernel,
                            plan)
    return out[:b]


def _shard_query_core(mesh, g: Graph, labelling: HighwayLabelling,
                      s: torch.Tensor, t: torch.Tensor, max_steps: int,
                      use_kernel: bool | None,
                      plan: RelaxPlan | None) -> torch.Tensor:
    data, model = mesh.shape["data"], mesh.shape["model"]
    r = labelling.landmarks.shape[0]
    _check_planes(r, model, "model")
    p, bl = r // model, s.shape[0] // data
    lab_vals: dict = {}    # (device, model block) -> effective labels [P, V]

    def labels(dev, m):
        if (dev, m) not in lab_vals:
            blk = slice(m * p, (m + 1) * p)
            lm = labelling.landmarks.to(dev)
            lab_vals[dev, m] = effective_label_planes(
                labelling.dist[blk].to(dev), labelling.hub[blk].to(dev),
                lm[blk], lm)
        return lab_vals[dev, m]

    out = []
    for d in range(data):
        row = mesh.grid[d]
        sd, td = s[d * bl:(d + 1) * bl], t[d * bl:(d + 1) * bl]

        def label_rows(m, dev, _):
            vals = labels(dev, m)
            return tuple(vals[:, x.to(dev, torch.int64)].T.clamp_max(INF_D)
                         .contiguous() for x in (sd, td))
        s_lab, t_lab = _unzip(_each([(dev, None) for dev in row],
                                    label_rows))

        def partial_bound(m, dev, _):
            # Eq. 3 with the landmark axis sharded: this shard's highway
            # rows [P, R] against the all-gathered target labels [B, R].
            t_all = torch.cat([x.to(dev) for x in t_lab], dim=1)
            h = labelling.highway[m * p:(m + 1) * p].to(dev).contiguous()
            kernel = dev.type == "cuda" if use_kernel is None else use_kernel
            if kernel:
                return minplus_ops.minplus_bound(s_lab[m], h, t_all)
            if dev.type == "cuda":
                raise ValueError("use_kernel=False runs the plain min-plus "
                                 "contraction, on the CPU only; on the GPU "
                                 "the bound runs kernel B")
            mid = (s_lab[m][:, :, None] + h[None, :, :]).amin(dim=1)
            return (mid + t_all).amin(dim=1)
        partial = _each([(dev, None) for dev in row], partial_bound)

        dev = row[0]
        with _on(dev):   # the bounded BiBFS on the data shard's sub-batch
            d_top = torch.stack([x.to(dev) for x in partial]) \
                .amin(0).clamp_max(INF_D)
            d_sparse = bounded_bibfs(_to(g, dev),
                                     labelling.landmarks.to(dev),
                                     sd.to(dev), td.to(dev), d_top,
                                     max_steps, _to(plan, dev))
            res = torch.minimum(d_sparse, d_top)
            out.append(torch.where(res >= INF_D, INF_D, res))
    return torch.cat([x.to(mesh.first) for x in out])
