"""The prepared tilings (`BlockedGraph`, `FrontierTiles`) and the sweeps
over them.

`BlockedGraph` carries the destination-block tiling of a snapshot's
occupied edge slots, organised as `shards` contiguous vertex shards
(leading [S] axis; S=1 is the unsharded tiling), with rows of at most
`block_e` slots (`rowblk_t` names each row's destination block). The
tiling is purely topological — source, local destination, original slot
index — so per-sweep edge masks and weights, which churn with every batch,
are read through `perm_t` inside the sweep. It is rebuilt only when
insertions rewrite slots; `core/engine.py` owns that cache.

`prepare` is the legacy entry: it tiles *every* slot and bakes the
validity it is given into `valid_t`, for `edge_relax`. `prepare_topology`
sets `valid_t` to slot occupancy; its tiling must only reach `relax_sweep`,
which reads the current mask each wave — fed to `edge_relax`, it would
treat edges deleted after prepare time as present.

`FrontierTiles` is the change-propagation row tiling of the frontier mode
(`core/batch.py`): the kept slots grouped into rows of `fblock`-vertex
destination blocks, with the block adjacency that carries a changed-block
frontier one hop per wave.

`SortedGraph` is the `sorted` impl's edge list: the kept slots sorted by
destination vertex. `relax_sweep_sorted` runs the same sweep over it in
plain PyTorch ops (the reference's jnp `segment_min` twin); the
autotuner (`core/autotune.py`) may pick it on measured speed. It is not
kernel A's plain twin, and nothing falls back to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.labelling import sat_add
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_relax import kernel


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    src_t: torch.Tensor     # int32[S, NR, BE] source vertex per tile slot
    dstloc_t: torch.Tensor  # int32[S, NR, BE] destination local to the block
    valid_t: torch.Tensor   # int32[S, NR, BE] validity baked at prepare time
    perm_t: torch.Tensor    # int32[S, NR, BE] original edge-slot index
    slot_t: torch.Tensor    # int32[S, NR, BE] 1 on real slots, 0 on padding
    rowblk_t: torch.Tensor  # int32[S, NR] local destination block of each row
    n: int
    block_v: int
    nb: int                 # destination blocks per shard (NR >= nb)
    chunked: bool           # some destination block spans several tile rows

    @property
    def shards(self) -> int:
        """Vertex-shard count S of the tiling (leading tile axis)."""
        return self.src_t.shape[0]

    @property
    def slots(self) -> int:
        """Tile slots S·NR·BE, padding included."""
        return self.src_t.numel()


def _blocked(src, dst, keep, valid, n, block_v, shards, block_e,
             device) -> BlockedGraph:
    """Tile the `keep` slots; `valid` (None: occupancy) is baked into
    valid_t. `chunked` is recorded from the pre-shard row count:
    post-shard shapes cannot tell a chunked tiling whose extra rows fill a
    short last shard from an unchunked one."""
    device = resolve_device(device)
    src_t, dstloc_t, perm_t, slot_t, rowblk, bv = kernel.block_edges_topology(
        src, dst, keep, n, block_v, block_e)
    nb = -(-n // bv)
    chunked = len(rowblk) != nb
    tiles = [src_t, dstloc_t, perm_t, slot_t]
    if valid is not None:
        tiles.append(np.where(slot_t != 0, valid[perm_t], 0).astype(np.int32)
                     if len(valid) else np.zeros_like(slot_t))
    rowblk_t, nb_loc, *tiles = kernel.shard_tiling(shards, nb, rowblk, *tiles)
    rowblk_t, *tiles = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (rowblk_t, *tiles))
    src_t, dstloc_t, perm_t, slot_t = tiles[:4]
    valid_t = tiles[4] if valid is not None else slot_t
    return BlockedGraph(src_t=src_t, dstloc_t=dstloc_t, valid_t=valid_t,
                        perm_t=perm_t, slot_t=slot_t, rowblk_t=rowblk_t,
                        n=n, block_v=bv, nb=nb_loc, chunked=chunked)


def prepare(src, dst, valid, n: int, block_v: int = 512, shards: int = 1,
            block_e: int | None = None, *,
            device: str | torch.device | None = None) -> BlockedGraph:
    """Tile every edge slot and bake `valid` into valid_t (legacy entry).

    Free slots are tiled too: they hold src = dst = 0, so they all land in
    destination block 0, with valid_t 0. `device=None` is the GPU, as for
    every `prepare*` here (see `repro_torch.device`).
    """
    src = np.asarray(src)
    return _blocked(src, np.asarray(dst), np.ones(len(src), bool),
                    np.asarray(valid, bool), n, block_v, shards, block_e,
                    device)


def prepare_topology(src, dst, keep, n: int, block_v: int = 512,
                     shards: int = 1, block_e: int | None = None, *,
                     device: str | torch.device | None = None
                     ) -> BlockedGraph:
    """Tile the `keep` slots on the host and move the tiles to `device`.

    `keep` should be the currently-occupied slots: later deletions only
    flip validity (read per sweep), while insertions rewrite src/dst and
    force a fresh prepare. `valid_t` is `slot_t` itself (occupancy).
    """
    return _blocked(np.asarray(src), np.asarray(dst), np.asarray(keep, bool),
                    None, n, block_v, shards, block_e, device)


def _as_planes(keys: torch.Tensor, hub: torch.Tensor | None):
    """(keys, hub) as [P, V] planes, and whether one [V] plane came in:
    the reference sweeps one plane [V], the port P planes at once."""
    if keys.dim() != 1:
        return keys, hub, False
    return keys[None], None if hub is None else hub[None], True


def relax_sweep(keys: torch.Tensor, bg: BlockedGraph,
                edge_mask: torch.Tensor, step: int, inf: int,
                clear_bit: int = 0, hub: torch.Tensor | None = None,
                w: torch.Tensor | None = None) -> torch.Tensor:
    """One wave of the planes `keys` [P, V] over the tiled graph, or of
    one plane [V] → [V] as in the reference.

    `edge_mask` ([E2] or [P, E2]) and the weights `w` ([E2]) are in
    original slot order; `w=None` is the unweighted metric, w ≡ 1 on real
    slots (the reference's `tile_w(None)`). `hub` is a bool plane of the
    shape of `keys`, or None.
    """
    keys, hub, one = _as_planes(keys, hub)
    if w is None:
        w = torch.ones(edge_mask.shape[-1], dtype=torch.int32,
                       device=keys.device)
    out = kernel.relax_sweep(keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t,
                             bg.slot_t, bg.rowblk_t, edge_mask, w, step, inf,
                             clear_bit, bg.n, bg.block_v, bg.nb)
    return out[0] if one else out


def edge_relax(keys: torch.Tensor, bg: BlockedGraph, step: int
               ) -> torch.Tensor:
    """The legacy sweep of one plane `keys` [V] over a `prepare` tiling:
    min over the baked-valid slots of sat(keys[src] + step), INF32 where
    none. The device of `keys` picks the kernel or its plain version."""
    return kernel.edge_relax(keys, bg.src_t, bg.dstloc_t, bg.valid_t,
                             bg.rowblk_t, step, bg.n, bg.block_v, bg.nb)


@dataclasses.dataclass(frozen=True)
class SortedGraph:
    """The kept edge slots sorted by destination vertex (the `sorted` impl).

    `perm_s` maps each sorted position to its original slot, so the
    per-sweep mask and weights are read through it, as `BlockedGraph`
    reads them through `perm_t`. The indices are int64, the dtype the
    gathers and the scatter take, so a sweep converts nothing.
    """
    src_s: torch.Tensor   # int64 [M] source vertex, dst-sorted order
    dst_s: torch.Tensor   # int64 [M] destination vertex, ascending
    perm_s: torch.Tensor  # int64 [M] original edge-slot index
    n: int


def prepare_sorted(src, dst, keep, n: int, *,
                   device: str | torch.device | None = None) -> SortedGraph:
    """Sort the `keep` slots by destination on the host (stable, so equal
    destinations keep slot order) and move them to `device`: once per
    topology, the `sorted` twin of `prepare_topology`."""
    device = resolve_device(device)
    src = np.asarray(src)
    dst = np.asarray(dst)
    idx = np.flatnonzero(np.asarray(keep, bool))
    perm = idx[np.argsort(dst[idx], kind="stable")]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    return SortedGraph(dev(src[perm]), dev(dst[perm]), dev(perm), n)


def relax_sweep_sorted(keys: torch.Tensor, sg: SortedGraph,
                       edge_mask: torch.Tensor, step: int, inf: int,
                       clear_bit: int = 0, hub: torch.Tensor | None = None,
                       w: torch.Tensor | None = None) -> torch.Tensor:
    """The `sorted` impl of `relax_sweep`: the same wave, [P, V] → [P, V]
    or [V] → [V], over the destination-sorted kept slots, in PyTorch ops.

    Gather the sources, add step·w saturating at `inf`, clear the hub bit
    at hub destinations, mask, and take the min by destination; a
    destination no live slot reaches is `inf`. `edge_mask` ([E2] or
    [P, E2]) and `w` ([E2]) are in original slot order; `w=None` is the
    unweighted metric.
    """
    keys, hub, one = _as_planes(keys, hub)
    p = keys.shape[0]
    mask = edge_mask[..., sg.perm_s]
    sw = step if w is None else step * w[sg.perm_s]
    cand = sat_add(keys[:, sg.src_s], sw, inf)                      # [P, M]
    if hub is not None:
        cand = torch.where(hub[:, sg.dst_s], cand & ~clear_bit, cand)
    cand = torch.where(mask, cand, inf)
    out = torch.full((p, sg.n), inf, dtype=torch.int32, device=keys.device)
    out.scatter_reduce_(1, sg.dst_s.expand(p, -1), cand, "amin")
    return out[0] if one else out


@dataclasses.dataclass(frozen=True)
class FrontierTiles:
    """The change-propagation row tiling of the frontier mode.

    The kept slots grouped into destination-block rows (the host tiling
    `BlockedGraph` uses, at the finer block size `fblock`), plus the
    block adjacency that propagates an active frontier one block-hop per
    wave. Row `nrows` is an all-padding sentinel; the row count is
    bucketed to a multiple of 64 with rows whose `rowblk` is `nbf`, the
    never-active block. A masked wave may use only the active rows, and
    does so while their count is at most `rows_cap`; past it the wave
    falls back to the full sweep. The reference needs the bucketing and
    the sentinel for static shapes under jit; the port keeps both so that
    `nrows` and `rows_cap`, and with them the choice of masked or full
    wave by wave, are the reference's.
    """
    src_r: torch.Tensor     # int32[NR+1, BE] source vertex (row NR: sentinel)
    dstg_r: torch.Tensor    # int32[NR+1, BE] global destination vertex
    perm_r: torch.Tensor    # int32[NR+1, BE] original edge-slot index
    slot_r: torch.Tensor    # int32[NR+1, BE] 1 on real slots, 0 on padding
    rowblk_r: torch.Tensor  # int32[NR] destination block per row (nbf on
                            # bucket-padding rows)
    adj: torch.Tensor       # bool[NBf, NBf] block u holds an edge into v
    n: int
    fblock: int             # frontier block size (vertices per block)
    nbf: int                # number of frontier blocks = ceil(n / fblock)
    nrows: int              # tile rows NR, bucketed to a multiple of 64
    rows_cap: int           # masked-wave row budget (density threshold)

    def propagate(self, front: torch.Tensor) -> torch.Tensor:
        """Blocks one hop from the changed blocks `front` [NBf]:
        active[v] = ∃ u: front[u] ∧ adj[u, v]. Gathers only the rows of
        `front` instead of masking the whole [NBf, NBf] matrix."""
        return self.adj[front].any(0)

    def changed_blocks(self, changed_v: torch.Tensor) -> torch.Tensor:
        """Per-vertex changed flags [..., V] → per-block flags [..., NBf]."""
        pad = self.nbf * self.fblock - self.n
        padded = torch.nn.functional.pad(changed_v, (0, pad))
        return padded.reshape(changed_v.shape[:-1]
                              + (self.nbf, self.fblock)).any(-1)

    def active_rows(self, active_blocks: torch.Tensor) -> torch.Tensor:
        """Active-block flags [NBf] → tile-row flags [NR]; bucket-padding
        rows (rowblk = nbf) index the appended always-False entry."""
        never = active_blocks.new_zeros(1)
        return torch.cat([active_blocks, never])[self.rowblk_r.to(torch.int64)]

    def gather(self, ridx: torch.Tensor):
        """The rows named by `ridx`: (src [K, BE], dst-global [K, BE],
        perm [K, BE], slot [K, BE] bool)."""
        return (self.src_r[ridx], self.dstg_r[ridx], self.perm_r[ridx],
                self.slot_r[ridx] != 0)


def prepare_frontier(src, dst, keep, n: int, fblock: int = 64,
                     block_e: int | None = 128, threshold: float = 0.25, *,
                     device: str | torch.device | None = None
                     ) -> FrontierTiles:
    """Build the change-propagation tiling on the host, once per topology.

    `block_e` caps the row width as the kernel tiling's does, so hub
    blocks chunk into several rows. The masked wave runs while the active
    rows number at most rows_cap = max(1, min(NR, ceil(threshold · NR))).
    """
    device = resolve_device(device)
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = np.asarray(keep, bool)
    src_t, dstloc_t, perm_t, slot_t, rowblk, fb = kernel.block_edges_topology(
        src, dst, keep, n, fblock, block_e)
    nr, be = src_t.shape
    nbf = -(-n // fb)
    dstg_t = np.where(slot_t != 0, rowblk[:, None] * fb + dstloc_t, 0)
    nr_b = max(64, -(-nr // 64) * 64)
    pad_rows = np.zeros((nr_b - nr + 1, be), np.int32)
    rowblk_b = np.concatenate([rowblk, np.full(nr_b - nr, nbf, np.int32)])
    adj = np.zeros((nbf, nbf), bool)
    if keep.any():
        adj[src[keep] // fb, dst[keep] // fb] = True
    rows_cap = max(1, min(nr_b, int(np.ceil(nr_b * threshold))))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FrontierTiles(
        *(dev(np.concatenate([t, pad_rows]).astype(np.int32))
          for t in (src_t, dstg_t, perm_t, slot_t)),
        dev(rowblk_b), dev(adj), n, fb, nbf, nr_b, rows_cap)
