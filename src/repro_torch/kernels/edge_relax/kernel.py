"""The relax sweep: host tiling, the CUDA kernel's wrapper, its plain twin.

Every BatchHL wave — construction, Algo 2/3 search, Algo 4 repair and the
BiBFS of queries — is one call of

    out[p, v] = min over masked edges (u, v) of
                clear_if_hub(p, v, min(keys[p, u] + step·w(u, v), inf))

with `inf` where no edge reaches v, over all P planes at once. The three
parameter sets are (step, inf, clear) = (1, INF_D, 0) for BiBFS and Algo 2,
(2, INF_KEY2, 1) for key2 construction and repair, and (4, INF_KEY4, 2)
for the key4 improved search. The order is saturate, hub-clear, mask.

`relax_sweep` launches the hand-written kernel `csrc/relax_sweep.cu` for
CUDA tensors and runs `relax_sweep_plain` — the same function in plain
PyTorch on the same tiled arrays — for CPU tensors; any other device
raises. They replace the Pallas `_relax_sweep_kernel` and its row fold
`_reduce_rows` in `repro/kernels/edge_relax/kernel.py`, where each plane
is one vmapped `pallas_call`. The kernel walks each tile row once for a
group of up to 32 planes (`plane_group` sizes the group) and reads the
keys through a vertex-major copy that it makes itself ([groups, n,
max(4, group_width)]; [n, 32] for 32 planes); the arguments and the
result stay plane-major [P, n]. It folds in one of two modes, which
`sweep_mode` picks from block_v alone: the tiled mode (block_v <=
SWEEP_MAX_BLOCK_V) folds each row's candidates in a tile in shared
memory, the wide mode (any wider block_v) atomicMin's them straight into
`out` in device memory. Both take every block_v the reference takes.

`edge_relax` is the legacy sweep of one plane with its validity baked
into the tiles at prepare time (`ops.prepare`) and no weight or hub:

    out[v] = min over tile slots e with dst v and valid_t[e] != 0 of
             sat(keys[src[e]] + step),   INF32 = 2^29 where none

where sat maps a negative (wrapped) int32 sum to INF32 and clamps at
INF32. It launches `csrc/edge_relax.cu` for CUDA tensors and runs
`edge_relax_plain` for CPU tensors, replacing the Pallas `_relax_kernel`
(and its `_reduce_rows` fold) of the same reference module. Its tiled
mode keeps one int32 per vertex of a block in shared memory (block_v <=
EDGE_RELAX_MAX_BLOCK_V); past that its wide mode folds into `out` in
device memory (`edge_relax_mode`).

The host tiling below (`block_edges_topology`, `aligned_vertex_count`,
`shard_tiling`) is numpy, copied from the reference so that both packages
tile a graph identically: edge slots grouped by destination block of
`block_v` vertices, oversized blocks chunked into rows of `block_e`
slots, rows split into `shards` contiguous vertex shards. Every choice of
`block_e` and `shards` gives bit-identical sweeps.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.labelling import sat_add
from repro_torch.graphs.segment import masked_segment_min
from repro_torch.kernels import build

#: Dynamic shared memory one CTA of kernel A or C may opt in to on sm_90.
SWEEP_SHARED_BYTES = 232_448
SWEEP_MAX_GROUP = 32  # planes per CTA: one warp's lanes
SWEEP_CHUNK = 256     # slots per staged chunk (kChunk in relax_sweep.cu)
#: The widest block_v of kernel A's tiled mode, whose one-plane tile and
#: hub words still fit; wider blocks run in its wide mode.
SWEEP_MAX_BLOCK_V = (SWEEP_SHARED_BYTES // 4 - 8 * SWEEP_CHUNK) // 2
#: The widest block_v of kernel C's tiled mode, whose CTA holds one int32
#: per vertex; wider blocks run in its wide mode.
EDGE_RELAX_MAX_BLOCK_V = SWEEP_SHARED_BYTES // 4

INF32 = 1 << 29  # the legacy sweep's infinity, fixed as in the reference

#: Kernel launches since the count was last set to 0 (the CPU path and
#: `relax_sweep_plain` do not count).
launches = 0
#: The same count for the legacy `edge_relax` kernel.
launches_edge_relax = 0


def block_edges_topology(src: np.ndarray, dst: np.ndarray, keep: np.ndarray,
                         n: int, block_v: int, block_e: int | None = None):
    """Host-side tiling: group the kept edge slots by destination block.

    Returns (src_t [NR, BE], dstloc_t [NR, BE], perm_t [NR, BE],
    slot_t [NR, BE], rowblk [NR], block_v). `perm_t` maps each tile slot
    back to its original edge index so per-sweep masks (validity churn,
    repair boundary/interior masks) can be re-tiled on device with one
    gather; `slot_t` is 0 on padding slots. Done once per graph topology.

    Without `block_e`, BE is the largest per-block edge count and NR = NB:
    one tile row per destination block (`rowblk` is the identity). On
    power-law graphs that single hub block inflates every row, so a tuned
    `block_e` caps BE and *chunks* oversized blocks into ceil(count/BE)
    rows — `rowblk[r]` names the destination block row r feeds, rows of
    one block are consecutive, and total padding is bounded by NB·BE
    instead of NB·max-degree-block. Every block keeps at least one row
    (possibly all-padding) so reducing rows by `rowblk` yields a value
    for every block.
    """
    keep = np.asarray(keep, bool)
    idx = np.flatnonzero(keep).astype(np.int64)
    src_k, dst_k = src[idx], dst[idx]
    nb = -(-n // block_v)
    order = np.argsort(dst_k // block_v, kind="stable")
    src_k, dst_k, idx = src_k[order], dst_k[order], idx[order]
    counts = np.bincount(dst_k // block_v, minlength=nb)
    be = block_e or max(int(counts.max() if counts.size else 0), 8)
    rows_per_block = np.maximum(-(-counts // be), 1)
    nr = int(rows_per_block.sum())
    src_t = np.zeros((nr, be), np.int32)
    dst_t = np.zeros((nr, be), np.int32)
    perm_t = np.zeros((nr, be), np.int32)
    slot_t = np.zeros((nr, be), np.int32)
    rowblk = np.repeat(np.arange(nb, dtype=np.int32),
                       rows_per_block).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    row_starts = np.concatenate([[0], np.cumsum(rows_per_block)])
    if src_k.size:
        # Each kept edge lands at (row_starts[block] + within // BE,
        # within % BE) where `within` is its rank inside its block —
        # one vectorized scatter (this runs every insert tick on the
        # serving path, so no per-block python loop).
        blk = dst_k // block_v
        within = np.arange(src_k.size, dtype=np.int64) - starts[blk]
        r = row_starts[blk] + within // be
        c = within % be
        src_t[r, c] = src_k
        dst_t[r, c] = dst_k - blk * block_v
        perm_t[r, c] = idx
        slot_t[r, c] = 1
    return src_t, dst_t, perm_t, slot_t, rowblk, block_v


def aligned_vertex_count(n: int, block_v: int, shards: int) -> int:
    """Smallest vertex count >= n that tiles cleanly: a multiple of
    block_v · shards, so every destination block is full-width and
    `shard_tiling` splits the block axis into `shards` equal groups with
    no all-padding blocks. The growth policy (`core/growth.py`) rounds
    grown vertex counts up to this so a grown tiling has the same shape
    invariants as a fresh one at the same size.
    """
    if n < 1 or block_v < 1 or shards < 1:
        raise ValueError(
            f"need positive n/block_v/shards, got {n}/{block_v}/{shards}")
    unit = block_v * shards
    return -(-n // unit) * unit


def shard_tiling(shards: int, nb: int, rowblk: np.ndarray,
                 *tiles: np.ndarray):
    """Split [NR, BE] tile rows into `shards` contiguous vertex shards.

    Shard s owns destination blocks [s·NB_loc, (s+1)·NB_loc) — and every
    tile row feeding them. Block boundaries are block_v-aligned, so no
    destination block straddles a shard, row *contents* are untouched, and
    flattening the per-shard block order recovers the exact unsharded
    order (padding blocks all land past the last real block, past every
    real vertex). Per-block reductions — and therefore sweep results —
    are bit-identical for every S.

    Returns (rowblk_t [S, NR_loc] of *local* block ids, nb_loc,
    *tiles [S, NR_loc, BE]). Shards with fewer rows pad with all-zero
    rows mapped to the shard's last local block (keeps each shard's
    rowblk sorted — the row→block reduction relies on it); padding rows
    have slot_t=0 everywhere, so they only contribute `inf`.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    nb_loc = max(-(-nb // shards), 1)
    shard_of = rowblk // nb_loc                       # rows sorted by block,
    row_counts = np.bincount(shard_of, minlength=shards)  # so shards are
    nr_loc = max(int(row_counts.max()), 1)                # contiguous runs
    row_starts = np.concatenate([[0], np.cumsum(row_counts)])
    be = tiles[0].shape[1]
    rowblk_t = np.full((shards, nr_loc), nb_loc - 1, np.int32)
    out = [np.zeros((shards, nr_loc, be), t.dtype) for t in tiles]
    for s in range(shards):
        lo, hi = int(row_starts[s]), int(row_starts[s + 1])
        m = hi - lo
        rowblk_t[s, :m] = rowblk[lo:hi] - s * nb_loc
        for o, t in zip(out, tiles):
            o[s, :m] = t[lo:hi]
    return (rowblk_t, nb_loc) + tuple(out)


def _flat_tiles(src_t, dstloc_t, rowblk_t, block_v, nb):
    """Tile arrays [S, NR, BE] → flat int64 (src, global dst) per slot."""
    s = src_t.shape[0]
    gblk = rowblk_t.to(torch.int64) + (
        torch.arange(s, device=src_t.device) * nb)[:, None]
    dst = (gblk[..., None] * block_v + dstloc_t).reshape(-1)
    return src_t.reshape(-1).to(torch.int64), dst


def relax_sweep_plain(keys: torch.Tensor, hub: torch.Tensor | None,
                      src_t: torch.Tensor, dstloc_t: torch.Tensor,
                      perm_t: torch.Tensor, slot_t: torch.Tensor,
                      rowblk_t: torch.Tensor, mask: torch.Tensor,
                      w: torch.Tensor, step: int, inf: int, clear_bit: int,
                      n: int, block_v: int, nb: int) -> torch.Tensor:
    """The plain PyTorch version of the sweep, on the same arguments."""
    p = keys.shape[0]
    n_out = src_t.shape[0] * nb * block_v
    if w.shape[0] == 0:  # zero-capacity graph: all-padding tiles
        return torch.full((p, n), inf, dtype=torch.int32, device=keys.device)
    src, dst = _flat_tiles(src_t, dstloc_t, rowblk_t, block_v, nb)
    perm = perm_t.reshape(-1).to(torch.int64)
    real = slot_t.reshape(-1) != 0
    live = mask[..., perm] & real
    sw = step * torch.where(real, w[perm], 0)
    cand = sat_add(keys[:, src], sw, inf)
    if hub is not None:
        hub_out = torch.zeros((p, n_out), dtype=torch.bool, device=hub.device)
        hub_out[:, :n] = hub
        cand = torch.where(hub_out[:, dst], cand & ~clear_bit, cand)
    return masked_segment_min(cand, dst, n_out, live, inf)[:, :n]


def group_width(group: int) -> int:
    """Columns a plane group takes in kernel A's tile and key copy: the
    power of two at or above `group`."""
    return 1 << max(group - 1, 0).bit_length()


def sweep_mode(block_v: int) -> str:
    """Kernel A's fold for blocks of `block_v` vertices: "tiled" (a tile
    in shared memory) up to SWEEP_MAX_BLOCK_V, "wide" (atomics into `out`
    in device memory) past it."""
    return "tiled" if block_v <= SWEEP_MAX_BLOCK_V else "wide"


def edge_relax_mode(block_v: int) -> str:
    """Kernel C's fold, by the same rule at EDGE_RELAX_MAX_BLOCK_V."""
    return "tiled" if block_v <= EDGE_RELAX_MAX_BLOCK_V else "wide"


def sweep_shared_bytes(group: int, block_v: int) -> int:
    """Dynamic shared memory of one kernel-A CTA for `group` planes: two
    staged chunks of the four index streams, then in the tiled mode the
    [block_v, group_width] int32 tile and one hub word per vertex of the
    block (the wide mode keeps neither)."""
    staged = 4 * 2 * 4 * SWEEP_CHUNK
    if sweep_mode(block_v) == "wide":
        return staged
    return staged + 4 * (block_v * group_width(group) + block_v)


def plane_group(p: int, block_v: int) -> int:
    """Planes per CTA of kernel A for P = `p` planes.

    The most that one warp's lanes and, in the tiled mode, the shared
    memory allow (at most 32; min(P, 32) in the wide mode), then evened
    out over the ceil(P / G) groups, so that P = 33 runs as groups of 17
    and 16 rather than 32 and 1.
    """
    p = max(p, 1)
    g = min(p, SWEEP_MAX_GROUP)
    while sweep_shared_bytes(g, block_v) > SWEEP_SHARED_BYTES:
        g -= 1
    groups = -(-p // g)
    return -(-p // groups)


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8
             + [ctypes.c_void_p])


def relax_sweep(keys: torch.Tensor, hub: torch.Tensor | None,
                src_t: torch.Tensor, dstloc_t: torch.Tensor,
                perm_t: torch.Tensor, slot_t: torch.Tensor,
                rowblk_t: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                step: int, inf: int, clear_bit: int, n: int, block_v: int,
                nb: int) -> torch.Tensor:
    """One sweep of all planes: keys [P, n] int32 → [P, n] int32.

    hub: bool [P, n] or None (no hub clear). Tiles: int32 [S, NR, BE],
    rowblk_t int32 [S, NR]. mask: bool [E2] shared by the planes, or
    [P, E2]. w: int32 [E2]. Keys and step·w must lie in [0, 2^31).
    """
    global launches
    p = keys.shape[0]
    e2 = w.shape[0]
    if keys.shape != (p, n) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [P, {n}], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if hub is not None and (hub.shape != keys.shape or hub.dtype != torch.bool):
        raise ValueError(f"hub must be bool {tuple(keys.shape)}, got "
                         f"{hub.dtype} {tuple(hub.shape)}")
    tiles = (src_t, dstloc_t, perm_t, slot_t)
    if any(t.shape != src_t.shape or t.dtype != torch.int32 for t in tiles) \
            or rowblk_t.shape != src_t.shape[:2] \
            or rowblk_t.dtype != torch.int32:
        raise ValueError("tile arrays must be int32 [S, NR, BE] with "
                         "rowblk_t int32 [S, NR]")
    if mask.dtype != torch.bool or mask.shape not in ((e2,), (p, e2)):
        raise ValueError(f"mask must be bool [{e2}] or [{p}, {e2}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if w.dtype != torch.int32 or w.dim() != 1:
        raise ValueError(f"w must be int32 [E2], got {w.dtype} "
                         f"{tuple(w.shape)}")
    args = (keys, hub, *tiles, rowblk_t, mask, w)
    if any(a is not None and a.device != keys.device for a in args):
        raise ValueError("all sweep tensors must be on one device")
    if keys.device.type == "cpu":
        return relax_sweep_plain(keys, hub, src_t, dstloc_t, perm_t, slot_t,
                                 rowblk_t, mask, w, step, inf, clear_bit, n,
                                 block_v, nb)
    if keys.device.type != "cuda":
        raise ValueError(f"no relax_sweep kernel for device {keys.device}")
    if any(a is not None and not a.is_contiguous() for a in args):
        raise ValueError("sweep tensors must be contiguous")
    group = plane_group(p, block_v)
    wide = sweep_mode(block_v) == "wide"
    s, nr, be = src_t.shape
    dev = keys.device
    groups = -(-p // group)
    # The kernel writes every entry of `out`. keys_t, mask_words and
    # hub_words are its scratch: each group's keys vertex-major, at least
    # four columns wide (a lane loads four planes at once), and a
    # per-plane mask and (in the wide mode) the hub as one bit per plane
    # [groups, E2] and [groups, n].
    out = torch.empty((p, n), dtype=torch.int32, device=dev)
    keys_t = torch.empty((groups, n, max(4, group_width(group))),
                         dtype=torch.int32, device=dev)
    per_plane = mask.dim() == 2
    mask_words = torch.empty((groups, e2) if per_plane else (0,),
                             dtype=torch.int32, device=dev)
    hub_words = torch.empty((groups, n) if wide and hub is not None
                            else (0,), dtype=torch.int32, device=dev)
    err = build.function("relax_sweep", "relax_sweep_launch", _ARGTYPES)(
        keys.data_ptr(), hub.data_ptr() if hub is not None else None,
        src_t.data_ptr(), dstloc_t.data_ptr(), perm_t.data_ptr(),
        slot_t.data_ptr(), rowblk_t.data_ptr(), mask.data_ptr(),
        int(per_plane), w.data_ptr(), out.data_ptr(), keys_t.data_ptr(),
        mask_words.data_ptr(), hub_words.data_ptr(), p, group,
        sweep_shared_bytes(group, block_v), int(wide), n, e2, s, nr, be,
        block_v, nb, step, inf, clear_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"relax_sweep kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def edge_relax_plain(keys: torch.Tensor, src_t: torch.Tensor,
                     dstloc_t: torch.Tensor, valid_t: torch.Tensor,
                     rowblk_t: torch.Tensor, step: int, n: int, block_v: int,
                     nb: int) -> torch.Tensor:
    """The plain PyTorch version of the legacy sweep, on the same tiles.

    Flattens the tiles to (src, global dst, valid) and takes one
    segment-min over the S·nb·block_v tiled outputs, cut to n: the rows of
    a chunked block fold in the same min.
    """
    n_out = src_t.shape[0] * nb * block_v
    src, dst = _flat_tiles(src_t, dstloc_t, rowblk_t, block_v, nb)
    s = keys[src] + step
    cand = torch.where(s < 0, INF32, s).clamp_max(INF32)
    return masked_segment_min(cand, dst, n_out, valid_t.reshape(-1) != 0,
                              INF32)[:n]


_EDGE_RELAX_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])


def edge_relax(keys: torch.Tensor, src_t: torch.Tensor,
               dstloc_t: torch.Tensor, valid_t: torch.Tensor,
               rowblk_t: torch.Tensor, step: int, n: int, block_v: int,
               nb: int) -> torch.Tensor:
    """The legacy sweep of one plane: keys int32 [n] → int32 [n].

    Tiles: int32 [S, NR, BE], rowblk_t int32 [S, NR]; `step` is an int32
    value. See the module doc for the function.
    """
    global launches_edge_relax
    if keys.shape != (n,) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{n}], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    tiles = (src_t, dstloc_t, valid_t)
    if src_t.dim() != 3 or any(t.shape != src_t.shape
                               or t.dtype != torch.int32 for t in tiles) \
            or rowblk_t.shape != src_t.shape[:2] \
            or rowblk_t.dtype != torch.int32:
        raise ValueError("tile arrays must be int32 [S, NR, BE] with "
                         "rowblk_t int32 [S, NR]")
    if not -2**31 <= step < 2**31:
        raise ValueError(f"step must be an int32 value, got {step}")
    if any(a.device != keys.device for a in (*tiles, rowblk_t)):
        raise ValueError("all edge_relax tensors must be on one device")
    if keys.device.type == "cpu":
        return edge_relax_plain(keys, src_t, dstloc_t, valid_t, rowblk_t,
                                step, n, block_v, nb)
    if keys.device.type != "cuda":
        raise ValueError(f"no edge_relax kernel for device {keys.device}")
    if any(not a.is_contiguous() for a in (keys, *tiles, rowblk_t)):
        raise ValueError("edge_relax tensors must be contiguous")
    s, nr, be = src_t.shape
    # The kernel writes every vertex: in the tiled mode one-row blocks
    # store their tile, chunked blocks are filled with INF32 first and
    # then min-folded; in the wide mode all of `out` is filled first.
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    err = build.function("edge_relax", "edge_relax_launch",
                         _EDGE_RELAX_ARGTYPES)(
        keys.data_ptr(), src_t.data_ptr(), dstloc_t.data_ptr(),
        valid_t.data_ptr(), rowblk_t.data_ptr(), out.data_ptr(), n, s * nr,
        nr, be, block_v, nb, step, int(edge_relax_mode(block_v) == "wide"),
        torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"edge_relax kernel launch failed: CUDA error {err}")
    launches_edge_relax += 1
    return out
