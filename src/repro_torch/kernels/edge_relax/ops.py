"""The prepared tiling (`BlockedGraph`) and the sweep over it.

`BlockedGraph` carries the destination-block tiling of a snapshot's
occupied edge slots, organised as `shards` contiguous vertex shards
(leading [S] axis; S=1 is the unsharded tiling), with rows of at most
`block_e` slots (`rowblk_t` names each row's destination block). The
tiling is purely topological — source, local destination, original slot
index — so per-sweep edge masks and weights, which churn with every batch,
are read through `perm_t` inside the sweep. It is rebuilt only when
insertions rewrite slots; `core/engine.py` owns that cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.edge_relax import kernel


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    src_t: torch.Tensor     # int32[S, NR, BE] source vertex per tile slot
    dstloc_t: torch.Tensor  # int32[S, NR, BE] destination local to the block
    perm_t: torch.Tensor    # int32[S, NR, BE] original edge-slot index
    slot_t: torch.Tensor    # int32[S, NR, BE] 1 on real slots, 0 on padding
    rowblk_t: torch.Tensor  # int32[S, NR] local destination block of each row
    n: int
    block_v: int
    nb: int                 # destination blocks per shard (NR >= nb)
    chunked: bool           # some destination block spans several tile rows

    @property
    def slots(self) -> int:
        """Tile slots S·NR·BE, padding included."""
        return self.src_t.numel()


def prepare_topology(src, dst, keep, n: int, block_v: int = 512,
                     shards: int = 1, block_e: int | None = None, *,
                     device: str | torch.device) -> BlockedGraph:
    """Tile the `keep` slots on the host and move the tiles to `device`.

    `keep` should be the currently-occupied slots: later deletions only
    flip validity (read per sweep), while insertions rewrite src/dst and
    force a fresh prepare. `chunked` is recorded from the pre-shard row
    count: post-shard shapes cannot tell a chunked tiling whose extra rows
    fill a short last shard from an unchunked one.
    """
    src_t, dstloc_t, perm_t, slot_t, rowblk, bv = kernel.block_edges_topology(
        np.asarray(src), np.asarray(dst), np.asarray(keep, bool), n, block_v,
        block_e)
    nb = -(-n // bv)
    chunked = len(rowblk) != nb
    rowblk_t, nb_loc, src_t, dstloc_t, perm_t, slot_t = kernel.shard_tiling(
        shards, nb, rowblk, src_t, dstloc_t, perm_t, slot_t)
    return BlockedGraph(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (src_t, dstloc_t, perm_t, slot_t, rowblk_t)),
        n, bv, nb_loc, chunked)


def relax_sweep(keys: torch.Tensor, bg: BlockedGraph,
                edge_mask: torch.Tensor, step: int, inf: int,
                w: torch.Tensor, clear_bit: int = 0,
                hub: torch.Tensor | None = None) -> torch.Tensor:
    """One wave of all planes `keys` [P, V] over the tiled graph.

    `edge_mask` ([E2] or [P, E2]) and the weights `w` ([E2]) are in
    original slot order; `hub` is a bool plane [P, V] or None.
    """
    return kernel.relax_sweep(keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t,
                              bg.slot_t, bg.rowblk_t, edge_mask, w, step, inf,
                              clear_bit, bg.n, bg.block_v, bg.nb)
