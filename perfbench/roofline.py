"""The yardstick of kernel A (the relax sweep): the bytes a wave needs.

A wave relaxes every masked edge of the graph for P planes of keys
[P, V] int32. What it has to move, whatever the kernel reads again or
pads, is counted from the snapshot's live edges, the keys and the masks
alone, never from the program's tiling (a retiling would then move the
yardstick):

* the keys, read once and written once: 2 · P · V · 4 bytes;
* the hub plane, bool [P, V], where the wave clears hub bits;
* each live directed edge's src and dst once: 8 bytes;
* its mask: 1 byte, or P bytes for a mask of each plane;
* the weight of each edge that some plane lets through: 4 bytes.

The least time of the wave is those bytes over the card's memory
bandwidth; the wave's operations (an add, a saturate, a hub clear and a
min per plane and edge) take less at the rates below.
"""
from __future__ import annotations

import torch

#: One NVIDIA H100 SXM (NVIDIA's data sheet; at its 700 W limit).
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def wave_bytes(planes: int, n: int, live: int, *, hub: bool,
               mask_planes: int = 1, used: int | None = None) -> int:
    """Bytes one wave needs: `planes` key planes over `n` vertices,
    `live` live directed edges; `hub` whether the wave reads a hub plane;
    `mask_planes` 1 for a mask shared by the planes, P for one mask each;
    `used` the live edges some plane lets through (default: all)."""
    used = live if used is None else used
    return (2 * planes * n * 4 + (planes * n if hub else 0) + live * 8
            + live * mask_planes + used * 4)


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]


def repair_masks_used(valid: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, aff: torch.Tensor,
                      chunk: int = 8) -> tuple[int, int]:
    """For a BatchHL repair over the slots (valid, src, dst) of G' with
    the affected planes `aff` [R, V]: how many live edges some plane lets
    through as a boundary edge (source unaffected, destination affected)
    and as an interior edge (both affected). Plane chunks keep the
    [chunk, E2] temporaries small."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    bou = torch.zeros_like(valid)
    inner = torch.zeros_like(valid)
    for lo in range(0, aff.shape[0], chunk):
        a = aff[lo:lo + chunk]
        s_aff, d_aff = a[:, src], a[:, dst]
        bou |= (~s_aff & d_aff).any(0)
        inner |= (s_aff & d_aff).any(0)
    return int((bou & valid).sum()), int((inner & valid).sum())
