"""The COO oracle of the legacy edge relaxation (`kernel.edge_relax`).

A third witness beside the tiled plain version and the CUDA kernel: it
reads the untiled slot arrays, so it shares no tiling code with either.
"""
from __future__ import annotations

import torch

INF32 = 1 << 29


def edge_relax(keys: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               valid: torch.Tensor, step: int, n: int,
               w: torch.Tensor | None = None) -> torch.Tensor:
    """cand[v] = min over valid slots (u, v) of keys[u] + step·w; INF32 if
    none.

    The add is int32 and wraps, as in the reference; a negative sum (a
    wrapped one, for the non-negative keys the system holds) becomes
    INF32, then every candidate is clamped at INF32.
    """
    sw = step if w is None else step * w
    s = keys[src.to(torch.int64)] + sw
    cand = torch.where(s < 0, INF32, s).clamp_max(INF32)
    cand = torch.where(valid, cand, INF32)
    out = torch.full((n,), INF32, dtype=torch.int32, device=keys.device)
    return out.scatter_reduce_(0, dst.to(torch.int64), cand, "amin")
