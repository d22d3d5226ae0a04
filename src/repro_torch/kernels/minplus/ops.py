"""The public entry of the Eq.-3 query bound: kernel B or its plain twin."""
from __future__ import annotations

import torch

from repro_torch.kernels.minplus import kernel


def minplus_bound(s: torch.Tensor, h: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """Eq.-3 upper bound for a query batch: S [B,P], H [P,R], T [B,R] → [B]
    int32.

    P = R is the full bound; P < R contracts a shard-local highway-row
    slice (`core/shard.py` finishes it with a min over the shards). The
    inputs are cast to int32 and go through `kernel.minplus`: the CUDA
    kernel for CUDA tensors, `minplus_plain` for CPU tensors.
    """
    return kernel.minplus(s.to(torch.int32), h.to(torch.int32),
                          t.to(torch.int32))
