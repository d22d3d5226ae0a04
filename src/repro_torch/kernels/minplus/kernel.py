"""Min-plus contraction for the Eq.-3 query bound: CUDA kernel + plain twin.

    out[b] = min_{i,j} min(min(S[b,i] + H[i,j], INF32) + T[b,j], INF32)

`minplus` launches the hand-written kernel `csrc/minplus.cu` for CUDA
tensors and runs `minplus_plain`, the same function in plain PyTorch, for
CPU tensors; for any other device it raises. It replaces the Pallas
`_minplus_kernel` of `repro/kernels/minplus/kernel.py`, with the same
clamps at INF32 = 2^29 (the jnp query path clamps at INF_D instead; the
answers agree because `batched_query` maps everything >= INF_D to INF_D).
H may be rectangular [P, R] with S [B, P].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

INF32 = 1 << 29
MAX_SHARED_BYTES = 48 * 1024  # H lives in static-limit shared memory

#: Kernel launches since the count was last set to 0 (the CPU path and
#: `minplus_plain` do not count).
launches = 0


def minplus_plain(s: torch.Tensor, h: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: S [B,P], H [P,R], T [B,R] int32 → [B]."""
    mid = (s[:, :, None] + h[None, :, :]).clamp_max(INF32).amin(dim=1)
    return (mid + t).clamp_max(INF32).amin(dim=1)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def minplus(s: torch.Tensor, h: torch.Tensor, t: torch.Tensor
            ) -> torch.Tensor:
    """S [B,P], H [P,R], T [B,R] int32 → out [B] int32 (see module doc).

    Every input value must be <= INF32, as for the reference kernel.
    """
    global launches
    b, p = s.shape
    if h.shape[0] != p or t.shape != (b, h.shape[1]):
        raise ValueError(f"shape mismatch: S {tuple(s.shape)}, "
                         f"H {tuple(h.shape)}, T {tuple(t.shape)}")
    for name, x in (("S", s), ("H", h), ("T", t)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != s.device:
            raise ValueError(f"{name} is on {x.device}, S on {s.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if s.device.type == "cpu":
        return minplus_plain(s, h, t)
    if s.device.type != "cuda":
        raise ValueError(f"no minplus kernel for device {s.device}")
    r = h.shape[1]
    if p * r * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"H [{p}, {r}] exceeds {MAX_SHARED_BYTES} bytes "
                         "of shared memory")
    out = torch.empty(b, dtype=torch.int32, device=s.device)
    err = build.function("minplus", "minplus_launch", _ARGTYPES)(
        s.data_ptr(), h.data_ptr(), t.data_ptr(), out.data_ptr(), b, p, r,
        torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    launches += 1
    return out
