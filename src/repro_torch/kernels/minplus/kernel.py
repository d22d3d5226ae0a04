"""Min-plus contraction for the Eq.-3 query bound: CUDA kernel + plain twin.

    out[b] = min_{i,j} min(min(S[b,i] + H[i,j], INF32) + T[b,j], INF32)

`minplus` launches the hand-written kernel `csrc/minplus.cu` for CUDA
tensors and runs `minplus_plain`, the same function in plain PyTorch, for
CPU tensors; for any other device it raises. It replaces the Pallas
`_minplus_kernel` of `repro/kernels/minplus/kernel.py`, with the same
clamps at INF32 = 2^29 (the jnp query path clamps at INF_D instead; the
answers agree because `batched_query` maps everything >= INF_D to INF_D).
H may be rectangular [P, R] with S [B, P], of any size: the kernel
streams H through shared memory in chunks (`minplus_geometry`).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

INF32 = 1 << 29
MINPLUS_WARPS = 4                 # query rows per CTA, one warp each
MINPLUS_MAX_COLS = 8              # H columns a lane keeps in registers
MINPLUS_CHUNK_BYTES = 32 * 1024   # one staged chunk of H rows

#: Kernel launches since the count was last set to 0 (the CPU path and
#: `minplus_plain` do not count).
launches = 0


def minplus_plain(s: torch.Tensor, h: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: S [B,P], H [P,R], T [B,R] int32 → [B]."""
    mid = (s[:, :, None] + h[None, :, :]).clamp_max(INF32).amin(dim=1)
    return (mid + t).clamp_max(INF32).amin(dim=1)


@dataclasses.dataclass(frozen=True)
class MinplusGeometry:
    """Launch geometry of kernel B (`csrc/minplus.cu`) for one call."""
    warps: int       # query rows per CTA, one warp each
    cols: int        # H columns per lane: a column tile is 32·cols wide
    chunk_rows: int  # H rows per chunk staged in shared memory


def minplus_geometry(p: int, r: int) -> MinplusGeometry:
    """Kernel B's launch for S [B, p], H [p, r]: a warp per query row,
    MINPLUS_WARPS rows per CTA (ceil(B / MINPLUS_WARPS) CTAs); each lane
    keeps the power of two of columns (at most MINPLUS_MAX_COLS) that
    covers r, so a column tile spans r or 256 columns and wider H runs
    tile after tile; chunks of H rows fill at most MINPLUS_CHUNK_BYTES,
    in whole groups of 32 rows (one S load per group) unless P is
    smaller."""
    cols = 1
    while cols < MINPLUS_MAX_COLS and 32 * cols < r:
        cols *= 2
    rows = MINPLUS_CHUNK_BYTES // (4 * 32 * cols) // 32 * 32
    return MinplusGeometry(warps=MINPLUS_WARPS, cols=cols,
                           chunk_rows=max(1, min(p, rows)))


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    if p == 0 or h.shape[1] == 0:
        raise ValueError(f"H must have at least one row and column, got "
                         f"{tuple(h.shape)}")
    if s.device.type == "cpu":
        return minplus_plain(s, h, t)
    if s.device.type != "cuda":
        raise ValueError(f"no minplus kernel for device {s.device}")
    out = torch.empty(b, dtype=torch.int32, device=s.device)
    if b == 0:
        return out
    geo = minplus_geometry(p, h.shape[1])
    err = build.function("minplus", "minplus_launch", _ARGTYPES)(
        s.data_ptr(), h.data_ptr(), t.data_ptr(), out.data_ptr(), b, p,
        h.shape[1], geo.warps, geo.cols, geo.chunk_rows,
        torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    launches += 1
    return out
