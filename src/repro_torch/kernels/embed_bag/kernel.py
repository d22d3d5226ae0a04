"""Embedding bag: the CUDA kernel's wrapper and its plain twin.

    out[b, :] = Σ_l w[b, l] · table[idx[b, l], :]    in float32

`embed_bag` launches the hand-written kernel `csrc/embed_bag.cu` for CUDA
tensors and runs `embed_bag_plain` for CPU tensors; any other device
raises. They replace the Pallas `_embed_bag_kernel` of
`repro/kernels/embed_bag/kernel.py`. A table of another float type is
cast to float32 first, as there.

Indices follow the reference's gather (`repro_torch.gather.take_rows`):
-N ≤ idx < 0 wraps to idx + N, and any other index outside [0, N)
contributes a NaN row (so out[b] is NaN whatever its weight). The kernel
never reads outside the table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.gather import take_rows
from repro_torch.kernels import build

#: Kernel launches since the count was last set to 0 (the CPU path and
#: `embed_bag_plain` do not count).
launches = 0


def embed_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather the rows, contract the bag axis."""
    rows = take_rows(table.to(torch.float32), idx)   # [B, L, D]
    return torch.einsum("bl,bld->bd", w.to(torch.float32), rows)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def embed_bag(table: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """table [N, D] float, idx [B, L] int32, w [B, L] float32 → [B, D]
    float32 (see the module doc)."""
    global launches
    if table.dim() != 2 or not table.dtype.is_floating_point:
        raise ValueError(f"table must be a float [N, D], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 [B, L], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if w.shape != idx.shape or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 {tuple(idx.shape)}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if idx.device != table.device or w.device != table.device:
        raise ValueError("table, idx and w must be on one device")
    if table.device.type == "cpu":
        return embed_bag_plain(table, idx, w)
    if table.device.type != "cuda":
        raise ValueError(f"no embed_bag kernel for device {table.device}")
    table = table.to(torch.float32)
    if any(not a.is_contiguous() for a in (table, idx, w)):
        raise ValueError("embed_bag tensors must be contiguous")
    (n, d), (b, l) = table.shape, idx.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    err = build.function("embed_bag", "embed_bag_launch", _ARGTYPES)(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), n, d,
        b, l, torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embed_bag kernel launch failed: CUDA error {err}")
    launches += 1
    return out
