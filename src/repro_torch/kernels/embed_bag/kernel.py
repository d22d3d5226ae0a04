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
never reads outside the table. Its launch comes from
`embed_bag_geometry`, a pure function of the shapes and the SM count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

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


#: Row loads a lane issues before its FMAs (`kUnroll` in the source).
EMBED_BAG_UNROLL = 4
#: Warps the launch aims to keep on each SM before it splits bags.
EMBED_BAG_WARPS_PER_SM = 16
#: Warps a CTA holds (`kMaxThreads` / 32 in the source), and so the most
#: warps one bag is split over.
EMBED_BAG_CTA_WARPS = 8


@dataclasses.dataclass(frozen=True)
class EmbedBagGeometry:
    """Launch geometry of kernel D (`csrc/embed_bag.cu`) for one call."""
    vec: int       # floats per column load: 4 (float4) or 1
    lanes: int     # lanes per slot group: the group reads one row
    groups: int    # slot groups per warp (32 // lanes)
    warps: int     # warps per bag
    bags: int      # bags per CTA
    per_warp: int  # bag slots per warp

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.bags

    @property
    def smem_bytes(self) -> int:
        """Shared memory per CTA: one partial row tile per warp of a split
        bag, none when a warp takes a whole bag."""
        if self.warps == 1:
            return 0
        return self.warps * self.bags * self.lanes * self.vec * 4

    def grid(self, b: int) -> int:
        return -(-b // self.bags)


@functools.lru_cache(maxsize=256)
def embed_bag_geometry(b: int, l: int, d: int, sm_count: int,
                       aligned: bool = True) -> EmbedBagGeometry:
    """Kernel D's launch for B bags of L slots over a [N, D] table on a
    card of `sm_count` SMs.

    Columns go as float4 when D % 4 == 0 and the pointers are 16-byte
    `aligned`. A slot group is the power of two of lanes that covers the
    D / vec columns, at most 32 (wider rows take column tiles), so a warp
    serves 32 // lanes slots at once. Where B bags are fewer than
    EMBED_BAG_WARPS_PER_SM warps on each SM, a bag is split over as many
    warps as it takes to reach that count, at most EMBED_BAG_CTA_WARPS
    and no more than the bag's slots fill (each warp at least one slot a
    group); otherwise a warp takes a bag. Bags fill a CTA of up to
    EMBED_BAG_CTA_WARPS warps.
    """
    vec = 4 if aligned and d % 4 == 0 else 1
    cols = d // vec
    lanes = 1
    while lanes < min(cols, 32):
        lanes *= 2
    groups = 32 // lanes
    target = sm_count * EMBED_BAG_WARPS_PER_SM
    warps = 1
    if b < target:
        warps = max(1, min(EMBED_BAG_CTA_WARPS, -(-target // max(b, 1)),
                           -(-l // groups)))
    per_warp = max(1, -(-l // warps))
    warps = max(1, -(-l // per_warp))       # no warp without a slot
    return EmbedBagGeometry(vec=vec, lanes=lanes, groups=groups, warps=warps,
                            bags=max(1, EMBED_BAG_CTA_WARPS // warps),
                            per_warp=per_warp)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


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
    geo = embed_bag_geometry(b, l, d, build.sm_count(table.device.index),
                             table.data_ptr() % 16 == 0)
    err = build.function("embed_bag", "embed_bag_launch", _ARGTYPES)(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), n, d,
        b, l, geo.vec, geo.lanes, geo.groups, geo.warps, geo.bags,
        geo.per_warp, torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embed_bag kernel launch failed: CUDA error {err}")
    launches += 1
    return out
