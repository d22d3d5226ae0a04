"""The slot side of BatchHL's seed weights: CUDA kernel + plain twin.

For a graph's slots src, dst, w (int32 [E2]), valid (bool [E2]) and U row
keys sorted ascending (int64 [U], U >= 1, repeats allowed):

    acc[p] = max(0, max{w[e] : valid[e], slot_key(src[e], dst[e]) == keys[p]})

at the first sorted position p of each key; every other entry of acc
(int32 [U]) is 0. `seed_match` launches the hand-written kernel
`csrc/seed_match.cu` for CUDA tensors and runs `seed_match_plain`, the same
function in plain PyTorch, for CPU tensors; for any other device it raises.
It replaces no Pallas kernel: the reference does the match in jnp
(`repro/graphs/coo.py:resolve_seed_weights`).

`slot_key` is the one definition of the int64 key that matches batch rows
to slots, in two kinds (`KEYS`): "pair", the undirected pair (min, max),
and "arc", the exact arc (src, dst) of `core/directed.py`. The kernel
computes the same signed int64 arithmetic. The launch comes from
`seed_match_geometry`, a pure function of U, E2, the SM count and the
alignment.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

#: The kinds of key, in the order the kernel numbers them.
KEYS = ("pair", "arc")
#: Threads a CTA (`kThreads` in the source).
SEED_MATCH_THREADS = 256
#: CTAs an SM keeps at most (the `__launch_bounds__` minimum in the source).
SEED_MATCH_CTAS_PER_SM = 4
#: Dynamic shared memory one CTA may opt in to, and an SM's shared memory,
#: of which the runtime keeps 1 KB a CTA (H100).
SEED_MATCH_CTA_SHARED = 232_448
SEED_MATCH_SM_SHARED = 233_472
SEED_MATCH_CTA_RESERVED = 1024
#: The row keys' filter in shared memory: 2^18 bits (`kFilterBits`).
SEED_MATCH_FILTER_BYTES = (1 << 18) // 8
#: The most row keys staged in shared memory beside the filter (24,960);
#: more are searched in device memory.
SEED_MATCH_MAX_SHARED_KEYS = (SEED_MATCH_CTA_SHARED
                              - SEED_MATCH_FILTER_BYTES) // 8

#: Kernel launches since the count was last set to 0 (the CPU path and
#: `seed_match_plain` do not count).
launches = 0


def slot_key(a: torch.Tensor, b: torch.Tensor, key: str,
             keep: torch.Tensor | None = None) -> torch.Tensor:
    """int64 key of each (a, b): lo * 2^32 + hi, with (lo, hi) = (min,
    max) for `key` "pair" and (a, b) for "arc"; (-1, -1) off `keep`.

    Injective over all int32 pairs: hi spans 2^32 values under lo·2^32.
    """
    if key == "pair":
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    elif key == "arc":
        lo, hi = a, b
    else:
        raise ValueError(f"key must be one of {KEYS}, got {key!r}")
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    if keep is not None:
        lo = torch.where(keep, lo, -1)
        hi = torch.where(keep, hi, -1)
    return lo * (1 << 32) + hi


def seed_match_plain(src: torch.Tensor, dst: torch.Tensor,
                     valid: torch.Tensor, w: torch.Tensor,
                     sorted_keys: torch.Tensor, key: str) -> torch.Tensor:
    """The plain PyTorch version (see the module doc): int32 [U]. Unmatched
    slots fold into a scratch bin U, cut away."""
    u = sorted_keys.shape[0]
    g_key = slot_key(src, dst, key)
    pos = torch.searchsorted(sorted_keys, g_key).clamp_max(u - 1)
    m = (sorted_keys[pos] == g_key) & valid
    # Max live weight per distinct key, at the key's first sorted position.
    acc = torch.zeros(u + 1, dtype=torch.int32, device=src.device)
    acc.scatter_reduce_(0, torch.where(m, pos, u), w, "amax")
    return acc[:u]


@dataclasses.dataclass(frozen=True)
class SeedMatchGeometry:
    """Launch geometry of `csrc/seed_match.cu` for one call."""
    shared_keys: bool  # the sorted keys staged in shared memory
    smem_bytes: int    # dynamic shared memory a CTA: the filter, the keys
    blocks: int        # CTAs of the grid-stride loop
    vec: bool          # four slots a load (src and dst 16-byte aligned)


def seed_match_geometry(u: int, e2: int, sm_count: int,
                        aligned: bool = True) -> SeedMatchGeometry:
    """The launch for U sorted keys over E2 slots on a card of `sm_count`
    SMs: beside the 32 KB filter, the keys go in shared memory up to
    SEED_MATCH_MAX_SHARED_KEYS (8 KB at U = 1,024), else they are searched
    in device memory; as many CTAs as the SMs keep at once (at most
    SEED_MATCH_CTAS_PER_SM an SM, fewer where the keys fill the SM's
    shared memory), and no more than the slots need, one group of four
    slots a thread (one slot unaligned).
    """
    shared = u <= SEED_MATCH_MAX_SHARED_KEYS
    smem = SEED_MATCH_FILTER_BYTES + (8 * u if shared else 0)
    per_sm = min(SEED_MATCH_CTAS_PER_SM,
                 SEED_MATCH_SM_SHARED // (smem + SEED_MATCH_CTA_RESERVED))
    items = e2 // 4 if aligned else e2
    need = -(-items // SEED_MATCH_THREADS)
    return SeedMatchGeometry(shared_keys=shared, smem_bytes=smem,
                             blocks=max(1, min(sm_count * per_sm, need)),
                             vec=aligned)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def seed_match(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               w: torch.Tensor, sorted_keys: torch.Tensor,
               key: str) -> torch.Tensor:
    """Slots src, dst, w int32 [E2], valid bool [E2], keys int64 [U]
    sorted → acc int32 [U] (see the module doc).

    The key kind is checked first, on any device: the kernel never meets
    a key it cannot compute.
    """
    global launches
    if key not in KEYS:
        raise ValueError(f"key must be one of {KEYS}, got {key!r}")
    e2 = src.shape[0]
    for name, x, dtype in (("src", src, torch.int32),
                           ("dst", dst, torch.int32),
                           ("valid", valid, torch.bool),
                           ("w", w, torch.int32)):
        if x.dtype != dtype or x.shape != (e2,):
            raise ValueError(f"{name} must be {dtype} [{e2}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != src.device:
            raise ValueError(f"{name} is on {x.device}, src on {src.device}")
    u = sorted_keys.shape[0]
    if sorted_keys.dtype != torch.int64 or sorted_keys.dim() != 1 or u == 0:
        raise ValueError(f"sorted_keys must be int64 [U], U >= 1, got "
                         f"{sorted_keys.dtype} {tuple(sorted_keys.shape)}")
    if sorted_keys.device != src.device:
        raise ValueError(f"sorted_keys is on {sorted_keys.device}, src on "
                         f"{src.device}")
    if src.device.type == "cpu":
        return seed_match_plain(src, dst, valid, w, sorted_keys, key)
    if src.device.type != "cuda":
        raise ValueError(f"no seed_match kernel for device {src.device}")
    if any(not x.is_contiguous() for x in (src, dst, valid, w, sorted_keys)):
        raise ValueError("seed_match tensors must be contiguous")
    acc = torch.zeros(u, dtype=torch.int32, device=src.device)
    geo = seed_match_geometry(
        u, e2, build.sm_count(src.device.index),
        src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0)
    err = build.function("seed_match", "seed_match_launch", _ARGTYPES)(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), w.data_ptr(), e2,
        int(geo.vec), sorted_keys.data_ptr(), u, KEYS.index(key),
        int(geo.shared_keys), geo.blocks, geo.smem_bytes, acc.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seed_match kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return acc
