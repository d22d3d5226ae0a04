"""Edge cases of min-plus (kernel B) and the legacy edge relax (kernel C),
made from a seed with numpy.

Test support, not a test module: `tests/test_torch_cuda.py` and phase 2
of `chip_smoke.py` hold each CUDA kernel to its plain version on these
cases, and `tests/test_torch_minplus.py` / `tests/test_torch_edge_relax.py`
hold the plain versions to the JAX reference on them.

Min-plus: B in {0, 1, 31, 32, 33, 1024} at P = R = 32, rectangular H
(P < R, R not a multiple of 32, R past one 256-column tile), H of 64 KB
and of 1 MB (several staged chunks and column tiles), and rows of S, T
and H that are all INF32.

Edge relax: BE % 4 in {0, 1, 3} (the 16-byte and the 4-byte load
paths), chunked and sharded tilings with a short last shard, block_v of
16384, of kernel A's tiled-mode limit, of kernel C's own (the widest of
its tiled mode) and past it (58,113 and 131,072: its wide mode), keys
near INF32 and 2^31 - 1, all slots invalid and a graph with no slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.edge_relax import kernel, ops

INF32 = 1 << 29
STEPS = (1, 2, 4)


def _draw(rng, shape) -> np.ndarray:
    x = rng.integers(0, 64, shape).astype(np.int32)
    x[rng.random(shape) < 0.2] = INF32      # unreachable entries
    return x


MINPLUS_SHAPES = {
    "batch0": (0, 32, 32), "batch1": (1, 32, 32), "batch31": (31, 32, 32),
    "batch32": (32, 32, 32), "batch33": (33, 32, 32),
    "batch1024": (1024, 32, 32), "rect8x32": (64, 8, 32),
    "rect3x7": (5, 3, 7), "rect8x300": (33, 8, 300),
    "rect8x2048": (3, 8, 2048), "h64kb": (4, 128, 128),
    "h1mb": (5, 512, 512), "all-inf-rows": (40, 32, 32),
}


def minplus_names() -> list[str]:
    return list(MINPLUS_SHAPES)


def minplus_case(name: str):
    """(S [B, P], H [P, R], T [B, R]) int32 of case `name`."""
    b, p, r = MINPLUS_SHAPES[name]
    rng = np.random.default_rng(b * 1000 + p * 10 + r)
    s, h, t = _draw(rng, (b, p)), _draw(rng, (p, r)), _draw(rng, (b, r))
    if name == "all-inf-rows":
        s[:4] = INF32       # a query whose source reaches no landmark
        t[4:8] = INF32      # ... whose target reaches none
        h[0] = INF32
        h[:, 1] = INF32
    return s, h, t


@dataclasses.dataclass(frozen=True)
class EdgeRelaxInput:
    label: str
    src: np.ndarray      # int32 [E2]
    dst: np.ndarray      # int32 [E2]
    valid: np.ndarray    # bool [E2], baked into valid_t
    keys: np.ndarray     # int32 [n]
    n: int
    block_v: int
    shards: int
    block_e: int | None


def _slots(rng, n: int, m: int, p_valid: float = 0.8):
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return src, dst, rng.random(m) < p_valid


def _tilings(block_e):
    """n = 61, block_v 16, shards 1, 2 and 3 (3 leaves a short last
    shard) at one block_e."""
    rng = np.random.default_rng(7 if block_e is None else block_e)
    n = 61
    src, dst, valid = _slots(rng, n, 240)
    keys = rng.integers(0, 1 << 20, n).astype(np.int32)
    return [EdgeRelaxInput(f"shards={s}", src, dst, valid, keys, n, 16, s,
                           block_e) for s in (1, 2, 3)]


def _short_last_shard():
    """n = 24, block_v 8, shards 2, block_e 4: the last shard's lone block
    chunks into rows that exactly fill it."""
    n = 24
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = np.random.default_rng(0).integers(0, n, len(dst)).astype(np.int32)
    keys = np.arange(n, dtype=np.int32)[::-1].copy()
    return [EdgeRelaxInput("n=24", src, dst, np.ones(len(dst), bool), keys,
                           n, 8, 2, 4)]


def _wide(block_v: int):
    """One block_v, n = 1.5 block_v + 3 with 4n slots: a full block and a
    ragged one, unchunked and in rows of 4096 slots."""
    rng = np.random.default_rng(block_v)
    n = block_v + block_v // 2 + 3
    src, dst, valid = _slots(rng, n, 4 * n)
    keys = rng.integers(0, 1 << 20, n).astype(np.int32)
    return [EdgeRelaxInput(f"block_e={be}", src, dst, valid, keys, n,
                           block_v, 1, be) for be in (None, 4096)]


def _near_inf():
    rng = np.random.default_rng(31)
    n = 40
    src, dst, valid = _slots(rng, n, 160)
    keys = np.where(rng.random(n) < 0.5, 2**31 - 1 - rng.integers(0, 4, n),
                    INF32 - rng.integers(0, 4, n)).astype(np.int32)
    keys[:5] = rng.integers(0, 50, 5)
    return [EdgeRelaxInput("near INF32 and 2^31-1", src, dst, valid, keys,
                           n, 8, 2, 7)]


def _all_invalid():
    rng = np.random.default_rng(5)
    src, dst, _ = _slots(rng, 61, 240)
    keys = rng.integers(0, 1 << 20, 61).astype(np.int32)
    return [EdgeRelaxInput("all invalid", src, dst, np.zeros(240, bool),
                           keys, 61, 16, s, be)
            for s, be in ((1, None), (2, 7))]


def _zero_slots():
    empty = np.zeros(0, np.int32)
    return [EdgeRelaxInput("zero slots", empty, empty, np.zeros(0, bool),
                           np.arange(20, dtype=np.int32), 20, 8, 1, None)]


def edge_relax_names() -> list[str]:
    return (["be8", "be5", "be7", "unchunked", "short-last-shard",
             "block-v-16384", "block-v-sweep-max", "block-v-max",
             "near-inf", "all-invalid", "zero-slots", "block-v-58113",
             "block-v-131072"])


def edge_relax_case(name: str) -> list[EdgeRelaxInput]:
    """The inputs of case `name`; each runs at every step of STEPS."""
    if name.startswith("be"):
        return _tilings(int(name[2:]))   # BE % 4 == 0, 1, 3
    return {"unchunked": lambda: _tilings(None),
            "short-last-shard": _short_last_shard,
            "block-v-16384": lambda: _wide(16384),
            "block-v-sweep-max": lambda: _wide(kernel.SWEEP_MAX_BLOCK_V),
            "block-v-max": lambda: _wide(kernel.EDGE_RELAX_MAX_BLOCK_V),
            "near-inf": _near_inf, "all-invalid": _all_invalid,
            "zero-slots": _zero_slots,
            "block-v-58113": lambda: _wide(kernel.EDGE_RELAX_MAX_BLOCK_V + 1),
            "block-v-131072": lambda: _wide(1 << 17)}[name]()


def edge_relax_args(c: EdgeRelaxInput, step: int, device) -> tuple:
    """The arguments of `kernel.edge_relax` (and of its plain version)
    for case `c`, its tiling prepared by `ops.prepare` on `device`."""
    bg = ops.prepare(c.src, c.dst, c.valid, c.n, c.block_v, c.shards,
                     c.block_e, device=device)
    return (torch.from_numpy(c.keys).to(device), bg.src_t, bg.dstloc_t,
            bg.valid_t, bg.rowblk_t, step, c.n, bg.block_v, bg.nb)
