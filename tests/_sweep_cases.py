"""Edge cases of the relax sweep (kernel A), made from a seed with numpy.

Test support, not a test module: `tests/test_torch_cuda.py` and phase 2
of `chip_smoke.py` hold the CUDA kernel to its plain version on these
cases, and `tests/test_torch_sweep.py` holds the plain version to the JAX
reference on them. Each named case is a list of `SweepInput`s: a graph's
edge slots, the tiling to prepare them with (block_v, shards, block_e)
and one sweep's keys, hub, mask, weights and parameter set. They cover plane counts that are not a
multiple of the kernel's plane group, every `block_v` up to the largest
the first kernel took, chunked rows, shards, shared and per-plane masks
with E2 % 4 in {0, 2}, hub None and set, keys that saturate, an
all-masked sweep, a zero-capacity graph and n not a multiple of block_v.
The `wide-*` cases run the kernel's wide mode (block_v past
`kernel.SWEEP_MAX_BLOCK_V`): P in {1, 3, 33} at block_v 28,033 and
65,536, a one-block tiling (block_v 65,536 > n = 40) and a wide block
chunked over several rows on two shards. They stay out of the
PLANES × BLOCK_VS grid, whose P = 1024 would take 400 MB of keys there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.labelling import INF_KEY2, INF_KEY4
from repro_torch.graphs.coo import INF_D
from repro_torch.kernels.edge_relax import ops

PARAMS = ((1, INF_D, 0), (2, INF_KEY2, 1), (4, INF_KEY4, 2))
PLANES = (1, 3, 31, 32, 33, 100, 1024)
BLOCK_VS = (4, 16, 512, 2048, 12288)
BLOCK_ES = (None, 1, 7)
SHARDS = (1, 2, 3)
WIDE_PLANES = (1, 3, 33)
WIDE_BLOCK_VS = (28_033, 65_536)


@dataclasses.dataclass(frozen=True)
class SweepInput:
    label: str
    src: np.ndarray      # int32 [E2]
    dst: np.ndarray      # int32 [E2]
    keep: np.ndarray     # bool [E2]: the slots the tiling holds
    n: int
    block_v: int
    shards: int
    block_e: int | None
    keys: np.ndarray     # int32 [P, n]
    hub: np.ndarray | None  # bool [P, n]
    mask: np.ndarray     # bool [E2] or [P, E2]
    w: np.ndarray        # int32 [E2]
    step: int
    inf: int
    clear: int


def _graph(rng, n: int, m: int):
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = rng.random(m) < 0.8
    w = rng.integers(1, 9, m).astype(np.int32)
    return src, dst, keep, w


def _keys(rng, p: int, n: int, inf: int) -> np.ndarray:
    return rng.integers(0, inf, (p, n), endpoint=True).astype(np.int32)


def _planes_block_v(p: int, block_v: int, max_edges: int):
    """P planes at one block_v, n = 1.5 block_v + 3 (a ragged last block):
    hub and per-plane mask at the key2 parameters, then no hub and a
    shared mask at the BiBFS ones."""
    rng = np.random.default_rng(p * 7 + block_v)
    n = block_v + block_v // 2 + 3
    src, dst, keep, w = _graph(rng, n, min(4 * n, max_edges))
    masks = keep & (rng.random((p, len(src))) < 0.85)
    hub = rng.random((p, n)) < 0.3
    tiling = dict(src=src, dst=dst, keep=keep, n=n, block_v=block_v,
                  shards=1, block_e=None, w=w)
    return [
        SweepInput(label="hub, per-plane mask", keys=_keys(rng, p, n, INF_KEY2),
                   hub=hub, mask=masks, step=2, inf=INF_KEY2, clear=1,
                   **tiling),
        SweepInput(label="no hub, shared mask", keys=_keys(rng, p, n, INF_D),
                   hub=None, mask=masks[0], step=1, inf=INF_D, clear=0,
                   **tiling)]


def _rows(block_e: int | None, shards: int, p: int, block_v: int = 16,
          n: int = 61, m: int = 240):
    """Chunked rows and shards at P = 33 (two plane groups), or its first
    three planes (one group): every parameter set with hub None/set and
    mask shared/per-plane, then an empty mask. `m` edge slots over n
    vertices in blocks of `block_v`."""
    rng = np.random.default_rng(100 + 10 * (block_e or 0) + shards)
    src, dst, keep, w = _graph(rng, n, m)
    masks = (keep & (rng.random((33, len(src))) < 0.85))[:p]
    hub = (rng.random((33, n)) < 0.3)[:p]
    tiling = dict(src=src, dst=dst, keep=keep, n=n, block_v=block_v,
                  shards=shards, block_e=block_e, w=w)
    out = []
    for step, inf, clear in PARAMS:
        keys = _keys(rng, 33, n, inf)[:p]
        for h in (None, hub):
            for m in (masks[0], masks):
                out.append(SweepInput(
                    label=f"step={step} hub={h is not None} "
                          f"mask={m.shape}", keys=keys, hub=h, mask=m,
                    step=step, inf=inf, clear=clear, **tiling))
        out.append(SweepInput(label=f"step={step} empty mask", keys=keys,
                              hub=hub, mask=np.zeros_like(keep), step=step,
                              inf=inf, clear=clear, **tiling))
    return out


def _mask(per_plane: bool, e2_mod: int):
    """A shared or per-plane mask over E2 = 240 + e2_mod slots, P = 5,
    hub set, chunked rows over two shards, every parameter set."""
    rng = np.random.default_rng(200 + 2 * e2_mod + per_plane)
    n, p = 61, 5
    src, dst, keep, w = _graph(rng, n, 240 + e2_mod)
    masks = keep & (rng.random((p, len(src))) < 0.85)
    hub = rng.random((p, n)) < 0.3
    return [SweepInput(label=f"step={step}", src=src, dst=dst, keep=keep,
                       n=n, block_v=16, shards=2, block_e=7,
                       keys=_keys(rng, p, n, inf), hub=hub,
                       mask=masks if per_plane else masks[0], w=w,
                       step=step, inf=inf, clear=clear)
            for step, inf, clear in PARAMS]


def _near_inf():
    """Keys step·INF_D + step − 1 through w = INF_D edges: the sum passes
    2^31 at step 4 and must saturate, then hub-clear below inf. P = 1 (no
    transpose) and P = 3."""
    n = 6
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 2, 3, 4], np.int32)
    keep = np.ones(4, bool)
    out = []
    for p in (1, 3):
        hub = np.zeros((p, n), bool)
        hub[:, [1, 3]] = True
        hub[1:, 2] = True
        for step, inf, clear in PARAMS:
            keys = np.full((p, n), step * INF_D + step - 1, np.int32)
            keys[1:, 0] = 0
            out.append(SweepInput(
                label=f"P={p} step={step}", src=src, dst=dst, keep=keep,
                n=n, block_v=4, shards=1, block_e=None, keys=keys, hub=hub,
                mask=keep, w=np.full(4, INF_D, np.int32), step=step,
                inf=inf, clear=clear))
    return out


def _all_masked():
    rng = np.random.default_rng(300)
    n, p = 61, 33
    src, dst, keep, w = _graph(rng, n, 240)
    hub = rng.random((p, n)) < 0.3
    keys = _keys(rng, p, n, INF_KEY2)
    return [SweepInput(label=f"mask={m.shape}", src=src, dst=dst, keep=keep,
                       n=n, block_v=16, shards=2, block_e=7, keys=keys,
                       hub=hub, mask=m, w=w, step=2, inf=INF_KEY2, clear=1)
            for m in (np.zeros(len(src), bool), np.zeros((p, len(src)), bool))]


def _zero_capacity():
    """E2 = 0: every block holds one all-padding row."""
    rng = np.random.default_rng(400)
    n, p = 20, 3
    empty = np.zeros(0, np.int32)
    return [SweepInput(label=f"mask={m.shape}", src=empty, dst=empty,
                       keep=np.zeros(0, bool), n=n, block_v=8, shards=2,
                       block_e=None, keys=_keys(rng, p, n, INF_D),
                       hub=rng.random((p, n)) < 0.3, mask=m, w=empty,
                       step=1, inf=INF_D, clear=0)
            for m in (np.zeros(0, bool), np.zeros((p, 0), bool))]


def _short_last_shard():
    """n=24, block_v=8, shards=2, block_e=4: the last shard's lone block
    chunks into two rows that exactly fill it."""
    rng = np.random.default_rng(0)
    n = 24
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    keep = np.ones(len(dst), bool)
    return [SweepInput(label="P=2", src=src, dst=dst, keep=keep, n=n,
                       block_v=8, shards=2, block_e=4,
                       keys=rng.integers(0, 2 * n, (2, n)).astype(np.int32),
                       hub=None, mask=keep, w=np.ones(len(dst), np.int32),
                       step=1, inf=1 << 29, clear=0)]


def names() -> list[str]:
    """Every case name, in a fixed order."""
    return ([f"planes{p}-bv{bv}" for p in PLANES for bv in BLOCK_VS]
            + [f"rows-be{be}-s{s}-p{p}" for be in BLOCK_ES for s in SHARDS
               for p in (3, 33)]
            + [f"mask-{k}-e2mod{r}" for k in ("shared", "perplane")
               for r in (0, 2)]
            + ["near-inf", "all-masked", "zero-capacity",
               "short-last-shard"]
            + [f"wide-p{p}-bv{bv}" for p in WIDE_PLANES
               for bv in WIDE_BLOCK_VS]
            + ["wide-one-block-p33", "wide-rows-be7-s2-p33"])


def make(name: str, max_edges: int = 1 << 16) -> list[SweepInput]:
    """The sweeps of case `name`; `max_edges` caps the edge slots of the
    planes × block_v cases (a small cap keeps CPU runs short)."""
    if name.startswith("planes"):
        p, bv = name[len("planes"):].split("-bv")
        return _planes_block_v(int(p), int(bv), max_edges)
    if name.startswith("wide-p"):
        p, bv = name[len("wide-p"):].split("-bv")
        return _planes_block_v(int(p), int(bv), max_edges)
    if name == "wide-one-block-p33":
        return _rows(None, 1, 33, block_v=WIDE_BLOCK_VS[1], n=40, m=160)
    if name == "wide-rows-be7-s2-p33":
        # Two blocks of 28,033, one a shard, the second ragged; ~120 slots
        # a block in rows of 7.
        bv = WIDE_BLOCK_VS[0]
        return _rows(7, 2, 33, block_v=bv, n=2 * bv - 5)
    if name.startswith("rows"):
        be, s, p = name[len("rows-be"):].replace("-s", " ").replace(
            "-p", " ").split()
        return _rows(None if be == "None" else int(be), int(s), int(p))
    if name.startswith("mask"):
        _, kind, r = name.split("-")
        return _mask(kind == "perplane", int(r[len("e2mod"):]))
    return {"near-inf": _near_inf, "all-masked": _all_masked,
            "zero-capacity": _zero_capacity,
            "short-last-shard": _short_last_shard}[name]()


def sweep_args(c: SweepInput, device) -> tuple:
    """The arguments of `kernel.relax_sweep` (and of its plain version)
    for case `c`, its tiling prepared and its tensors on `device`."""
    bg = ops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                              c.shards, c.block_e, device=device)

    def t(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x)).to(device)
    return (t(c.keys), t(c.hub), bg.src_t, bg.dstloc_t, bg.perm_t,
            bg.slot_t, bg.rowblk_t, t(c.mask), t(c.w), c.step, c.inf,
            c.clear, c.n, bg.block_v, bg.nb)
