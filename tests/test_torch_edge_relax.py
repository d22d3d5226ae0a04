"""The legacy edge relaxation of the PyTorch port against `repro`, bit for
bit.

Kernel C's plain version (`kernels/edge_relax/kernel.py:edge_relax_plain`,
what the wrapper runs for CPU tensors), the entry `ops.edge_relax` and the
COO oracle `ref.edge_relax` are held to the reference's Pallas
`edge_relax_pallas` (interpret mode) and its `ref.edge_relax`, over the
reference's shape grid, `block_e` None and 7, shards 1 and 2, an
all-invalid mask, a zero-slot graph and keys near 2^31 - 1. The tiles of
`ops.prepare`, `valid_t` included, equal the reference's. The edge cases
of `tests/_kernel_cases.py`, which the card runs against the kernel (its
wide mode among them, block_v 58,113 and 131,072), are held to the
reference's COO oracle through the wrapper and `ops.edge_relax`, and the
kernel's mode rule is checked on its own.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.edge_relax import kernel as jker
from repro.kernels.edge_relax import ops as jops
from repro.kernels.edge_relax import ref as jref
from repro_torch.kernels.edge_relax import kernel as tker
from repro_torch.kernels.edge_relax import ops as tops
from repro_torch.kernels.edge_relax import ref as tref

import _kernel_cases as kcases

INF32 = 1 << 29
FIELDS = ("src_t", "dstloc_t", "valid_t", "perm_t", "slot_t", "rowblk_t")


def _slots(n, e, seed, p_valid=0.8):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < p_valid
    keys = rng.integers(0, 1 << 20, n).astype(np.int32)
    return src, dst, valid, keys


def _jax_pallas(keys, jbg, step):
    """The reference kernel (interpret mode) on the reference's tiles."""
    return np.asarray(jker.edge_relax_pallas(
        jnp.asarray(keys), jbg.src_t, jbg.dstloc_t, jbg.valid_t, step,
        jbg.n, jbg.block_v, interpret=True,
        rowblk_t=jbg.rowblk_t if jbg.chunked else None, nb=jbg.nb))


def _check(src, dst, valid, keys, n, step, block_v, shards=1,
           block_e=None):
    jbg = jops.prepare(src, dst, valid, n, block_v, shards, block_e)
    tbg = tops.prepare(src, dst, valid, n, block_v, shards, block_e,
                       device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tbg, f).numpy(),
                                      np.asarray(getattr(jbg, f)), err_msg=f)
    assert (tbg.n, tbg.block_v, tbg.nb, tbg.chunked) == \
        (jbg.n, jbg.block_v, jbg.nb, jbg.chunked)
    got = tops.edge_relax(torch.from_numpy(keys), tbg, step).numpy()
    np.testing.assert_array_equal(got, _jax_pallas(keys, jbg, step))
    want = np.asarray(jref.edge_relax(jnp.asarray(keys), jnp.asarray(src),
                                      jnp.asarray(dst), jnp.asarray(valid),
                                      step, n))
    np.testing.assert_array_equal(got, want)
    coo = tref.edge_relax(torch.from_numpy(keys), torch.from_numpy(src),
                          torch.from_numpy(dst), torch.from_numpy(valid),
                          step, n).numpy()
    np.testing.assert_array_equal(coo, want)
    return got


@pytest.mark.parametrize("n,e,bv", [(16, 40, 8), (300, 1200, 64),
                                    (1000, 5000, 128), (77, 200, 32)])
def test_edge_relax_shapes(n, e, bv):
    """The reference's shape grid (tests/test_kernels.py), step 2."""
    src, dst, valid, keys = _slots(n, e, n + e)
    _check(src, dst, valid, keys, n, 2, bv)


@pytest.mark.parametrize("block_e", [None, 7])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("step", [1, 2, 4])
def test_edge_relax_chunked_and_sharded(block_e, shards, step):
    """Ragged n = 61 with block_v 16: chunked and unchunked tilings, one
    and two shards."""
    src, dst, valid, keys = _slots(61, 240, 17 + step)
    got = _check(src, dst, valid, keys, 61, step, 16, shards, block_e)
    bg = tops.prepare(src, dst, valid, 61, 16, shards, block_e,
                      device="cpu")
    assert bg.chunked == (block_e is not None)
    # The plain version itself, called through the wrapper's arguments.
    np.testing.assert_array_equal(
        tker.edge_relax_plain(torch.from_numpy(keys), bg.src_t, bg.dstloc_t,
                              bg.valid_t, bg.rowblk_t, step, 61, 16,
                              bg.nb).numpy(), got)


def test_edge_relax_short_last_shard():
    """n=24, block_v=8, shards=2, block_e=4: the last shard's lone block
    chunks into rows that exactly fill it; its rows must still fold."""
    n = 24
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = np.random.default_rng(0).integers(0, n, len(dst)).astype(np.int32)
    valid = np.ones(len(dst), bool)
    keys = np.arange(n, dtype=np.int32)[::-1].copy()
    _check(src, dst, valid, keys, n, 1, 8, 2, 4)
    assert tops.prepare(src, dst, valid, n, 8, 2, 4, device="cpu").chunked


def test_edge_relax_all_invalid():
    src, dst, _, keys = _slots(61, 240, 5)
    got = _check(src, dst, np.zeros(240, bool), keys, 61, 1, 16, 2, 7)
    np.testing.assert_array_equal(got, np.full(61, INF32))


def test_edge_relax_zero_slots():
    """A zero-capacity graph: all-padding tiles, an all-INF32 output."""
    empty = np.zeros(0, np.int32)
    keys = np.arange(20, dtype=np.int32)
    got = _check(empty, empty, np.zeros(0, bool), keys, 20, 1, 8)
    np.testing.assert_array_equal(got, np.full(20, INF32))


@pytest.mark.parametrize("step", [1, 2, 4])
def test_edge_relax_keys_near_int32_max(step):
    """Keys near INF32 and near 2^31 - 1: the int32 sum wraps negative in
    the reference and saturates to INF32; near INF32 it clamps."""
    n, e = 40, 160
    src, dst, valid, _ = _slots(n, e, 31)
    rng = np.random.default_rng(32)
    keys = np.where(rng.random(n) < 0.5,
                    2**31 - 1 - rng.integers(0, 4, n),
                    INF32 - rng.integers(0, 4, n)).astype(np.int32)
    keys[:5] = rng.integers(0, 50, 5)
    got = _check(src, dst, valid, keys, n, step, 8, 2, 7)
    assert ((got >= 0) & (got <= INF32)).all()


def test_prepare_topology_valid_is_occupancy():
    """prepare_topology's valid_t is its slot_t, the same tensor."""
    src, dst, valid, _ = _slots(61, 240, 9)
    bg = tops.prepare_topology(src, dst, valid, 61, 16, 2, 7, device="cpu")
    assert bg.valid_t is bg.slot_t
    jbg = jops.prepare_topology(src, dst, valid, 61, 16, 2, 7)
    np.testing.assert_array_equal(bg.valid_t.numpy(),
                                  np.asarray(jbg.valid_t))


def test_edge_relax_rejects_bad_arguments():
    src, dst, valid, keys = _slots(16, 40, 1)
    bg = tops.prepare(src, dst, valid, 16, 8, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        tops.edge_relax(torch.from_numpy(keys[:8]), bg, 1)
    with pytest.raises(ValueError, match="step"):
        tops.edge_relax(torch.from_numpy(keys), bg, 2**31)
    with pytest.raises(ValueError, match="tile"):
        tker.edge_relax(torch.from_numpy(keys), bg.src_t, bg.dstloc_t,
                        bg.valid_t.to(torch.int64), bg.rowblk_t, 1, 16, 8,
                        bg.nb)


@pytest.mark.parametrize("name", kcases.edge_relax_names())
def test_edge_relax_plain_on_kernel_cases(name):
    for c in kcases.edge_relax_case(name):
        bg = tops.prepare(c.src, c.dst, c.valid, c.n, c.block_v, c.shards,
                          c.block_e, device="cpu")
        for step in kcases.STEPS:
            args = kcases.edge_relax_args(c, step, "cpu")
            got = tker.edge_relax(*args).numpy()
            want = np.asarray(jref.edge_relax(
                jnp.asarray(c.keys), jnp.asarray(c.src), jnp.asarray(c.dst),
                jnp.asarray(c.valid), step, c.n))
            np.testing.assert_array_equal(got, want, err_msg=c.label)
            np.testing.assert_array_equal(
                tops.edge_relax(args[0], bg, step).numpy(), want,
                err_msg=f"ops.edge_relax: {c.label}")


@pytest.mark.parametrize("block_v,mode", [
    (8, "tiled"), (tker.SWEEP_MAX_BLOCK_V + 1, "tiled"),
    (tker.EDGE_RELAX_MAX_BLOCK_V, "tiled"),
    (tker.EDGE_RELAX_MAX_BLOCK_V + 1, "wide"), (1 << 20, "wide")])
def test_edge_relax_mode_rule(block_v, mode):
    """Kernel C folds in its shared tile up to EDGE_RELAX_MAX_BLOCK_V
    (one int32 a vertex in 232,448 bytes) and in device memory past it."""
    assert tker.EDGE_RELAX_MAX_BLOCK_V == tker.SWEEP_SHARED_BYTES // 4
    assert tker.edge_relax_mode(block_v) == mode
