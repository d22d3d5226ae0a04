"""The embedding bag of the PyTorch port against `repro`.

Kernel D's plain version (`kernels/embed_bag/kernel.py:embed_bag_plain`,
what the wrapper runs for CPU tensors) and the entry `ops.embed_bag` are
held to the reference's Pallas `embed_bag_pallas` (interpret mode), its
`ref.embed_bag` and its `ops.embed_bag`, over the reference's shape grid
with float32 and float16 tables, sum and mean, with and without a mask,
and the wrapped (-1, -N) and NaN (N, -N-1) index cases. Kernel D's
launch geometry (`embed_bag_geometry`), which only the card runs, is
checked here against a mirror of the kernel's index arithmetic.

Tolerance: the sums are float32 in another order than the reference's,
so rtol = atol = 1e-5 for float32 tables; for float16 tables the
reference's own 2e-3 (`tests/test_kernels.py`).
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embed_bag import kernel as jker
from repro.kernels.embed_bag import ops as jops
from repro.kernels.embed_bag import ref as jref
from repro_torch.kernels.embed_bag import kernel as tker
from repro_torch.kernels.embed_bag import ops as tops

GRID = [(100, 8, 16, 3), (500, 64, 100, 7), (50, 128, 130, 20),
        (1000, 32, 64, 50)]


def _tol(dtype):
    return 1e-5 if dtype == np.float32 else 2e-3


def _inputs(n, d, b, l, dtype, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(dtype)
    idx = rng.integers(0, n, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    mask = rng.random((b, l)) < 0.6
    return table, idx, w, mask


@pytest.mark.parametrize("n,d,b,l", GRID)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_embed_bag_kernel_shapes(n, d, b, l, dtype):
    table, idx, w, _ = _inputs(n, d, b, l, dtype, n + d)
    got = tker.embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, d)
    tol = _tol(dtype)
    for want in (jker.embed_bag_pallas(jnp.asarray(table), jnp.asarray(idx),
                                       jnp.asarray(w), interpret=True),
                 jref.embed_bag(jnp.asarray(table), jnp.asarray(idx),
                                jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,b,l", GRID)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embed_bag_ops(n, d, b, l, dtype, mode, masked):
    table, idx, _, mask = _inputs(n, d, b, l, dtype, 7 * n + d)
    got = tops.embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(mask) if masked else None,
                         mode=mode).numpy()
    want = jops.embed_bag(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(mask) if masked else None, mode=mode,
                          use_pallas=False)
    tol = _tol(dtype)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_embed_bag_ops_masked_mean_matches_pallas():
    """The reference's masked-mean case through its Pallas path."""
    table, idx, _, mask = _inputs(50, 8, 10, 5, np.float32, 0)
    got = tops.embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(mask), mode="mean").numpy()
    want = jops.embed_bag(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(mask), mode="mean", use_pallas=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_embed_bag_index_wrap_and_nan():
    """-1 and -N wrap to rows N-1 and 0; N and -N-1 give NaN rows, even
    at weight 0, as the reference's gather does."""
    n, d = 5, 3
    table = np.arange(n * d, dtype=np.float32).reshape(n, d)
    idx = np.array([[-1, 0], [n, 0], [-n, 1], [-n - 1, 2], [2, n + 3]],
                   np.int32)
    w = np.array([[1.0, 0.5], [0.0, 1.0], [1.0, 1.0], [0.0, 1.0],
                  [1.0, 0.0]], np.float32)
    got = tker.embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(w)).numpy()
    for want in (jker.embed_bag_pallas(jnp.asarray(table), jnp.asarray(idx),
                                       jnp.asarray(w), interpret=True),
                 jref.embed_bag(jnp.asarray(table), jnp.asarray(idx),
                                jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
    assert np.isnan(got[[1, 3, 4]]).all() and not np.isnan(got[[0, 2]]).any()
    np.testing.assert_array_equal(got[0], table[n - 1] + 0.5 * table[0])


def test_embed_bag_rejects_bad_arguments():
    table, idx, w, _ = _inputs(20, 4, 3, 2, np.float32, 1)
    t, i, ww = map(torch.from_numpy, (table, idx, w))
    with pytest.raises(ValueError, match="idx"):
        tker.embed_bag(t, i.to(torch.int64), ww)
    with pytest.raises(ValueError, match="w must"):
        tker.embed_bag(t, i, ww[:, :1])
    with pytest.raises(ValueError, match="mode"):
        tops.embed_bag(t, i, mode="max")


# --- kernel D's launch geometry ---------------------------------------------

SMS = 132                # H100 SXM
SMEM_LIMIT = 232_448     # 227 KB, the most a CTA may opt in to


def _bags_of(geo, b):
    """The bag each (CTA, bag-in-CTA) serves, as `embed_bag.cu` reckons
    it (bag = blockIdx.x * bags + warp / warps), the idle tail dropped."""
    return [k for k in range(geo.grid(b) * geo.bags) if k < b]


def _slots_of(geo, l):
    """The bag slots each warp of a bag and each slot group reads, over
    the kernel's chunks of 32 slots and its steps of `groups * unroll`."""
    slots = []
    for wb in range(geo.warps):
        lo = min(wb * geo.per_warp, l)
        hi = min(lo + geo.per_warp, l)
        for c0 in range(lo, hi, 32):
            cnt = min(32, hi - c0)
            for t0 in range(0, cnt, geo.groups * tker.EMBED_BAG_UNROLL):
                for u in range(tker.EMBED_BAG_UNROLL):
                    for g in range(geo.groups):
                        t = t0 + u * geo.groups + g
                        if t < cnt:
                            slots.append(c0 + t)
    return slots


def _columns_of(geo, d):
    """The floats of a row each column tile's lanes write (vec a lane)."""
    cols = d // geo.vec
    return [j * geo.vec + e for j0 in range(0, cols, geo.lanes)
            for c in range(geo.lanes) if (j := j0 + c) < cols
            for e in range(geo.vec)]


@pytest.mark.parametrize("d", [1, 8, 64, 100])
@pytest.mark.parametrize("l", [1, 7, 50])
@pytest.mark.parametrize("b", [1, 37, 512, 65_536])
def test_embed_bag_geometry(b, l, d):
    """Every (bag, slot, column) is covered exactly once (the kernel's
    mapping is a product of the three, each checked as a bijection);
    all 32 lanes of a warp hold a slot group; a CTA stays within 1024
    threads (the kernel's own cap is 256) and 227 KB of shared memory;
    B = 512 splits a bag over warps wherever it has more slots than a
    warp has groups, and B = 65,536 never does."""
    geo = tker.embed_bag_geometry(b, l, d, SMS)
    assert sorted(_bags_of(geo, b)) == list(range(b))
    assert sorted(_slots_of(geo, l)) == list(range(l))
    assert sorted(_columns_of(geo, d)) == list(range(d))
    assert geo.lanes * geo.groups == 32
    assert geo.lanes & (geo.lanes - 1) == 0 and geo.lanes <= 32
    assert geo.lanes >= min(d // geo.vec, 32)
    assert geo.threads <= 32 * tker.EMBED_BAG_CTA_WARPS <= 1024
    assert geo.smem_bytes <= SMEM_LIMIT
    assert geo.vec == (4 if d % 4 == 0 else 1)
    if b == 65_536:
        assert geo.warps == 1
    if b == 512 and l > geo.groups:
        assert geo.warps > 1


def test_embed_bag_geometry_at_the_mind_shapes():
    """D = 64 on 132 SMs: half-warp slot groups; B = 512 takes five warps
    a bag, ten slots each (2,560 warps, 19 an SM); B = 65,536 one warp a
    bag, eight bags a CTA; a misaligned table goes by floats, in 32-lane
    groups over two column tiles."""
    serve = tker.embed_bag_geometry(512, 50, 64, SMS)
    assert (serve.vec, serve.lanes, serve.groups, serve.warps, serve.bags,
            serve.per_warp) == (4, 16, 2, 5, 1, 10)
    assert serve.grid(512) == 512 and serve.smem_bytes == 5 * 16 * 16
    train = tker.embed_bag_geometry(65_536, 50, 64, SMS)
    assert (train.warps, train.bags, train.per_warp) == (1, 8, 50)
    assert train.grid(65_536) == 8192 and train.smem_bytes == 0
    scalar = tker.embed_bag_geometry(512, 50, 64, SMS, aligned=False)
    assert (scalar.vec, scalar.lanes, scalar.groups) == (1, 32, 1)
    assert sorted(_columns_of(scalar, 64)) == list(range(64))
