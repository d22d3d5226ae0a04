"""The embedding bag of the PyTorch port against `repro`.

Kernel D's plain version (`kernels/embed_bag/kernel.py:embed_bag_plain`,
what the wrapper runs for CPU tensors) and the entry `ops.embed_bag` are
held to the reference's Pallas `embed_bag_pallas` (interpret mode), its
`ref.embed_bag` and its `ops.embed_bag`, over the reference's shape grid
with float32 and float16 tables, sum and mean, with and without a mask,
and the wrapped (-1, -N) and NaN (N, -N-1) index cases.

Tolerance: the sums are float32 in another order than the reference's,
so rtol = atol = 1e-5 for float32 tables; for float16 tables the
reference's own 2e-3 (`tests/test_kernels.py`).
"""
from __future__ import annotations

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
