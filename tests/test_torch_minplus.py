"""Min-plus query bound of the PyTorch port against `repro`, bit for bit.

Kernel B's plain version (`kernels/minplus/kernel.py:minplus_plain`, what
the wrapper runs for CPU tensors) against the reference Pallas
`minplus_pallas` (interpret mode) and its jnp oracle `ref.minplus_bound`,
square and rectangular H, values up to INF32, and H past the 48 KB the
first kernel took; the edge cases of `tests/_kernel_cases.py`, which the
card runs against the kernel, against the oracle; and the kernel's launch
geometry (`minplus_geometry`), which only the card runs. The public
entry `ops.minplus_bound` against the reference's `ops.minplus_bound`
through both of its paths, at P = R and P < R.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import kernel as jker
from repro.kernels.minplus import ops as jops
from repro.kernels.minplus import ref as jref
from repro_torch.kernels.minplus import kernel as tker
from repro_torch.kernels.minplus import ops as tops

import _kernel_cases as kcases

INF32 = 1 << 29


def _inputs(b, p, r, seed):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 64, shape).astype(np.int32)
        x[rng.random(shape) < 0.2] = INF32      # unreachable entries
        return x
    return draw((b, p)), draw((p, r)), draw((b, r))


@pytest.mark.parametrize("b,p,r", [(1, 4, 4), (32, 4, 4), (33, 8, 32),
                                   (5, 3, 7), (4, 128, 128), (3, 8, 2048)])
def test_minplus_plain_matches_reference(b, p, r):
    s, h, t = _inputs(b, p, r, b * 100 + r)
    got = tker.minplus(torch.from_numpy(s), torch.from_numpy(h),
                       torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.minplus_bound(jnp.asarray(s), jnp.asarray(h),
                                           jnp.asarray(t))))
    np.testing.assert_array_equal(
        got, np.asarray(jker.minplus_pallas(jnp.asarray(s), jnp.asarray(h),
                                            jnp.asarray(t), interpret=True)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("b,p,r", [(32, 32, 32), (7, 8, 32), (5, 3, 7)])
def test_minplus_bound_matches_reference_ops(b, p, r, use_pallas):
    """`ops.minplus_bound`, the port's public entry of the bound, against
    the reference's: the full bound (P = R) and a shard-local row slice
    (P < R), with int64 inputs that the entry casts to int32."""
    s, h, t = _inputs(b, p, r, 7 * b + p)
    got = tops.minplus_bound(*(torch.from_numpy(x.astype(np.int64))
                               for x in (s, h, t)))
    assert got.dtype == torch.int32 and got.shape == (b,)
    want = jops.minplus_bound(jnp.asarray(s), jnp.asarray(h), jnp.asarray(t),
                              use_pallas=use_pallas)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_minplus_rejects_bad_inputs():
    s, h, t = (torch.from_numpy(x) for x in _inputs(4, 3, 5, 0))
    with pytest.raises(ValueError, match="at least one"):
        tker.minplus(s[:, :0].contiguous(), h[:0].contiguous(), t)
    with pytest.raises(ValueError):
        tker.minplus(s, h.T.contiguous(), t)
    with pytest.raises(TypeError):
        tker.minplus(s.to(torch.int64), h, t)
    with pytest.raises(ValueError):
        tker.minplus(s, h, torch.from_numpy(_inputs(5, 4, 4, 1)[0]).T)


@pytest.mark.parametrize("name", kcases.minplus_names())
def test_minplus_plain_on_kernel_cases(name):
    s, h, t = kcases.minplus_case(name)
    got = tker.minplus(*(torch.from_numpy(x) for x in (s, h, t))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.minplus_bound(jnp.asarray(s), jnp.asarray(h),
                                           jnp.asarray(t))))


@pytest.mark.parametrize("p,r,cols,chunk_rows", [
    (32, 32, 1, 32),        # the main path: H in one chunk
    (8, 32, 1, 8),          # shard-local rows
    (3, 7, 1, 3),
    (8, 300, 8, 8),         # two column tiles of 256
    (128, 128, 4, 64),      # H 64 KB: two chunks
    (512, 512, 8, 32),      # H 1 MB: 16 chunks per column tile
    (8, 2048, 8, 8),        # eight column tiles
    (1000, 40, 2, 128),
])
def test_minplus_geometry(p, r, cols, chunk_rows):
    """A warp per row, 4 rows per CTA; the columns a lane keeps cover R
    up to 256; every staged chunk fits the 48 KB a CTA gets without an
    opt-in, whatever the size of H."""
    geo = tker.minplus_geometry(p, r)
    assert (geo.warps, geo.cols, geo.chunk_rows) == (4, cols, chunk_rows)
    assert geo.chunk_rows * 32 * geo.cols * 4 <= tker.MINPLUS_CHUNK_BYTES \
        <= 48 * 1024
    assert geo.chunk_rows <= p and (geo.chunk_rows % 32 == 0
                                    or geo.chunk_rows == p)
