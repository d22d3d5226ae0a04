"""Min-plus query bound of the PyTorch port against `repro`, bit for bit.

Kernel B's plain version (`kernels/minplus/kernel.py:minplus_plain`, what
the wrapper runs for CPU tensors) against the reference Pallas
`minplus_pallas` (interpret mode) and its jnp oracle `ref.minplus_bound`,
square and rectangular H, values up to INF32.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import kernel as jker
from repro.kernels.minplus import ref as jref
from repro_torch.kernels.minplus import kernel as tker

INF32 = 1 << 29


def _inputs(b, p, r, seed):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 64, shape).astype(np.int32)
        x[rng.random(shape) < 0.2] = INF32      # unreachable entries
        return x
    return draw((b, p)), draw((p, r)), draw((b, r))


@pytest.mark.parametrize("b,p,r", [(1, 4, 4), (32, 4, 4), (33, 8, 32),
                                   (5, 3, 7)])
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


def test_minplus_rejects_bad_inputs():
    s, h, t = (torch.from_numpy(x) for x in _inputs(4, 3, 5, 0))
    with pytest.raises(ValueError):
        tker.minplus(s, h.T.contiguous(), t)
    with pytest.raises(TypeError):
        tker.minplus(s.to(torch.int64), h, t)
    with pytest.raises(ValueError):
        tker.minplus(s, h, torch.from_numpy(_inputs(5, 4, 4, 1)[0]).T)
