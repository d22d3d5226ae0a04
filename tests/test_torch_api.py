"""The PyTorch port's `api` against `repro.api`, and state carried across.

`api.build` / `api.update` / `api.query` on the CPU — the COO reference by
default, a tiled plan when given a `RelaxEngine` — must give the
reference's graph slots, labelling, `aff` and answers bit for bit. Then a
labelling built by the JAX package is carried into the port with
`repro_torch.convert`, and one update applied in both packages.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest

from repro import api as japi
from repro.core import batch as jbat
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core.engine import RelaxEngine


def _assert_state(gt, labt, gj, labj):
    for got, want in zip(cv.graph_to_numpy(gt),
                         (gj.src, gj.dst, gj.valid, gj.w, gj.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(cv.labelling_to_numpy(labt),
                         (labj.landmarks, labj.dist, labj.hub,
                          labj.highway)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("tiled", [False, True])
def test_build_update_query_match_reference(tiled):
    n = 160
    edges = jgen.barabasi_albert(n, 3, seed=11)
    engine = (RelaxEngine(block_v=32, block_e=16, device="cpu") if tiled
              else None)
    gt, labt = tapi.build(n, edges, num_landmarks=4, slack=16, device="cpu",
                          engine=engine)
    gj, labj = japi.build(n, edges, num_landmarks=4, slack=16)
    _assert_state(gt, labt, gj, labj)

    ups = jgen.random_batch_updates(edges, n, n_ins=8, n_del=8, seed=12)
    gt, labt, afft = tapi.update(gt, labt, ups, pad_to=20, engine=engine)
    gj, labj, affj = japi.update(gj, labj, ups, pad_to=20)
    _assert_state(gt, labt, gj, labj)
    np.testing.assert_array_equal(afft.numpy(), affj)

    rng = np.random.default_rng(13)
    s, t = rng.integers(0, n, 32), rng.integers(0, n, 32)
    np.testing.assert_array_equal(
        tapi.query(gt, labt, s, t, engine=engine).numpy(),
        japi.query(gj, labj, s, t))
    if tiled:
        assert engine.retile_count == 2 and engine.plan_cache_hits == 1


def test_state_carried_from_reference():
    """Build in JAX, carry graph + labelling + batch across, update in both
    packages, and carry the result back."""
    n = 120
    edges = jgen.barabasi_albert(n, 2, seed=21)
    gj, labj = japi.build(n, edges, num_landmarks=4, slack=8)
    ups = jgen.random_batch_updates(edges, n, n_ins=4, n_del=4, seed=22,
                                    n_rew=2, max_weight=3)
    bj = jcoo.make_batch(ups, pad_to=12)
    gt = cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                             device="cpu")
    labt = cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                   labj.highway, device="cpu")
    bt = cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                             bj.is_rew, device="cpu")
    for got, want in zip(cv.batch_to_numpy(bt),
                         (bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                          bj.is_rew)):
        np.testing.assert_array_equal(got, np.asarray(want))
    gt2, labt2, afft = tbat.batchhl_update(gt, bt, labt)
    gj2, labj2, affj = jbat.batchhl_update(gj, bj, labj)
    _assert_state(gt2, labt2, gj2, labj2)
    np.testing.assert_array_equal(afft.numpy(), np.asarray(affj))
    # And back: the port's state continues in the reference.
    g_back = jcoo.Graph(*cv.graph_to_numpy(gt2))
    assert jcoo.to_numpy_adj(g_back) == jcoo.to_numpy_adj(gj2)
