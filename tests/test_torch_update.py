"""BatchHL update of the PyTorch port against `repro`, bit for bit.

`batchhl_update` (BHL: basic search, BHL⁺: improved search; then repair)
and its parts on mixed insert/delete/re-weight batches, through the COO
reference (`plan=None`) and a tiled plan on the CPU: graph slots,
labelling and `aff` must equal the reference's. Includes the
two-component deletion, whose `aff` marks the other component's landmark
(a hub-cleared saturated key lies below inf), and a six-field no-op batch.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs import coo as tcoo


def _port(gj, labj):
    gt = cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                             device="cpu")
    labt = cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                   labj.highway, device="cpu")
    return gt, labt


def _port_batch(bj):
    return cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                               bj.is_rew, device="cpu")


def _assert_state(gt, labt, afft, gj, labj, affj):
    for got, want in zip(cv.graph_to_numpy(gt),
                         (gj.src, gj.dst, gj.valid, gj.w, gj.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(cv.labelling_to_numpy(labt),
                         (labj.landmarks, labj.dist, labj.hub,
                          labj.highway)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(afft.numpy(), np.asarray(affj))


def _instance(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ba":
        n, edges = 150, jgen.barabasi_albert(150, 3, seed)
        ups = jgen.random_batch_updates(edges, n, n_ins=6, n_del=6,
                                        seed=seed)
    else:
        n = 80
        edges = jgen.random_connected(n, extra_edges=50, seed=seed)
        edges = np.concatenate([edges, rng.integers(1, 6, (len(edges), 1))],
                               1)
        ups = jgen.random_batch_updates(edges, n, n_ins=5, n_del=5,
                                        seed=seed, n_rew=4, max_weight=5)
    gj = jcoo.from_edges(n, edges, len(edges) + 16)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 4))
    return gj, labj, jcoo.make_batch(ups, pad_to=len(ups) + 3)


@pytest.mark.parametrize("kind", ["ba", "weighted"])
@pytest.mark.parametrize("improved", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_batchhl_update_matches_reference(kind, improved, tiled):
    gj, labj, bj = _instance(kind, seed=3)
    gt, labt = _port(gj, labj)
    bt = _port_batch(bj)
    g_new = tcoo.apply_batch(gt, bt)
    plan = (RelaxEngine(block_v=16, block_e=8, device="cpu").prepare(g_new)
            if tiled else None)
    got = tbat.batchhl_update(gt, bt, labt, improved=improved, plan=plan,
                              g_new=g_new)
    want = jbat.batchhl_update(gj, bj, labj, improved=improved)
    _assert_state(*got, *want)


def test_search_and_repair_parts_match_reference():
    gj, labj, bj = _instance("weighted", seed=5)
    gt, labt = _port(gj, labj)
    bt = _port_batch(bj)
    g2j, g2t = jcoo.apply_batch(gj, bj), tcoo.apply_batch(gt, bt)
    bsj, bst = (jcoo.resolve_seed_weights(gj, bj),
                tcoo.resolve_seed_weights(gt, bt))
    aff_b = tbat.batch_search_basic(gt, g2t, bst, labt)
    np.testing.assert_array_equal(
        aff_b.numpy(), np.asarray(jbat.batch_search_basic(gj, g2j, bsj,
                                                          labj)))
    aff_i = tbat.batch_search_improved(gt, g2t, bst, labt)
    np.testing.assert_array_equal(
        aff_i.numpy(), np.asarray(jbat.batch_search_improved(gj, g2j, bsj,
                                                             labj)))
    # Repair from the *basic* aff (a different superset) as well.
    for aff in (aff_b, aff_i):
        lt = tbat.batch_repair(g2t, aff, labt)
        lj = jbat.batch_repair(g2j, jnp.asarray(aff.numpy()), labj)
        for got, want in zip(cv.labelling_to_numpy(lt),
                             (lj.landmarks, lj.dist, lj.hub, lj.highway)):
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("improved", [False, True])
def test_two_component_deletion(improved):
    edges = np.array([[0, 1], [1, 2], [3, 4], [4, 5]], np.int32)
    gj = jcoo.from_edges(6, edges, 6)
    labj = jcon.build_labelling(gj, jnp.array([0, 3], jnp.int32))
    bj = jcoo.make_batch([(1, 2, True)], pad_to=2)
    gt, labt = _port(gj, labj)
    got = tbat.batchhl_update(gt, _port_batch(bj), labt, improved=improved)
    _assert_state(*got, *jbat.batchhl_update(gj, bj, labj,
                                             improved=improved))
    if improved:
        assert got[2].to(torch.int32).tolist() == [[0, 0, 1, 1, 0, 0],
                                                   [1, 0, 0, 0, 0, 0]]


@pytest.mark.parametrize("improved", [False, True])
def test_noop_batch_is_identity(improved):
    """A batch of only padding rows, built with all six fields."""
    gj, labj, _ = _instance("ba", seed=9)
    z = np.zeros(4, np.int32)
    f = np.zeros(4, bool)
    bj = jcoo.BatchUpdate(jnp.asarray(z), jnp.asarray(z), jnp.asarray(f),
                          jnp.asarray(f), jnp.asarray(np.ones(4, np.int32)),
                          jnp.asarray(f))
    gt, labt = _port(gj, labj)
    bt = cv.batch_from_numpy(z, z, f, f, np.ones(4, np.int32), f,
                             device="cpu")
    got = tbat.batchhl_update(gt, bt, labt, improved=improved)
    _assert_state(*got, *jbat.batchhl_update(gj, bj, labj,
                                             improved=improved))
    np.testing.assert_array_equal(got[1].dist.numpy(), labt.dist.numpy())
    assert not got[2].any()
