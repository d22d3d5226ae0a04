"""Labelling state and construction of the PyTorch port against `repro`.

Key arithmetic near INF_KEY2 / INF_KEY4 / INF_D, landmark selection with
degree ties across the top-k boundary, and construction on Barabási–
Albert, `random_connected` and a two-component graph, where a saturated
key with its hub bit cleared lands below inf (536870912 = INF_KEY2 & ~1)
and the port must keep that value. Bit equality, no tolerance; both the
COO reference (`plan=None`) and a tiled plan run on the CPU.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import construct as jcon
from repro.core import labelling as jlab
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.core import construct as tcon
from repro_torch.core import labelling as tlab
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs.coo import INF_D

TWO_COMPONENTS = np.array([[0, 1], [1, 2], [3, 4], [4, 5]], np.int32)
#: A 64-vertex path with landmarks at both ends: 63 sweeps to the fixpoint.
PATH64 = np.array([[i, i + 1] for i in range(63)], np.int32)
PATH64_LANDMARKS = np.array([0, 63], np.int32)


def _port_graph(gj):
    return cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                               device="cpu")


def test_key_arithmetic_near_inf():
    rng = np.random.default_rng(0)
    near = lambda inf: np.concatenate([  # noqa: E731
        np.arange(inf - 9, inf + 1), rng.integers(0, inf, 20)]).astype(
            np.int32)
    w = np.concatenate([np.array([1, INF_D, INF_D - 1, 2]),
                        rng.integers(1, INF_D, 26)]).astype(np.int32)
    hub = rng.random(30) < 0.5
    for fn, inf in ((("key2_extend"), tlab.INF_KEY2),
                    (("key4_extend"), tlab.INF_KEY4)):
        k = near(inf)
        got = getattr(tlab, fn)(torch.from_numpy(k), torch.from_numpy(hub),
                                w=torch.from_numpy(w)).numpy()
        want = getattr(jlab, fn)(jnp.asarray(k), jnp.asarray(hub),
                                 w=jnp.asarray(w))
        np.testing.assert_array_equal(got, np.asarray(want))
    d = np.concatenate([near(INF_D), [INF_D]]).astype(np.int32)[:30]
    l, e = rng.random(30) < 0.5, rng.random(30) < 0.5
    td, tl, te = (torch.from_numpy(x) for x in (d, l, e))
    jd, jl, je = (jnp.asarray(x) for x in (d, l, e))
    k2 = tlab.key2_make(td, tl)
    pairs = [
        (k2, jlab.key2_make(jd, jl)),
        (tlab.key2_dist(k2), jlab.key2_dist(jlab.key2_make(jd, jl))),
        (tlab.key2_hub(k2), jlab.key2_hub(jlab.key2_make(jd, jl))),
        (tlab.key4_make(td, tl, te), jlab.key4_make(jd, jl, je)),
        (tlab.key4_from_key2(k2, te),
         jlab.key4_from_key2(jlab.key2_make(jd, jl), je)),
        (tlab.key4_beta(k2), jlab.key4_beta(jlab.key2_make(jd, jl))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tlab.INF_KEY2, tlab.INF_KEY4) == (int(jlab.INF_KEY2),
                                              int(jlab.INF_KEY4))


@pytest.mark.parametrize("fn,inf", [
    ("key2_extend", 2 * 1000 + 1), ("key2_extend", (1 << 20) + 1),
    ("key4_extend", 4 * 1000 + 3), ("key4_extend", (1 << 22) + 3)])
def test_key_extend_with_other_inf(fn, inf):
    """`inf=` saturates at the given key, as the reference's does."""
    rng = np.random.default_rng(1)
    k = np.concatenate([np.arange(inf - 12, inf + 3),
                        rng.integers(0, inf, 25)]).astype(np.int32)
    w = rng.integers(1, 9, k.shape[0]).astype(np.int32)
    hub = rng.random(k.shape[0]) < 0.5
    got = getattr(tlab, fn)(torch.from_numpy(k), torch.from_numpy(hub),
                            inf, w=torch.from_numpy(w)).numpy()
    want = getattr(jlab, fn)(jnp.asarray(k), jnp.asarray(hub), inf,
                             w=jnp.asarray(w))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.max() <= inf


def test_landmark_selection_breaks_ties_by_lower_id():
    """Degrees [5,3,7,3,7,3,1] → [2, 4, 0, 1]; and a graph whose top-k
    boundary cuts through a run of tied degrees."""
    deg = np.array([5, 3, 7, 3, 7, 3, 1])
    leaf = 7 + np.concatenate([[0], np.cumsum(deg)])  # one leaf per edge
    edges = np.array([(v, leaf[v] + i) for v in range(7)
                      for i in range(deg[v])], np.int32)
    gj = jcoo.from_edges(int(leaf[-1]), edges, len(edges))
    got = tcon.select_landmarks_by_degree(_port_graph(gj), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcon.select_landmarks_by_degree(gj, 4)))
    np.testing.assert_array_equal(got[:4], [2, 4, 0, 1])
    star = np.array([(0, v) for v in range(1, 9)]
                    + [(v, v + 1) for v in range(1, 8)], np.int32)
    gj = jcoo.from_edges(9, star, 20)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(
            tcon.select_landmarks_by_degree(_port_graph(gj), k).numpy(),
            np.asarray(jcon.select_landmarks_by_degree(gj, k)))


def _graphs():
    ba = jgen.barabasi_albert(120, 3, seed=2)
    rc = jgen.random_connected(90, extra_edges=40, seed=3)
    rng = np.random.default_rng(4)
    rcw = np.concatenate([rc, rng.integers(1, 7, (len(rc), 1))], 1)
    return {"ba": (120, ba, None), "random_connected": (90, rc, None),
            "weighted": (90, rcw, None),
            "two_components": (6, TWO_COMPONENTS, np.array([0, 3]))}


@pytest.mark.parametrize("name", ["ba", "random_connected", "weighted",
                                  "two_components"])
@pytest.mark.parametrize("tiled", [False, True])
def test_construction_matches_reference(name, tiled):
    n, edges, landmarks = _graphs()[name]
    gj = jcoo.from_edges(n, edges, len(edges) + 8)
    lm_j = (jcon.select_landmarks_by_degree(gj, 4) if landmarks is None
            else jnp.asarray(landmarks, jnp.int32))
    gt = _port_graph(gj)
    lm_t = torch.from_numpy(np.array(lm_j))
    plan = (RelaxEngine(block_v=16, block_e=8, device="cpu").prepare(gt)
            if tiled else None)
    k_t = tcon.construct_key2_planes(gt, lm_t, lm_t, plan=plan)
    k_j = jcon.construct_key2_planes(gj, lm_j, lm_j)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    lab_t = tcon.build_labelling(gt, lm_t, plan=plan)
    lab_j = jcon.build_labelling(gj, lm_j)
    for got, want in zip(cv.labelling_to_numpy(lab_t),
                         (lab_j.landmarks, lab_j.dist, lab_j.hub,
                          lab_j.highway)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert int(lab_t.label_size()) == int(lab_j.label_size())
    if name == "two_components":
        # Saturated, then hub-cleared: below INF_KEY2, as the reference.
        assert k_t[0, 3] == 536870912 and k_t[1, 0] == 536870912


@pytest.mark.parametrize("max_iters", [0, 1, 8, None])
@pytest.mark.parametrize("tiled", [False, True])
def test_build_labelling_max_iters_matches_reference(max_iters, tiled):
    """`build_labelling(g, lm, max_iters)` on the 64-vertex path with
    landmarks [0, 63]: each plane stops after `max_iters` sweeps, so
    entries further out stay at INF_D (110 of 128 at 8 sweeps)."""
    gj = jcoo.from_edges(64, PATH64, len(PATH64))
    gt = _port_graph(gj)
    lm_j = jnp.asarray(PATH64_LANDMARKS)
    lm_t = torch.from_numpy(PATH64_LANDMARKS)
    plan = (RelaxEngine(block_v=16, block_e=8, device="cpu").prepare(gt)
            if tiled else None)
    lab_t = tcon.build_labelling(gt, lm_t, max_iters, plan)
    lab_j = jcon.build_labelling(gj, lm_j, max_iters)
    for got, want in zip(cv.labelling_to_numpy(lab_t),
                         (lab_j.landmarks, lab_j.dist, lab_j.hub,
                          lab_j.highway)):
        np.testing.assert_array_equal(got, np.asarray(want))
    k_t = tcon.construct_key2_planes(gt, lm_t, lm_t, max_iters, plan=plan)
    np.testing.assert_array_equal(
        k_t.numpy(), np.asarray(jcon.construct_key2_planes(gj, lm_j, lm_j,
                                                           max_iters)))
    unreached = int((lab_t.dist == INF_D).sum())
    assert unreached == {0: 126, 1: 124, 8: 110, None: 0}[max_iters]
