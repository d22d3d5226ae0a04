"""The frontier-proportional update of the PyTorch port against `repro`,
bit for bit.

An engine with the frontier mode on (`RelaxEngine(frontier=True)`) must
give the port's BHL and BHL⁺ updates exactly the graph slots, labelling
and `aff` of the reference's frontier update (`RelaxEngine(
backend="pallas", frontier=True)`, Pallas in interpret mode, as
`tests/test_frontier.py` builds it) and of the port's own full-sweep
update. The cases are insert-only, delete-only, mixed, re-weight and a
weighted graph, at threshold 0 (a row budget of 1: every wave of these
cases falls back to the full sweep), 0.25 and 1.0 (every wave masked),
and on both sides of the `count == rows_cap` boundary. The port's
`FrontierTiles` arrays, `nrows` and `rows_cap`, and its propagation
primitives, equal the reference's: they decide masked or full wave by
wave.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core.engine import RelaxEngine as JEngine
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro.core import construct as jcon
from repro.kernels.edge_relax import ops as jops
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core import engine as teng
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs import coo as tcoo
from repro_torch.kernels.edge_relax import ops as tops

FT_ARRAYS = ("src_r", "dstg_r", "perm_r", "slot_r", "rowblk_r", "adj")
FT_META = ("n", "fblock", "nbf", "nrows", "rows_cap")


def _instance(n, seed, n_ins, n_del, n_rew, max_w, weighted=False):
    edges = jgen.random_connected(n, extra_edges=n // 2, seed=seed)
    if weighted:
        rng = np.random.default_rng(seed)
        edges = np.concatenate(
            [edges, rng.integers(1, 6, (len(edges), 1))], 1).astype(np.int32)
    ups = jgen.random_batch_updates(edges, n, n_ins, n_del, seed=seed + 1,
                                    n_rew=n_rew, max_weight=max_w)
    gj = jcoo.from_edges(n, edges, len(edges) + 16)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 3))
    bj = jcoo.make_batch(ups, pad_to=len(ups) + 2)
    gt = cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                             device="cpu")
    labt = cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                   labj.highway, device="cpu")
    bt = cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                             bj.is_rew, device="cpu")
    return (gj, labj, bj), (gt, labt, bt)


def _port_update(gt, labt, bt, improved, engine):
    g_new = tcoo.apply_batch(gt, bt)
    return tbat.batchhl_update(gt, bt, labt, improved=improved,
                               plan=engine.prepare(g_new), g_new=g_new)


def _ref_update(gj, labj, bj, improved, threshold):
    g_new = jcoo.apply_batch(gj, bj)
    eng = JEngine(backend="pallas", block_v=16, frontier=True,
                  frontier_threshold=threshold, frontier_block=8)
    return jbat.batchhl_update(gj, bj, labj, improved,
                               plan=eng.prepare(g_new), g_new=g_new)


def _frontier_engine(threshold):
    return RelaxEngine(block_v=16, frontier=True,
                       frontier_threshold=threshold, frontier_block=8,
                       device="cpu")


def _assert_same(got, want, context):
    (gt, labt, afft), (gw, labw, affw) = got, want
    for a, b in zip(cv.graph_to_numpy(gt), cv.graph_to_numpy(gw)
                    if isinstance(gw, tcoo.Graph)
                    else (gw.src, gw.dst, gw.valid, gw.w, gw.n)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"graph {context}")
    want_lab = (cv.labelling_to_numpy(labw)
                if isinstance(labw.dist, torch.Tensor)
                else (labw.landmarks, labw.dist, labw.hub, labw.highway))
    for a, b in zip(cv.labelling_to_numpy(labt), want_lab):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"labelling {context}")
    np.testing.assert_array_equal(
        afft.numpy(), affw.numpy() if isinstance(affw, torch.Tensor)
        else np.asarray(affw), err_msg=f"aff {context}")


CASES = {
    # name: (n, seed, n_ins, n_del, n_rew, max_w, weighted, threshold)
    "insert": (40, 3, 3, 0, 0, 1, False, 0.25),
    "delete": (40, 4, 0, 3, 0, 1, False, 0.25),
    "mixed": (48, 5, 3, 3, 0, 1, False, 0.25),
    "reweight": (40, 6, 0, 0, 3, 4, False, 0.25),
    "weighted": (48, 7, 2, 2, 2, 5, True, 0.25),
    "threshold0": (48, 8, 3, 3, 1, 3, False, 0.0),
    "threshold1": (48, 9, 3, 3, 1, 3, False, 1.0),
}


@pytest.mark.parametrize("improved", [False, True], ids=["bhl", "bhl+"])
@pytest.mark.parametrize("case", list(CASES))
def test_frontier_update_matches_reference(case, improved):
    n, seed, n_ins, n_del, n_rew, max_w, weighted, th = CASES[case]
    (gj, labj, bj), (gt, labt, bt) = _instance(n, seed, n_ins, n_del, n_rew,
                                               max_w, weighted)
    teng.WAVES.clear()
    got = _port_update(gt, labt, bt, improved, _frontier_engine(th))
    waves = dict(teng.WAVES)
    _assert_same(got, _ref_update(gj, labj, bj, improved, th),
                 f"[{case} improved={improved}] vs repro")
    full = _port_update(gt, labt, bt, improved,
                        RelaxEngine(block_v=16, device="cpu"))
    _assert_same(got, full, f"[{case} improved={improved}] vs full sweep")
    kind = "search_improved" if improved else "search_basic"
    masked = waves.get(kind + ".masked", 0) + waves.get("repair.masked", 0)
    total = waves.get(kind, 0) + waves.get("repair", 0)
    assert total > 0 and waves["repair_base"] == 1
    if th == 0.0:   # a budget of one row: here every wave is full
        assert masked == 0
    if th == 1.0:   # the budget holds every row: every wave is masked
        assert masked == total and waves.get("repair_base.masked") == 1
    if th == 0.25:  # tiny graphs: the active rows fit in 16 of 64
        assert masked == total


def test_frontier_threshold_boundary():
    """Thresholds that put rows_cap exactly at, and one below, the first
    search wave's active-row count: the first wave flips from masked to
    full, and both updates equal the reference's and the full sweep."""
    (gj, labj, bj), (gt, labt, bt) = _instance(64, 11, 4, 4, 1, 3)
    g_new = tcoo.apply_batch(gt, bt)
    plan = _frontier_engine(1.0).prepare(g_new)
    lab_hub = tbat._per_plane_hub_mask(labt, gt.n)
    _, seeded, _ = tbat.search_improved_seed(
        g_new, tcoo.resolve_seed_weights(gt, bt), labt.dist, labt.hub,
        lab_hub)
    _, count = tbat.frontier_active_rows(
        plan, plan.frontier.changed_blocks(seeded))
    count, nrows = int(count), plan.frontier.nrows
    assert count >= 3, "the case must activate a few rows"
    full = _port_update(gt, labt, bt, True,
                        RelaxEngine(block_v=16, device="cpu"))
    masked = {}
    for cap in (count, count - 1):
        th = (cap - 0.5) / nrows
        eng = _frontier_engine(th)
        assert eng.prepare(g_new).frontier.rows_cap == cap
        teng.WAVES.clear()
        got = _port_update(gt, labt, bt, True, eng)
        masked[cap] = teng.WAVES.get("search_improved.masked", 0)
        _assert_same(got, _ref_update(gj, labj, bj, True, th),
                     f"[rows_cap={cap}] vs repro")
        _assert_same(got, full, f"[rows_cap={cap}] vs full sweep")
    # Same planes every wave, so a larger budget only turns full waves
    # masked, and the first wave turns for certain.
    assert masked[count] >= masked[count - 1] + 1


@pytest.mark.parametrize("threshold", [0.0, 0.25, 1.0])
def test_frontier_tiles_match_reference(threshold):
    (gj, *_), (gt, *_) = _instance(64, 12, 0, 0, 0, 1)
    src, dst, keep = (np.asarray(x) for x in (gj.src, gj.dst, gj.valid))
    keep = keep.copy()
    keep[::7] = False   # some free slots
    fj = jops.prepare_frontier(src, dst, keep, gj.n, 8, threshold=threshold)
    ft = tops.prepare_frontier(src, dst, keep, gt.n, 8, threshold=threshold,
                               device="cpu")
    for f in FT_ARRAYS:
        np.testing.assert_array_equal(getattr(ft, f).numpy(),
                                      np.asarray(getattr(fj, f)), err_msg=f)
    assert [getattr(ft, f) for f in FT_META] == \
        [getattr(fj, f) for f in FT_META]
    # The primitives that choose masked or full, on random frontiers.
    rng = np.random.default_rng(13)
    changed = rng.random((3, gt.n)) < 0.05
    cb_t = ft.changed_blocks(torch.from_numpy(changed))
    cb_j = fj.changed_blocks(jnp.asarray(changed))
    np.testing.assert_array_equal(cb_t.numpy(), np.asarray(cb_j))
    front = cb_t.any(0)
    prop_t = ft.propagate(front)
    np.testing.assert_array_equal(
        prop_t.numpy(), np.asarray(fj.propagate(jnp.asarray(front.numpy()))))
    np.testing.assert_array_equal(
        ft.active_rows(prop_t).numpy(),
        np.asarray(fj.active_rows(jnp.asarray(prop_t.numpy()))))
    ridx = torch.tensor([0, 2, ft.nrows])
    for a, b in zip(ft.gather(ridx), fj.gather(jnp.asarray(ridx.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_frontier_plan_cache_key():
    """A frontier engine keys its plans by the frontier settings too, and
    the full-sweep engine's plans carry no frontier tiling."""
    _, (gt, *_) = _instance(40, 14, 0, 0, 0, 1)
    assert RelaxEngine(block_v=16, device="cpu").prepare(gt).frontier is None
    eng = _frontier_engine(0.25)
    plan = eng.prepare(gt)
    assert plan.frontier is not None and eng.prepare(gt) is plan
    assert (eng.retile_count, eng.plan_cache_hits) == (1, 1)
