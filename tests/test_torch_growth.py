"""Grow-in-place of the port against `repro` (DESIGN.md §6), bit for bit.

`coo.grow`, `coo.batch_requirements`, `grow_labelling`, `GrowthPolicy`
and `ensure_capacity` on the same numpy inputs through both packages;
typed `CapacityError`s at every pre-growth call site; a grown snapshot's
update equal to fresh construction at the grown size; the engine
retiling for a grown snapshot even when the caller vouches nothing moved;
grown state through a checkpoint; and a 50-tick differential soak of the
port alone against its copy of the BFS oracle, across capacity and vertex
growths.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.core import growth as jgrowth
from repro.core import labelling as jlab
from repro.core import snapshot as jsnap
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro.kernels.edge_relax import kernel as jkernel
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core import construct as tcon
from repro_torch.core import growth as tgrowth
from repro_torch.core import labelling as tlab
from repro_torch.core import query as tq
from repro_torch.core import ref as tref
from repro_torch.core import snapshot as tsnap
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs import coo as tcoo
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.edge_relax.kernel import aligned_vertex_count
from repro_torch.launch.serve import ServeConfig, ServeLoop


def _instance(n=40, extra=20, seed=5, r=4, slack=2):
    """The reference tests' instance, in both packages."""
    edges = jgen.random_connected(n, extra_edges=extra, seed=seed)
    gj = jcoo.from_edges(n, edges, edges.shape[0] + slack)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, r))
    gt = cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                             device="cpu")
    labt = cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                   labj.highway, device="cpu")
    return edges, gj, labj, gt, labt


def _batch(ups, pad_to):
    return (jcoo.make_batch(ups, pad_to=pad_to),
            tcoo.make_batch(ups, pad_to=pad_to, device="cpu"))


def _assert_graph(gt, gj):
    for got, want in zip(cv.graph_to_numpy(gt),
                         (gj.src, gj.dst, gj.valid, gj.w, gj.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_lab(labt, labj):
    for got, want in zip(cv.labelling_to_numpy(labt),
                         (labj.landmarks, labj.dist, labj.hub, labj.highway)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- typed overflow errors --------------------------------------------------

def test_from_edges_raises_capacity_error():
    edges = np.array([[0, 1], [1, 2], [2, 3]], np.int32)
    with pytest.raises(tcoo.CapacityError, match="exceed capacity") as e:
        tcoo.from_edges(4, edges, 2, device="cpu")
    assert isinstance(e.value, ValueError)
    assert e.value.required_capacity == 3 and e.value.capacity == 2


def test_ensure_capacity_raises_with_tick_and_requirements():
    _, gj, labj, gt, labt = _instance()
    ups = [(0, 1, True), (2, 39, False), (3, 38, False), (4, 37, False),
           (5, 36, False)]
    bj, bt = _batch(ups, 5)
    req = tcoo.batch_requirements(gt, bt)
    assert req == jcoo.batch_requirements(gj, bj)
    assert req == (int(gt.valid.sum()) // 2 + 3, 40)
    assert req[0] == gt.capacity + 1
    with pytest.raises(tcoo.CapacityError, match="tick 11") as e:
        tgrowth.ensure_capacity(tsnap.Snapshot(0, gt, labt), bt,
                                tgrowth.GrowthPolicy(), grow=False, tick=11)
    assert e.value.tick == 11 and e.value.required_capacity == req[0]
    assert e.value.capacity == gt.capacity


@pytest.mark.parametrize("seed", range(4))
def test_batch_requirements_match_reference(seed):
    """Random batches with duplicate rows, deletions of non-edges,
    re-weights, vertex ids past n and padding rows."""
    edges, gj, _, gt, _ = _instance(slack=6)
    rng = np.random.default_rng(seed)
    ups = jgen.random_batch_updates(edges, 40, n_ins=4, n_del=3,
                                    seed=seed, n_rew=2, max_weight=3)
    ups += [tuple(ups[0]), (int(rng.integers(40)), 40 + seed, 0),
            (1, 2, 1), (7, 7, 2, 3)]
    bj, bt = _batch(ups, len(ups) + 3)
    assert tcoo.batch_requirements(gt, bt) == jcoo.batch_requirements(gj, bj)
    empty = tcoo.make_batch([], pad_to=2, device="cpu")
    assert tcoo.batch_requirements(gt, empty) == (
        int(gt.valid.sum()) // 2, 0)


def test_serve_loop_surfaces_capacity_error():
    cfg = ServeConfig(n=60, deg=1, landmarks=4, batches=3, batch_size=30,
                      scenario="growth", capacity=64, grow=False,
                      queries=4, qps=1e6, microbatch=4, quiet=True)
    with pytest.raises(tcoo.CapacityError, match="tick 0") as e:
        ServeLoop(cfg, device="cpu").run()
    assert e.value.tick == 0 and e.value.required_capacity > 64


def test_full_capacity_churn_batch_is_not_rejected():
    """At zero free pairs, a batch whose deletions free exactly the pairs
    its insertions need passes the grow=False check."""
    edges, gj, labj, gt, labt = _instance(slack=0)
    n = gt.n
    d0 = (int(edges[0][0]), int(edges[0][1]))
    d1 = (int(edges[1][0]), int(edges[1][1]))
    have = {(min(u, v), max(u, v)) for u, v in edges}
    fresh = [(u, v) for u in range(n) for v in range(u + 1, n)
             if (u, v) not in have][:2]
    ups = [(d0[0], d0[1], True), (d1[0], d1[1], True),
           (fresh[0][0], fresh[0][1], False),
           (fresh[1][0], fresh[1][1], False)]
    bj, bt = _batch(ups, 4)
    assert tcoo.batch_requirements(gt, bt)[0] == gt.capacity
    snap = tsnap.Snapshot(0, gt, labt)
    out, event = tgrowth.ensure_capacity(snap, bt, tgrowth.GrowthPolicy(),
                                         grow=False, tick=0)
    assert event is None and out is snap
    g2 = tcoo.apply_batch(gt, bt)
    assert tcoo.to_numpy_adj(g2) == tref.apply_updates(
        tcoo.to_numpy_adj(gt), ups)


def test_update_shape_guard_names_growth():
    _, _, _, gt, labt = _instance()
    batch = tcoo.make_batch([(0, 1, True)], pad_to=1, device="cpu")
    with pytest.raises(ValueError, match="grow them together"):
        tbat.batchhl_update(tcoo.grow(gt, n=48), batch, labt)


# --- growth primitives ------------------------------------------------------

def test_grow_preserves_graph_and_widens_labelling():
    _, gj, labj, gt, labt = _instance()
    g2 = tcoo.grow(gt, capacity=gt.capacity + 40, n=gt.n + 24)
    _assert_graph(g2, jcoo.grow(gj, capacity=gj.capacity + 40, n=gj.n + 24))
    assert g2.capacity == gt.capacity + 40 and g2.n == gt.n + 24
    assert tcoo.to_numpy_adj(g2) == {**tcoo.to_numpy_adj(gt),
                                     **{v: set() for v in range(gt.n, g2.n)}}
    lab2 = tlab.grow_labelling(labt, g2.n)
    _assert_lab(lab2, jlab.grow_labelling(labj, g2.n))
    # grown == fresh construction at the grown size, bit for bit
    fresh = tcon.build_labelling(g2, labt.landmarks)
    for f in ("dist", "hub", "highway"):
        assert getattr(lab2, f).equal(getattr(fresh, f)), f
    assert tcoo.grow(gt, n=gt.n).src is gt.src   # no slot moved
    with pytest.raises(ValueError, match="shrink"):
        tcoo.grow(g2, capacity=gt.capacity)
    with pytest.raises(ValueError, match="shrink"):
        tlab.grow_labelling(lab2, gt.n)


def test_growth_policy_geometric_and_aligned():
    pol = tgrowth.GrowthPolicy(block_v=64, shards=2, capacity_align=64)
    ref = jgrowth.GrowthPolicy(block_v=64, shards=2, capacity_align=64)
    assert pol.next_capacity(100, 101) == 256
    assert pol.next_capacity(100, 1000) == 1024
    assert pol.next_n(100, 101) == 256
    assert pol.next_n(100, 999) == 1024
    for cur in (1, 64, 100, 129, 4000):
        for req in (cur + 1, 2 * cur + 3, 10 * cur):
            assert pol.next_capacity(cur, req) == ref.next_capacity(cur, req)
            assert pol.next_n(cur, req) == ref.next_n(cur, req)
    for n in (1, 127, 128, 129, 1000):
        assert aligned_vertex_count(n, 64, 2) == \
            jkernel.aligned_vertex_count(n, 64, 2)
    with pytest.raises(ValueError):
        aligned_vertex_count(0, 64, 2)
    with pytest.raises(ValueError):
        tgrowth.GrowthPolicy(factor=1.0)


def test_ensure_capacity_grows_and_update_matches_fresh():
    """Capacity and vertex growth in one batch, the same event and grown
    snapshot as the reference's; the update through the tiled engine and
    the COO path equals the reference's and fresh construction at the
    grown size; the snapshot given to `ensure_capacity` is not written."""
    edges, gj, labj, gt, labt = _instance()
    n = gt.n
    ups = jgen.random_batch_updates(edges, n, n_ins=3, n_del=1, seed=7)
    ups += [(1, n, False), (n, n + 1, False)]
    bj, bt = _batch(ups, len(ups))
    policy = dict(block_v=16, shards=2)
    snap = tsnap.Snapshot(0, gt, labt)
    versions = [t._version for t in (gt.src, gt.dst, gt.valid, gt.w,
                                     labt.dist, labt.hub)]
    grown, event = tgrowth.ensure_capacity(
        snap, bt, tgrowth.GrowthPolicy(**policy), tick=4)
    jgrown, jevent = jgrowth.ensure_capacity(
        jsnap.Snapshot(0, gj, labj, None), bj,
        jgrowth.GrowthPolicy(**policy), tick=4)
    assert dataclasses.asdict(event) == dataclasses.asdict(jevent)
    assert grown.version == 0 and grown.graph.n == 96 and grown.plan is None
    _assert_graph(grown.graph, jgrown.graph)
    _assert_lab(grown.labelling, jgrown.labelling)
    assert versions == [t._version for t in (gt.src, gt.dst, gt.valid, gt.w,
                                             labt.dist, labt.hub)]

    engine = RelaxEngine(block_v=16, shards=2, device="cpu")
    engine.prepare(gt)
    g_next = tcoo.apply_batch(grown.graph, bt)
    plan = engine.prepare(g_next)
    assert engine.retile_count == 2
    want = jbat.batchhl_update(jgrown.graph, bj, jgrown.labelling)
    for p in (None, plan):
        g2, lab2, aff = tbat.batchhl_update(grown.graph, bt, grown.labelling,
                                            plan=p, g_new=g_next)
        _assert_graph(g2, want[0])
        _assert_lab(lab2, want[1])
        np.testing.assert_array_equal(aff.numpy(), np.asarray(want[2]))
    live = sorted({(min(u, v), max(u, v))
                   for u, adj in tcoo.to_numpy_adj(g2).items() for v in adj})
    fresh = tcon.build_labelling(
        tcoo.from_edges(g2.n, np.asarray(live, np.int32), g2.capacity,
                        device="cpu"), labt.landmarks)
    for f in ("dist", "hub", "highway"):
        assert getattr(lab2, f).equal(getattr(fresh, f)), f


def test_plan_cache_retiles_a_grown_snapshot_even_when_vouched():
    """A grown graph changes the slot count (or n): a prepare that vouches
    `topology_changed=False` must still retile, and a cached plan of the
    old slot count is never served to it."""
    _, _, _, gt, labt = _instance(slack=4)
    engine = RelaxEngine(block_v=16, device="cpu")
    old = engine.prepare(gt)
    for grown in (tcoo.grow(gt, capacity=gt.capacity * 2),
                  tcoo.grow(gt, n=gt.n + 8)):
        retiles, stale = engine.retile_count, engine.stale_cache_retiles
        engine.prepare(gt)            # the old snapshot's plan is current
        plan = engine.prepare(grown, topology_changed=False)
        assert plan is not old and plan.tiled.shape == grown.valid.shape
        assert engine.stale_cache_retiles == stale + 1
        assert engine.retile_count == retiles + 1
        assert plan.tiles.n == grown.n
    # Swept over the grown snapshot, the plan equals the COO path.
    snap = tsnap.grow_snapshot(tsnap.Snapshot(0, gt, labt), n=gt.n + 8)
    batch = tcoo.make_batch([(0, gt.n + 3, False)], pad_to=1, device="cpu")
    g_next = tcoo.apply_batch(snap.graph, batch)
    got = tbat.batchhl_update(snap.graph, batch, snap.labelling,
                              plan=engine.prepare(g_next), g_new=g_next)
    want = tbat.batchhl_update(snap.graph, batch, snap.labelling)
    assert got[1].dist.equal(want[1].dist) and got[2].equal(want[2])


def test_grown_state_checkpoint_roundtrip(tmp_path):
    _, gj, labj, gt, labt = _instance()
    snap = tsnap.grow_snapshot(tsnap.Snapshot(3, gt, labt),
                               capacity=gt.capacity * 3, n=gt.n + 16)
    batch = tcoo.make_batch([(0, gt.n + 5, False)], pad_to=1, device="cpu")
    g2, lab2, _ = tbat.batchhl_update(snap.graph, batch, snap.labelling)
    tsnap.save_snapshot(str(tmp_path / "ck"), tsnap.Snapshot(4, g2, lab2))
    for back in (tsnap.restore_snapshot(str(tmp_path / "ck"), device="cpu"),
                 jsnap.restore_snapshot(str(tmp_path / "ck"))):
        assert back.version == 4
        assert back.graph.capacity == gt.capacity * 3
        assert back.graph.n == gt.n + 16
        for f in ("src", "dst", "valid", "w"):
            np.testing.assert_array_equal(
                np.asarray(getattr(back.graph, f)), getattr(g2, f).numpy())
        for f in ("dist", "hub", "highway"):
            np.testing.assert_array_equal(
                np.asarray(getattr(back.labelling, f)),
                getattr(lab2, f).numpy())


def test_resume_rejects_foreign_config_checkpoint(tmp_path):
    base = dict(deg=1, landmarks=4, batches=2, batch_size=40,
                scenario="growth", capacity=96, grow=True, queries=4,
                qps=1e6, microbatch=4, quiet=True)
    ck = str(tmp_path / "ck")
    rep = ServeLoop(ServeConfig(n=80, **base, ckpt_dir=ck),
                    device="cpu").run()
    assert len(rep.growth) >= 1
    resumed = ServeLoop(ServeConfig(n=80, **base, ckpt_dir=ck, resume=True),
                        device="cpu").run()
    assert resumed.final.version == rep.final.version
    with pytest.raises(ValueError, match="n=80"):
        ServeLoop(ServeConfig(n=60, **base, ckpt_dir=ck, resume=True),
                  device="cpu").run()


# --- acceptance: a growth-scenario serve run (1/4 final capacity) ------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_growth_scenario_fresh_construction_parity(backend):
    """A `growth` run from 1/4 of its final capacity (128 → 512 over two
    growths) serves every query with staleness ≤ 1 and ends bit-identical
    to fresh construction at the final grown size."""
    cfg = ServeConfig(n=120, deg=1, landmarks=8, batches=4, batch_size=45,
                      scenario="growth", capacity=128, grow=True,
                      queries=16, qps=5000.0, microbatch=8, pipeline=True,
                      backend=backend, block_v=64, tile_shards=2,
                      quiet=True)
    loop = ServeLoop(cfg, device="cpu")
    rep = loop.run()
    assert sum(t.queries for t in rep.ticks) == cfg.batches * cfg.queries
    assert all(m.staleness <= 1 for m in rep.microbatches)
    assert len(rep.growth) >= 2
    final = rep.final
    assert final.graph.capacity == 4 * 128
    fresh_g = tcoo.from_edges(final.graph.n,
                              loop.edge_set.edges()[:, :2],
                              final.graph.capacity, device="cpu")
    assert tcoo.to_numpy_adj(fresh_g) == tcoo.to_numpy_adj(final.graph)
    fresh_lab = tcon.build_labelling(fresh_g, final.labelling.landmarks)
    for f in ("dist", "hub", "highway"):
        assert getattr(final.labelling, f).equal(getattr(fresh_lab, f)), f


# --- differential soak: 50 ticks vs the BFS oracle --------------------------

def test_differential_soak_50_ticks_with_growth():
    """50-tick random mixed stream through the port alone; every tick's
    full distance matrix against the port's BFS oracle, across >= 2
    capacity growths and one vertex growth (tick 12 wires in a new
    vertex)."""
    n0 = 40
    edges = tgen.random_connected(n0, extra_edges=20, seed=5)
    g = tcoo.from_edges(n0, edges, 64, device="cpu")
    lab = tcon.build_labelling(g, tcon.select_landmarks_by_degree(g, 4))
    snap = tsnap.Snapshot(0, g, lab)
    policy = tgrowth.GrowthPolicy(block_v=8, shards=1)
    cur = {(min(int(u), int(v)), max(int(u), int(v))) for u, v in edges}
    cap_growths = n_growths = 0
    for tick in range(50):
        cur_arr = np.asarray(sorted(cur), np.int32)
        ups = tgen.random_batch_updates(cur_arr, snap.graph.n, n_ins=4,
                                        n_del=2, seed=1000 + tick)
        if tick == 12:
            ups.append((0, snap.graph.n, False))
        batch = tcoo.make_batch(ups, pad_to=8, device="cpu")
        snap, event = tgrowth.ensure_capacity(snap, batch, policy, tick=tick)
        if event is not None:
            cap_growths += event.new_capacity > event.old_capacity
            n_growths += event.new_n > event.old_n
        g2, lab2, _ = tbat.batchhl_update(snap.graph, batch, snap.labelling)
        snap = tsnap.Snapshot(snap.version + 1, g2, lab2)
        for u, v, is_del in ups:
            k = (min(u, v), max(u, v))
            cur.discard(k) if is_del else cur.add(k)

        nn = g2.n
        qs, qt = np.meshgrid(np.arange(nn, dtype=np.int32),
                             np.arange(nn, dtype=np.int32), indexing="ij")
        got = tq.batched_query(g2, lab2, torch.from_numpy(qs.ravel()),
                               torch.from_numpy(qt.ravel())
                               ).numpy().reshape(nn, nn)
        adj = tcoo.to_numpy_adj(g2)
        for s in range(nn):
            want = [int(tcoo.INF_D) if x == tref.INF else int(x)
                    for x in tref.bfs_dist(adj, nn, s)]
            np.testing.assert_array_equal(got[s], want,
                                          err_msg=f"tick {tick} src {s}")
    assert cap_growths >= 2, cap_growths
    assert n_growths >= 1, n_growths
