"""Versioned snapshots and the pipelined update of the port against `repro`.

`pipelined_update` (every chunk size, both search variants, fused and
unfused, with and without a tiled plan, and in the frontier mode) drained
with no interleaved work must commit the labelling, graph slots and `aff`
of `repro`'s update on the same numpy inputs, bit for bit, through the
same sequence of phases as `repro`'s own pipelined update. No pipelined
update may write into a tensor of the snapshot it started from (queries
still read it), which `_version` counters pin. Also the store's contract,
the plan cache's two live snapshots, the scenario registry, and the
out-of-place aliases of the reference's donating frontier chunks
(`fused_search_chunk_frontier`, `fused_repair_chunk_frontier`).
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.core import engine as jeng
from repro.core import snapshot as jsnap
from repro.data import scenarios as jscen
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.core import engine as teng
from repro_torch.core import query as tq
from repro_torch.core import snapshot as tsnap
from repro_torch.core.engine import RelaxEngine
from repro_torch.data import scenarios as tscen
from repro_torch.graphs import coo as tcoo


@pytest.fixture(scope="module")
def inst():
    """The reference tests' instance: n = 150, 8 landmarks, 8 inserts and
    8 deletes; with its monolithic update for both search variants."""
    n = 150
    edges = jgen.random_connected(n, extra_edges=200, seed=3)
    gj = jcoo.from_edges(n, edges, edges.shape[0] + 64)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 8))
    bj = jcoo.make_batch(jgen.random_batch_updates(edges, n, n_ins=8,
                                                   n_del=8, seed=9),
                         pad_to=16)
    want = {imp: jbat.batchhl_update(gj, bj, labj, improved=imp)
            for imp in (True, False)}
    return gj, labj, bj, want


def _port(gj, labj, bj):
    return (tsnap.Snapshot(
        0, cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                               device="cpu"),
        cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                labj.highway, device="cpu")),
        cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                            bj.is_rew, device="cpu"))


def _assert_update(nxt, aff, want):
    gj, labj, affj = want
    assert nxt.version == 1
    np.testing.assert_array_equal(aff.numpy(), np.asarray(affj))
    for got, ref in zip(cv.graph_to_numpy(nxt.graph),
                        (gj.src, gj.dst, gj.valid, gj.w, gj.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    for got, ref in zip(cv.labelling_to_numpy(nxt.labelling),
                        (labj.landmarks, labj.dist, labj.hub, labj.highway)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def _drain(gen):
    """Drain a pipelined update: (phase tags, (snapshot, aff))."""
    tags = []
    while True:
        try:
            tags.append(next(gen))
        except StopIteration as stop:
            return tags, stop.value


def _tensors(snap: tsnap.Snapshot) -> dict:
    """Every tensor a query may read from `snap`, by name."""
    out = {f"graph.{k}": getattr(snap.graph, k)
           for k in ("src", "dst", "valid", "w")}
    out.update({f"lab.{k}": getattr(snap.labelling, k)
                for k in ("landmarks", "dist", "hub", "highway")})
    if snap.plan is not None:
        for part in ("tiles", "frontier"):
            obj = getattr(snap.plan, part)
            if obj is not None:
                out.update({f"{part}.{f.name}": getattr(obj, f.name)
                            for f in dataclasses.fields(obj)
                            if torch.is_tensor(getattr(obj, f.name))})
        out["plan.tiled"] = snap.plan.tiled
    return out


# --- chunked update ≡ monolithic update ------------------------------------

@pytest.mark.parametrize("improved", [True, False])
@pytest.mark.parametrize("chunk_sweeps", [1, 2, 3])
def test_pipelined_update_matches_monolithic(inst, improved, chunk_sweeps):
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    tags, (nxt, aff) = _drain(tsnap.pipelined_update(
        snap, bt, improved=improved, chunk_sweeps=chunk_sweeps))
    _assert_update(nxt, aff, want[improved])
    # The same chunks, in the same order, as the reference's generator.
    assert tags == list(jsnap.pipelined_update(
        jsnap.Snapshot(0, gj, labj, None), bj, improved=improved,
        chunk_sweeps=chunk_sweeps))


def test_pipelined_update_pallas_plan(inst):
    """The chunked path composes with a tiled plan (the kernel's plain
    version on the CPU), as the reference's does with a Pallas plan."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    g_next = tcoo.apply_batch(snap.graph, bt)
    plan = RelaxEngine(block_v=32, shards=2, device="cpu").prepare(g_next)
    nxt, aff = tsnap.run_pipelined_update(tsnap.pipelined_update(
        snap, bt, plan=plan, g_new=g_next))
    _assert_update(nxt, aff, want[True])
    assert nxt.plan is plan
    gj_next = jcoo.apply_batch(gj, bj)
    jplan = jeng.RelaxEngine(backend="pallas", block_v=32,
                             shards=2).prepare(gj_next)
    jnxt, jaff = jsnap.run_pipelined_update(jsnap.pipelined_update(
        jsnap.Snapshot(0, gj, labj, None), bj, plan=jplan, g_new=gj_next))
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    np.testing.assert_array_equal(nxt.labelling.dist.numpy(),
                                  np.asarray(jnxt.labelling.dist))


# --- fused chunks ≡ monolithic update --------------------------------------

@pytest.mark.parametrize("improved", [True, False])
@pytest.mark.parametrize("chunk_sweeps", [1, 2, 3])
def test_fused_update_matches_monolithic(inst, improved, chunk_sweeps):
    """Seed + K waves in one step, later chunks lowering the plane in
    place: bit-identical to the monolithic update for every chunk size and
    variant, through the reference's fused phase sequence."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    tags, (nxt, aff) = _drain(tsnap.pipelined_update(
        snap, bt, improved=improved, chunk_sweeps=chunk_sweeps, fused=True))
    _assert_update(nxt, aff, want[improved])
    assert tags == list(jsnap.pipelined_update(
        jsnap.Snapshot(0, gj, labj, None), bj, improved=improved,
        chunk_sweeps=chunk_sweeps, fused=True))


@pytest.mark.parametrize("impl", ["kernel", "sorted"])
def test_fused_update_pallas_plans(inst, impl):
    """Fused chunks compose with both plan impls: the kernel tiling and
    the autotuned destination-sorted one."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    g_next = tcoo.apply_batch(snap.graph, bt)
    if impl == "kernel":
        engine = RelaxEngine(block_v=32, shards=2, device="cpu")
    else:
        engine = RelaxEngine(block_v=32, autotune=True, device="cpu")
    plan = engine.prepare(g_next)
    assert plan.impl == impl
    nxt, aff = tsnap.run_pipelined_update(tsnap.pipelined_update(
        snap, bt, plan=plan, g_new=g_next, fused=True, chunk_sweeps=2))
    _assert_update(nxt, aff, want[True])


def test_fused_donation_safety(inst):
    """The fused path's in-place chunks never touch a live input: the same
    fused update twice from one snapshot gives the same bits, and the
    input labelling's values and `_version`s survive both runs."""
    gj, labj, bj, _ = inst
    snap, bt = _port(gj, labj, bj)
    before = {k: t.clone() for k, t in _tensors(snap).items()}
    versions = {k: t._version for k, t in _tensors(snap).items()}
    outs = [tsnap.run_pipelined_update(tsnap.pipelined_update(
        snap, bt, fused=True, chunk_sweeps=1)) for _ in range(2)]
    assert outs[0][1].equal(outs[1][1])
    for f in ("dist", "hub", "highway"):
        assert getattr(outs[0][0].labelling, f).equal(
            getattr(outs[1][0].labelling, f))
    for k, t in _tensors(snap).items():
        assert t.equal(before[k]) and t._version == versions[k], k


# --- the frontier mode --------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.25, 1.0])
@pytest.mark.parametrize("fused", [False, True])
def test_frontier_pipeline_matches_reference(inst, fused, threshold):
    """A frontier engine's pipelined update against `repro`'s pipelined
    update on a frontier jnp engine, and against the monolithic update:
    at threshold 0.25 this dense graph's waves overflow the row budget
    and run full, at 1.0 every wave is masked."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    g_next = tcoo.apply_batch(snap.graph, bt)
    plan = RelaxEngine(block_v=32, frontier=True, frontier_block=8,
                       frontier_threshold=threshold,
                       device="cpu").prepare(g_next)
    assert plan.frontier is not None
    teng.WAVES.clear()
    tags, (nxt, aff) = _drain(tsnap.pipelined_update(
        snap, bt, plan=plan, g_new=g_next, fused=fused, chunk_sweeps=2))
    _assert_update(nxt, aff, want[True])
    if threshold == 1.0:
        for kind in ("search_improved", "repair"):
            assert teng.WAVES[kind + ".masked"] == teng.WAVES[kind] > 0, \
                dict(teng.WAVES)
    gj_next = jcoo.apply_batch(gj, bj)
    jplan = jeng.RelaxEngine(backend="jnp", frontier=True, frontier_block=8,
                             frontier_threshold=threshold).prepare(gj_next)
    jtags, (jnxt, jaff) = _drain(jsnap.pipelined_update(
        jsnap.Snapshot(0, gj, labj, None), bj, plan=jplan, g_new=gj_next,
        fused=fused, chunk_sweeps=2))
    assert tags == jtags
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    np.testing.assert_array_equal(nxt.labelling.dist.numpy(),
                                  np.asarray(jnxt.labelling.dist))


def _frontier_plans(gj, bj, g_next, threshold):
    """The port's and the reference's frontier plans of the next graph,
    as `test_frontier_pipeline_matches_reference` makes them."""
    plan = RelaxEngine(block_v=32, frontier=True, frontier_block=8,
                       frontier_threshold=threshold,
                       device="cpu").prepare(g_next)
    gj_next = jcoo.apply_batch(gj, bj)
    jplan = jeng.RelaxEngine(backend="jnp", frontier=True, frontier_block=8,
                             frontier_threshold=threshold).prepare(gj_next)
    return plan, gj_next, jplan


def _assert_chunk(got, want):
    """A frontier chunk's (plane, front, changed), bit for bit."""
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("improved", [True, False])
@pytest.mark.parametrize("threshold", [0.25, 1.0])
def test_fused_search_chunk_frontier_matches_reference(inst, threshold,
                                                       improved):
    """`snapshot.fused_search_chunk_frontier` (the out-of-place alias)
    against the reference's donating chunk, from the same seed, 2 sweeps:
    at threshold 0.25 the waves run full, at 1.0 masked."""
    gj, labj, bj, _ = inst
    snap, bt = _port(gj, labj, bj)
    g_next = tcoo.apply_batch(snap.graph, bt)
    plan, gj_next, jplan = _frontier_plans(gj, bj, g_next, threshold)
    lab = snap.labelling
    seed, seeded, bound, hub_mask = tsnap.search_seed(
        g_next, bt, lab.dist, lab.hub, lab.landmarks, improved)
    got = tsnap.fused_search_chunk_frontier(
        g_next, seed.clone(), tsnap.frontier_seed_blocks(plan, seeded), seed,
        bound, hub_mask, plan, improved, 2)
    jseed, jseeded, jbound, jhub_mask = jsnap.search_seed(
        gj_next, bj, labj.dist, labj.hub, labj.landmarks, improved)
    np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
    want = jsnap.fused_search_chunk_frontier(
        gj_next, jseed + 0, jsnap.frontier_seed_blocks(jplan, jseeded), jseed,
        jbound, jhub_mask, jplan, improved=improved, sweeps=2)
    _assert_chunk(got, want)


@pytest.mark.parametrize("threshold", [0.25, 1.0])
def test_fused_repair_chunk_frontier_matches_reference(inst, threshold):
    """`snapshot.fused_repair_chunk_frontier` (the out-of-place alias)
    against the reference's donating chunk, from the repair start of the
    reference's affected set, 2 sweeps."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    g_next = tcoo.apply_batch(snap.graph, bt)
    plan, gj_next, jplan = _frontier_plans(gj, bj, g_next, threshold)
    lab = snap.labelling
    affj = want[True][2]
    aff = torch.from_numpy(np.array(affj))
    hub_mask = tsnap.search_seed(g_next, bt, lab.dist, lab.hub,
                                 lab.landmarks)[3]
    cur, front = tsnap.repair_start_frontier(g_next, aff, lab.dist, lab.hub,
                                             hub_mask, plan)
    got = tsnap.fused_repair_chunk_frontier(g_next, cur, front, aff,
                                            hub_mask, plan, 2)
    jhub_mask = jsnap.search_seed(gj_next, bj, labj.dist, labj.hub,
                                  labj.landmarks)[3]
    jcur, jfront = jsnap.repair_start_frontier(gj_next, affj, labj.dist,
                                               labj.hub, jhub_mask, jplan)
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
    _assert_chunk(got, jsnap.fused_repair_chunk_frontier(
        gj_next, jcur, jfront, affj, jhub_mask, jplan, sweeps=2))


@pytest.mark.parametrize("mode", ["unfused", "fused", "frontier",
                                  "frontier-fused"])
def test_committed_snapshot_is_never_written(inst, mode):
    """Queries read the committed snapshot while the update runs: no chunk
    may write into any of its tensors, the plan's included."""
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    engine = RelaxEngine(block_v=32, frontier=mode.startswith("frontier"),
                         frontier_block=8, device="cpu")
    snap = dataclasses.replace(snap, plan=engine.prepare(snap.graph))
    versions = {k: t._version for k, t in _tensors(snap).items()}
    g_next = tcoo.apply_batch(snap.graph, bt)
    gen = tsnap.pipelined_update(snap, bt, plan=engine.prepare(g_next),
                                 g_new=g_next, fused=mode.endswith("fused"))
    qs = torch.arange(0, 150, 7, dtype=torch.int32)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            nxt, aff = stop.value
            break
        # A query microbatch against the committed snapshot at every yield.
        tq.batched_query(snap.graph, snap.labelling, qs, qs.flip(0),
                         plan=snap.plan)
    _assert_update(nxt, aff, want[True])
    assert {k: t._version for k, t in _tensors(snap).items()} == versions


def test_mesh_is_not_ported(inst):
    """`mesh=` runs the chunks' mesh twins: on the CPU's 1×1 host mesh the
    update equals the unsharded one (every factorisation is in
    `tests/test_torch_shard_pipeline.py`)."""
    from repro_torch.launch.mesh import make_host_mesh
    gj, labj, bj, want = inst
    snap, bt = _port(gj, labj, bj)
    nxt, aff = tsnap.run_pipelined_update(tsnap.pipelined_update(
        snap, bt, mesh=make_host_mesh(device="cpu")))
    _assert_update(nxt, aff, want[True])


# --- store and plan cache ------------------------------------------------------

def test_snapshot_store_contract(inst):
    snap, _ = _port(*inst[:3])
    store = tsnap.SnapshotStore(snap)
    assert store.version == 0
    with pytest.raises(ValueError, match="contiguous"):
        store.commit(dataclasses.replace(snap, version=2))
    store.commit(dataclasses.replace(snap, version=1))
    assert store.committed.version == 1


def test_engine_plan_cache_keeps_two_snapshots(inst):
    """Alternating prepares between the pipeline's two live snapshots hit
    the keyed cache instead of retiling."""
    snap, bt = _port(*inst[:3])
    g, g2 = snap.graph, tcoo.apply_batch(snap.graph, bt)
    engine = RelaxEngine(block_v=32, device="cpu")
    p0, p1 = engine.prepare(g), engine.prepare(g2)
    assert engine.retile_count == 2 and engine.plan_cache_hits == 0
    p0b, p1b = engine.prepare(g), engine.prepare(g2)
    assert engine.retile_count == 2, "keyed cache missed a live snapshot"
    assert engine.plan_cache_hits == 2
    assert p0b.tiles is p0.tiles and p1b.tiles is p1.tiles


# --- scenarios -------------------------------------------------------------------

def test_scenario_registry():
    """The port's registry is the reference's: the same scenarios and
    fields, the same batches' mix and the same query draws."""
    assert set(tscen.SCENARIOS) == set(jscen.SCENARIOS) == {
        "mixed", "insert-heavy", "delete-heavy", "bursty", "skewed",
        "growth", "traffic"}
    for name, sc in tscen.SCENARIOS.items():
        assert dataclasses.asdict(sc) == dataclasses.asdict(
            jscen.SCENARIOS[name])
        for tick in range(6):
            assert sc.update_counts(tick, 100) == \
                jscen.SCENARIOS[name].update_counts(tick, 100)
        got = sc.sample_queries(np.random.default_rng(5), 50, 64)
        ref = jscen.SCENARIOS[name].sample_queries(np.random.default_rng(5),
                                                   50, 64)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert tscen.get_scenario("growth").update_counts(0, 100) == (100, 0, 0)
    with pytest.raises(ValueError, match="unknown scenario"):
        tscen.get_scenario("nope")
    bursty = tscen.get_scenario("bursty")
    assert bursty.update_counts(0, 100) == (50, 50, 0)
    assert sum(bursty.update_counts(1, 100)) == 10
    traffic = tscen.get_scenario("traffic")
    assert traffic.update_counts(4, 100) == (0, 0, 100)
    qs, qt = tscen.get_scenario("skewed").sample_queries(
        np.random.default_rng(0), 50, 256)
    assert qs.min() >= 0 and qs.max() < 50 and qt.max() < 50
    assert np.mean(qs < 5) > np.mean(qt < 5)
