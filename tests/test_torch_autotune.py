"""The port's autotuner and `sorted` impl against `repro`, bit for bit.

Mirrors `tests/test_autotune.py` (the measurement discipline, the tuning
table's round trip, its key by snapshot shape, growth re-tuning and the
plan cache's two-live-snapshot pattern) and `tests/test_kernel_tuning.py`
(every config the tuner may emit gives the same planes as the COO path
and `repro`'s jnp sweep). Also: a tuning table written by either package
loads in the other, byte for byte; the autotuned serve loop commits
`repro`'s autotuned loop's snapshots; and an adopted kernel winner sets
the loop's growth alignment. On the CPU the tuner's only candidate is
`sorted`; the kernel configs run kernel A's plain twin.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses
import filecmp
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import engine as jeng
from repro.graphs.coo import Graph as JGraph
from repro.kernels.edge_relax import ops as jops
from repro.launch import serve as jserve
from repro_torch.core import autotune as at
from repro_torch.core import engine as teng
from repro_torch.core.construct import (build_labelling,
                                        select_landmarks_by_degree)
from repro_torch.core.engine import RelaxEngine
from repro_torch.core.labelling import INF_KEY2
from repro_torch.core.snapshot import Snapshot, grow_snapshot
from repro_torch.graphs import generators as gen
from repro_torch.graphs.coo import (Graph, apply_batch, from_edges, grow,
                                    make_batch)
from repro_torch.kernels.edge_relax import kernel
from repro_torch.kernels.edge_relax import ops as er_ops
from repro_torch.launch.serve import ServeConfig, ServeLoop

import _sweep_cases as cases

INF32 = at.INF32


def _graph(n=90, extra=80, slack=40, seed=5):
    edges = gen.random_connected(n, extra_edges=extra, seed=seed)
    return from_edges(n, edges, edges.shape[0] + slack, device="cpu"), edges


def _engine(**kw):
    return RelaxEngine(block_v=32, shards=2, autotune=True, device="cpu",
                       **kw)


# --- measurement discipline -------------------------------------------------

def test_measure_compiled_call_accounting():
    """First call timed apart, `warmup` discarded, steady = min over
    `iters`: 1 + warmup + iters calls in all."""
    calls = []

    def fn(x):
        calls.append(1)
        return torch.as_tensor(x) + 1

    compile_us, steady_us = at.measure_compiled(fn, 3, warmup=2, iters=4)
    assert len(calls) == 1 + 2 + 4
    assert compile_us >= 0 and steady_us >= 0


def test_tune_returns_winner_from_candidate_space():
    g, _ = _graph(n=60, extra=40, slack=20)
    res = at.tune(g, shards=2, block_v=32, include_kernel=False, iters=2)
    assert res.config == at.TuneConfig("sorted", 32, None, 2)
    assert res.steady_us > 0 and res.jnp_us > 0 and res.compile_us > 0
    assert [c for c, _, _ in res.candidates] == [res.config]
    assert res.wall_s > 0
    # The same wave inputs as the reference's, drawn from the same seed.
    keys, hub = at._sweep_inputs(g, 8)
    jkeys, jhub = jat._sweep_inputs(JGraph(*(jnp.asarray(x.numpy()) for x in
                                             (g.src, g.dst, g.valid, g.w)),
                                           g.n), 8)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(hub.numpy(), np.asarray(jhub))


# --- table round trip: persist, reload, same plan, no re-tune ---------------

def test_table_roundtrip_zero_retune(tmp_path):
    g, _ = _graph()
    path = str(tmp_path / "tuning.json")

    e1 = _engine(tune_table=path)
    p1 = e1.prepare(g)
    assert e1.tune_count == 1
    assert p1.impl == "sorted" and p1.sorted_tiles is not None
    assert p1.tiles is None

    with open(path) as f:
        doc = json.load(f)
    key = at.table_key(g.n, g.src.shape[0], 2)
    assert doc["version"] == 1 and key in doc["entries"]
    assert doc["entries"][key]["config"] == e1._tuned_cfg.to_dict()

    e2 = _engine(tune_table=path)
    p2 = e2.prepare(g)
    assert e2.tune_count == 0, "a table reload must skip the tuner"
    assert p2.impl == p1.impl
    assert torch.equal(p2.sorted_tiles.perm_s, p1.sorted_tiles.perm_s)
    assert at.TuneTable(path).get(key) == e2._tuned_cfg == e1._tuned_cfg
    # The sorted order is the reference's.
    np.testing.assert_array_equal(
        p1.sorted_tiles.perm_s.numpy(),
        np.asarray(jops.prepare_sorted(
            g.src.numpy(), g.dst.numpy(), g.valid.numpy(), g.n).perm_s))


def test_edge_churn_at_fixed_shape_reuses_winner():
    g, edges = _graph()
    ups = gen.random_batch_updates(edges, g.n, n_ins=6, n_del=6, seed=9)
    g2 = apply_batch(g, make_batch(ups, pad_to=12, device="cpu"))
    assert g2.src.shape[0] == g.src.shape[0]
    e = _engine()
    e.prepare(g)
    e.prepare(g2)
    assert e.tune_count == 1
    assert e.retile_count == 2
    assert len(e.tune_table) == 1


# --- growth changes the key and re-tunes ------------------------------------

def test_grow_changes_table_key_and_retunes():
    g, _ = _graph()
    e = _engine()
    e.prepare(g)
    assert e.tune_count == 1
    g_cap = grow(g, capacity=g.capacity + 32)
    e.prepare(g_cap)
    assert e.tune_count == 2, "a grown capacity must tune again"
    g_n = grow(g_cap, n=g.n + 32)
    e.prepare(g_n)
    assert e.tune_count == 3, "a grown n must tune again"
    keys = {at.table_key(x.n, x.src.shape[0], 2) for x in (g, g_cap, g_n)}
    assert len(keys) == 3 and set(e.tune_table.entries) == keys


def test_grow_snapshot_retunes():
    g, _ = _graph(n=70, extra=50, slack=24)
    lab = build_labelling(g, select_landmarks_by_degree(g, 4))
    e = RelaxEngine(block_v=32, autotune=True, device="cpu")
    e.prepare(g)
    snap = grow_snapshot(Snapshot(0, g, lab, None),
                         capacity=g.capacity + 24, n=g.n + 2)
    e.prepare(snap.graph)
    assert e.tune_count == 2
    assert len(e.tune_table) == 2


# --- the plan cache's two-live-snapshot pattern -----------------------------

def test_two_live_snapshots_alternate_without_retuning():
    g, edges = _graph()
    ups = gen.random_batch_updates(edges, g.n, n_ins=5, n_del=5, seed=2)
    g2 = apply_batch(g, make_batch(ups, pad_to=10, device="cpu"))
    e = _engine()
    pa = e.prepare(g)
    pb = e.prepare(g2)
    assert e.tune_count == 1 and e.retile_count == 2
    pa2 = e.prepare(g)
    pb2 = e.prepare(g2)
    assert e.retile_count == 2, "the keyed cache missed a live snapshot"
    assert e.plan_cache_hits == 2 and e.tune_count == 1
    assert pa2.sorted_tiles is pa.sorted_tiles
    assert pb2.sorted_tiles is pb.sorted_tiles


def test_lru_eviction_respects_tuned_key():
    """Eviction past the cache's two plans re-tunes nothing for a known
    shape, and the key carries the tuned config: a plan prepared under
    one winner is never served under another."""
    g, edges = _graph()
    ups = gen.random_batch_updates(edges, g.n, n_ins=4, n_del=4, seed=3)
    g2 = apply_batch(g, make_batch(ups, pad_to=8, device="cpu"))
    ups2 = gen.random_batch_updates(edges, g.n, n_ins=3, n_del=3, seed=4)
    g3 = apply_batch(g, make_batch(ups2, pad_to=8, device="cpu"))
    e = _engine()
    for snap in (g, g2, g3):
        e.prepare(snap)
    assert e.tune_count == 1 and e.retile_count == 3
    e.prepare(g)
    assert e.retile_count == 4 and e.tune_count == 1
    # Another winner for the same shape: the cached sorted plan is not
    # served for it.
    key = at.table_key(g.n, g.src.shape[0], 2)
    e.tune_table.entries[key]["config"] = at.TuneConfig(
        "kernel", 16, 7, 2).to_dict()
    plan = e.prepare(g)
    assert plan.impl == "kernel" and plan.tiles.block_v == 16
    assert e.retile_count == 5 and e.tune_count == 1
    assert (e.block_v, e.block_e, e.plan_alignment) == (16, 7, 32)


# --- the tuning table across packages ---------------------------------------

def test_tune_table_is_shared_between_packages(tmp_path):
    """The same entries make byte-identical files in both packages, and a
    table written by either loads in the other with equal configs."""
    entries = [("n=90,cap=460,s=2", ("sorted", 32, None, 2, None),
                (12.345, 678.91, 40.05)),
               ("n=128,cap=1024,s=1", ("kernel", 256, 1024, 1, 0.125),
                (3.06, 9999.96, 17.0)),
               ("n=64,cap=64,s=1", ("kernel", 128, None, 1, None),
                (1.0, 2.0, 3.0))]
    paths = {}
    for name, mod in (("port", at), ("ref", jat)):
        paths[name] = str(tmp_path / f"{name}.json")
        table = mod.TuneTable(paths[name])
        for key, cfg, (steady, comp, jnp_us) in entries:
            table.put(key, mod.TuneResult(mod.TuneConfig(*cfg), steady,
                                          comp, jnp_us, ()))
    assert filecmp.cmp(paths["port"], paths["ref"], shallow=False)
    for key, cfg, _ in entries:
        got = at.TuneTable(paths["ref"]).get(key)
        want = jat.TuneTable(paths["port"]).get(key)
        assert got == at.TuneConfig(*cfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --- every config the tuner may emit ----------------------------------------

def _topology(n=61, m=240, seed=0, planes=3):
    """Slots with capacity slack and per-sweep churn (`keep` at prepare
    time, `mask` of one sweep), n=61 leaving a ragged tail block."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = rng.random(m) < 0.8
    mask = keep & (rng.random(m) < 0.85)
    w = rng.integers(1, 9, m).astype(np.int32)
    keys = rng.integers(0, 2 * n, (planes, n)).astype(np.int32)
    hub = rng.random((planes, n)) < 0.3
    return src, dst, keep, mask, w, keys, hub


def _port_sweep(cfg, src, dst, keep, mask, w, keys, hub, n, step, clear):
    """The sweep of config `cfg` on the CPU: the sorted impl, or kernel A's
    plain twin on the config's tiling."""
    t = torch.from_numpy
    hub_t = None if hub is None else t(hub)
    if cfg.impl == "sorted":
        sg = er_ops.prepare_sorted(src, dst, keep, n, device="cpu")
        return er_ops.relax_sweep_sorted(t(keys), sg, t(mask), step, INF32,
                                         clear_bit=clear, hub=hub_t, w=t(w))
    bg = er_ops.prepare_topology(src, dst, keep, n, cfg.block_v,
                                 cfg.tile_shards, cfg.block_e, device="cpu")
    return er_ops.relax_sweep(t(keys), bg, t(mask), step, INF32,
                              clear_bit=clear, hub=hub_t, w=t(w))


def _want(src, dst, mask, w, keys, hub, n, step, clear):
    """(the port's COO path, `repro`'s jnp engine branch vmapped)."""
    t = torch.from_numpy
    g = Graph(t(src), t(dst), t(mask), t(w), n)
    coo = teng.relax_sweep(None, g, t(keys), step, INF32,
                           hub=None if hub is None else t(hub),
                           clear_bit=clear).numpy()
    jg = JGraph(*(jnp.asarray(x) for x in (src, dst, mask, w)), n)
    if hub is None:
        ref = jax.vmap(lambda k: jeng.relax_sweep(
            jeng.JNP_PLAN, jg, k, step, INF32))(jnp.asarray(keys))
    else:
        ref = jax.vmap(lambda k, h: jeng.relax_sweep(
            jeng.JNP_PLAN, jg, k, step, INF32, hub=h, clear_bit=clear))(
            jnp.asarray(keys), jnp.asarray(hub))
    return coo, np.asarray(ref)


_SPACE = at.candidate_space(shards=2, block_v=32, include_kernel=True)


@pytest.fixture(scope="module")
def topology_want():
    src, dst, keep, mask, w, keys, hub = _topology()
    return (src, dst, keep, mask, w, keys, hub), \
        _want(src, dst, mask, w, keys, hub, 61, 2, 1)


@pytest.mark.parametrize(
    "cfg", _SPACE,
    ids=[f"{c.impl}-bv{c.block_v}-be{c.block_e}-ts{c.tile_shards}"
         for c in _SPACE])
def test_candidate_space_bit_parity(topology_want, cfg):
    """Each config the tuner may emit with the kernel grid on (as on the
    card) equals the COO path and `repro`'s jnp sweep, block_v > n single
    block tilings included."""
    (src, dst, keep, mask, w, keys, hub), (coo, ref) = topology_want
    got = _port_sweep(cfg, src, dst, keep, mask, w, keys, hub, 61, 2,
                      1).numpy()
    np.testing.assert_array_equal(got, coo)
    np.testing.assert_array_equal(got, ref)


def test_candidate_space_shape_off_cuda():
    """Off CUDA the tuner emits the sorted impl alone; the grid is the
    reference's, and every config survives the table's JSON."""
    space = at.candidate_space(shards=2, block_v=64, include_kernel=False)
    assert space == [at.TuneConfig("sorted", 64, None, 2)]
    assert at.candidate_space(2, 64, device="cpu") == space
    for cfg in at.candidate_space(shards=4, block_v=128, include_kernel=True):
        assert cfg.impl in ("kernel", "sorted")
        assert at.TuneConfig.from_dict(cfg.to_dict()) == cfg
    assert [c.to_dict() for c in at.candidate_space(4, 128, True)] == \
        [c.to_dict() for c in jat.candidate_space(4, 128, True)]


@pytest.mark.parametrize("impl", ["kernel", "sorted"])
def test_no_hub_plain_relaxation(impl):
    """hub None, step 1 (construction-free BiBFS waves)."""
    src, dst, keep, mask, w, keys, _ = _topology(seed=11)
    cfg = at.TuneConfig(impl, 16, 7 if impl == "kernel" else None, 2)
    got = _port_sweep(cfg, src, dst, keep, mask, w, keys, None, 61, 1, 0)
    coo, ref = _want(src, dst, mask, w, keys, None, 61, 1, 0)
    np.testing.assert_array_equal(got.numpy(), coo)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("impl", ["kernel", "sorted"])
def test_all_edges_masked_out(impl):
    """An empty mask gives all-inf planes: no fill value leaks."""
    src, dst, keep, _, w, keys, hub = _topology(seed=13)
    cfg = (at.TuneConfig("sorted", 16, None, 1) if impl == "sorted"
           else at.TuneConfig("kernel", 16, 7, 2))
    got = _port_sweep(cfg, src, dst, keep, np.zeros_like(keep), w, keys, hub,
                      61, 2, 1)
    np.testing.assert_array_equal(got.numpy(), np.full((3, 61), INF32))


def test_sorted_impl_on_the_engine_path():
    """A sorted plan through `engine.relax_sweep`, per-plane mask and
    zero capacity included, equals the COO path."""
    src, dst, keep, mask, w, keys, hub = _topology(seed=21)
    masks = np.stack([mask, keep, np.zeros_like(keep)])
    g = Graph(*(torch.from_numpy(x) for x in (src, dst, keep, w)), 61)
    plan = _engine().prepare(g)
    assert plan.impl == "sorted"
    for m in (torch.from_numpy(mask), torch.from_numpy(masks)):
        got = teng.relax_sweep(plan, g, torch.from_numpy(keys), 2, INF_KEY2,
                               hub=torch.from_numpy(hub), clear_bit=1,
                               edge_mask=m)
        want = teng.relax_sweep(None, g, torch.from_numpy(keys), 2, INF_KEY2,
                                hub=torch.from_numpy(hub), clear_bit=1,
                                edge_mask=m)
        assert torch.equal(got, want)
    empty = Graph(*(torch.zeros(0, dtype=d) for d in
                    (torch.int32, torch.int32, torch.bool, torch.int32)), 5)
    sg = er_ops.prepare_sorted(np.zeros(0), np.zeros(0), np.zeros(0, bool), 5,
                               device="cpu")
    out = er_ops.relax_sweep_sorted(torch.zeros((2, 5), dtype=torch.int32),
                                    sg, empty.valid, 1, INF32, w=empty.w)
    assert torch.equal(out, torch.full((2, 5), INF32, dtype=torch.int32))


@pytest.mark.parametrize("name", cases.names())
def test_sorted_impl_sweep_edge_cases(name):
    """The sorted impl over every sweep of `tests/_sweep_cases.py` (the
    cases the card holds it to kernel A on) equals kernel A's plain twin
    on the CPU."""
    for c in cases.make(name, max_edges=4096):
        args = cases.sweep_args(c, "cpu")
        sg = er_ops.prepare_sorted(c.src, c.dst, c.keep, c.n, device="cpu")
        got = er_ops.relax_sweep_sorted(args[0], sg, args[7], c.step, c.inf,
                                        clear_bit=c.clear, hub=args[1],
                                        w=args[8])
        assert torch.equal(got, kernel.relax_sweep_plain(*args)), c.label


# --- the autotuned serve loop ------------------------------------------------

SERVE = dict(n=200, deg=3, landmarks=8, batches=3, batch_size=20, queries=8,
             qps=5000.0, microbatch=8, quiet=True, block_v=64)


def _assert_snapshot(got, want):
    assert got.version == want.version and got.graph.n == want.graph.n
    for f in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(getattr(got.graph, f).numpy(),
                                      np.asarray(getattr(want.graph, f)))
    for f in ("landmarks", "dist", "hub", "highway"):
        np.testing.assert_array_equal(getattr(got.labelling, f).numpy(),
                                      np.asarray(getattr(want.labelling, f)))


def test_autotuned_serve_loop_matches_reference(tmp_path):
    """The port's autotuned loop commits the snapshots of its loop without
    autotune and of `repro`'s autotuned loop; a restart on the same table
    tunes nothing."""
    table = str(tmp_path / "port.json")
    loop = ServeLoop(ServeConfig(**SERVE, autotune=True, tune_table=table),
                     device="cpu")
    rep = loop.run()
    assert loop.engine.tune_count == 1 and loop.engine._tuned_cfg.impl == \
        "sorted"
    plain = ServeLoop(ServeConfig(**SERVE), device="cpu").run()
    _assert_snapshot(rep.final, plain.final)
    ref_loop = jserve.ServeLoop(jserve.ServeConfig(
        **SERVE, backend="pallas", autotune=True,
        tune_table=str(tmp_path / "ref.json")))
    want = ref_loop.run()
    assert ref_loop.engine.tune_count == 1
    _assert_snapshot(rep.final, want.final)
    again = ServeLoop(ServeConfig(**SERVE, autotune=True, tune_table=table),
                      device="cpu")
    _assert_snapshot(again.run().final, want.final)
    assert again.engine.tune_count == 0
    # Both tables hold the same key and winner.
    assert at.TuneTable(table).entries.keys() == \
        jat.TuneTable(str(tmp_path / "ref.json")).entries.keys()


def test_adopted_kernel_winner_sets_growth_alignment(tmp_path):
    """A table whose winner is a kernel config at block_v 16: the loop's
    engine adopts it, the growth policy aligns to 16 · shards (not the
    config's 64), and the committed snapshots are the loop's without
    autotune."""
    cfg = dict(SERVE, capacity=600, batches=2)
    table = at.TuneTable(str(tmp_path / "t.json"))
    table.put(at.table_key(200, 1200, 1),
              at.TuneResult(at.TuneConfig("kernel", 16, 7, 1), 1.0, 1.0, 1.0,
                            ()))
    loop = ServeLoop(ServeConfig(**cfg, autotune=True,
                                 tune_table=table.path), device="cpu")
    rep = loop.run()
    assert loop.engine.tune_count == 0
    assert (loop.engine.block_v, loop.engine.block_e) == (16, 7)
    pol = loop.growth_policy
    assert (pol.block_v, pol.shards) == (16, 1)
    assert rep.final.plan.impl == "kernel" and \
        rep.final.plan.tiles.block_v == 16
    _assert_snapshot(rep.final, ServeLoop(ServeConfig(**cfg),
                                          device="cpu").run().final)
