"""The port's serving loop against `repro`'s, and its own serving contract.

For the scenarios `mixed`, `growth` (capacity below the final size,
grow-in-place on) and `traffic` (weighted road grid), the port's loop in
sync and in pipeline mode commits, version by version, the snapshots
`repro`'s loop commits (graph slots, dist, hub, highway, version), with
the same growth events and tick statistics. Microbatch composition
follows the wall clock, so it is never compared across runs; instead
every answer the port served is recomputed on the COO path at the
version that served it. Also the pipeline's staleness contract, resume
from a checkpoint, the scenarios end to end, the `ServeSpec` round trips
between the packages, `api.serve` and the CLI.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.launch import config as jconfig
from repro.launch import serve as jserve
from repro_torch import api
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import query as tq
from repro_torch.graphs import coo as tcoo
from repro_torch.launch import config as tconfig
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.serve import ServeConfig, ServeLoop

BASE = dict(n=200, deg=3, landmarks=8, batches=3, batch_size=20, queries=16,
            qps=5000.0, microbatch=8, quiet=True, keep_history=True)
SCENARIOS = {
    "mixed": dict(),
    "growth": dict(scenario="growth", capacity=600, grow=True),
    "traffic": dict(scenario="traffic", graph="road"),
}


@pytest.fixture(scope="module")
def reference():
    """`repro`'s loop (its jnp backend, sync mode) for each scenario."""
    return {name: jserve.ServeLoop(jserve.ServeConfig(**BASE, **extra)).run()
            for name, extra in SCENARIOS.items()}


def _assert_snapshot(got, want):
    assert got.version == want.version and got.graph.n == want.graph.n
    for f in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(getattr(got.graph, f).numpy(),
                                      np.asarray(getattr(want.graph, f)))
    for f in ("landmarks", "dist", "hub", "highway"):
        np.testing.assert_array_equal(getattr(got.labelling, f).numpy(),
                                      np.asarray(getattr(want.labelling, f)))


def _assert_exact_at_version(rep):
    """Every served answer equals the COO path's at the version that
    served it."""
    assert sum(m.qs.shape[0] for m in rep.microbatches) == \
        rep.config.batches * rep.config.queries
    for m in rep.microbatches:
        snap = rep.history[m.version]
        want = tq.batched_query(snap.graph, snap.labelling,
                                torch.from_numpy(m.qs),
                                torch.from_numpy(m.qt), plan=None)
        np.testing.assert_array_equal(m.answers, want.numpy())


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_serve_loop_matches_reference(reference, scenario, pipeline):
    cfg = ServeConfig(**BASE, **SCENARIOS[scenario], pipeline=pipeline,
                      block_v=64)
    want = reference[scenario]
    rep = ServeLoop(cfg, device="cpu").run()
    assert rep.backend == "plain"
    assert cfg.n == want.config.n    # road rounds n up to rows·cols
    _assert_snapshot(rep.final, want.final)
    assert sorted(rep.history) == sorted(want.history) == [0, 1, 2, 3]
    for v in rep.history:
        _assert_snapshot(rep.history[v], want.history[v])
    assert [dataclasses.asdict(e) for e in rep.growth] == \
        [dataclasses.asdict(e) for e in want.growth]
    if scenario == "growth":
        assert rep.growth and rep.final.graph.capacity > 600
    for t, tw in zip(rep.ticks, want.ticks, strict=True):
        assert (t.version, t.affected, t.label_size, t.queries, t.grew,
                t.capacity, t.graph_n) == \
            (tw.version, tw.affected, tw.label_size, tw.queries, tw.grew,
             tw.capacity, tw.graph_n)
    _assert_exact_at_version(rep)


# --- pipelined serving: exact at the served version ------------------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_pipeline_serving_exact_at_version(backend):
    cfg = ServeConfig(n=200, deg=3, landmarks=8, batches=3, batch_size=20,
                      queries=24, qps=5000.0, microbatch=8, pipeline=True,
                      backend=backend, block_v=64, tile_shards=2,
                      quiet=True, keep_history=True)
    rep = ServeLoop(cfg, device="cpu").run()
    assert rep.backend == ("coo" if backend == "jnp" else "plain")
    _assert_exact_at_version(rep)
    assert any(m.staleness == 1 for m in rep.microbatches)
    assert all(m.staleness in (0, 1) for m in rep.microbatches)


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_and_sync_commit_identical_labellings(fused):
    """Same stream, both modes: every committed version is bit-equal; the
    pipeline changes when queries are answered, never the data."""
    base = dict(BASE, queries=16, chunk_sweeps=2)
    rep_s = ServeLoop(ServeConfig(**base), device="cpu").run()
    rep_p = ServeLoop(ServeConfig(**base, pipeline=True, fused=fused),
                      device="cpu").run()
    assert rep_s.final.version == rep_p.final.version == 3
    for v in range(4):
        for f in ("dist", "hub", "highway"):
            assert getattr(rep_s.history[v].labelling, f).equal(
                getattr(rep_p.history[v].labelling, f))
        assert rep_s.history[v].graph.valid.equal(
            rep_p.history[v].graph.valid)
    np.testing.assert_array_equal(
        np.concatenate([m.qs for m in rep_s.microbatches]),
        np.concatenate([m.qs for m in rep_p.microbatches]))
    assert all(m.staleness == 0 for m in rep_s.microbatches)


# --- checkpoint / resume ---------------------------------------------------

def test_save_restore_resume_exact(tmp_path):
    """Interrupt after 2 of 4 ticks, resume in a fresh loop: identical
    final labelling, edge set, version and per-query answers."""
    base = dict(n=200, deg=3, landmarks=8, batches=4, batch_size=20,
                queries=12, qps=5000.0, microbatch=8, quiet=True, seed=3)
    rep_a = ServeLoop(ServeConfig(**base, ckpt_dir=str(tmp_path / "a")),
                      device="cpu").run()
    ServeLoop(ServeConfig(**{**base, "batches": 2},
                          ckpt_dir=str(tmp_path / "b")), device="cpu").run()
    rep_b = ServeLoop(ServeConfig(**base, ckpt_dir=str(tmp_path / "b"),
                                  resume=True), device="cpu").run()
    assert rep_a.final.version == rep_b.final.version == 4
    assert all(t.ckpt_s > 0 for t in rep_a.ticks)
    for f in ("dist", "hub", "highway"):
        assert getattr(rep_a.final.labelling, f).equal(
            getattr(rep_b.final.labelling, f))
    assert tcoo.to_numpy_adj(rep_a.final.graph) == \
        tcoo.to_numpy_adj(rep_b.final.graph)
    a_tail = [m for m in rep_a.microbatches if m.tick >= 2]
    b_tail = [m for m in rep_b.microbatches if m.tick >= 2]
    np.testing.assert_array_equal(np.concatenate([m.qs for m in a_tail]),
                                  np.concatenate([m.qs for m in b_tail]))
    np.testing.assert_array_equal(
        np.concatenate([m.answers for m in a_tail]),
        np.concatenate([m.answers for m in b_tail]))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's serve loop writes two ticks, the port's resumes for
    the third: the same final state as the reference's uninterrupted
    run (the edge list and base n ride in the checkpoint)."""
    base = dict(n=200, deg=3, landmarks=8, batch_size=20, queries=8,
                qps=5000.0, microbatch=8, quiet=True, capacity=700)
    ck = str(tmp_path / "ck")
    jserve.ServeLoop(jserve.ServeConfig(**base, batches=2,
                                        ckpt_dir=ck)).run()
    rep = ServeLoop(ServeConfig(**base, batches=3, ckpt_dir=ck, resume=True),
                    device="cpu").run()
    want = jserve.ServeLoop(jserve.ServeConfig(**base, batches=3)).run()
    _assert_snapshot(rep.final, want.final)


@pytest.mark.parametrize("scenario", ["mixed", "traffic"])
def test_serve_checkpoints_are_byte_identical(tmp_path, scenario):
    """Both loops checkpoint every tick; each `step_<v>` tree, the edge
    list in serve order and the base n included, is the same bytes."""
    cfg = dict(BASE, **SCENARIOS[scenario], batches=2, keep_history=False)
    jserve.ServeLoop(jserve.ServeConfig(
        **cfg, ckpt_dir=str(tmp_path / "j"))).run()
    ServeLoop(ServeConfig(**cfg, ckpt_dir=str(tmp_path / "t")),
              device="cpu").run()
    for step in ("step_1", "step_2"):
        names = sorted(os.listdir(tmp_path / "j" / step))
        assert names == sorted(os.listdir(tmp_path / "t" / step))
        assert "edge_list.npy" in names and "base_n.npy" in names
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "j" / step, tmp_path / "t" / step, names,
            shallow=False)
        assert mismatch == errors == [] and sorted(match) == names


def test_edge_set_folds_as_the_reference_list():
    """`EdgeSet` keeps the reference loop's swap-remove list order and
    weights under inserts, deletes (present or not) and re-weights."""
    rng = np.random.default_rng(0)
    edges = np.concatenate([jgen.random_connected(30, 40, seed=1)[:60],
                            rng.integers(1, 9, (60, 1))], 1)
    es = tserve.EdgeSet(edges)
    lst = [(min(u, v), max(u, v)) for u, v in edges[:, :2].tolist()]
    pos = {e: i for i, e in enumerate(lst)}
    wts = dict(zip(lst, edges[:, 2].tolist()))
    for tick in range(20):
        ups = [(int(rng.integers(30)), int(rng.integers(30)),
                int(rng.integers(3)), int(rng.integers(1, 9)))
               for _ in range(12)]
        es.apply(ups)
        for u, v, op, w in ups:     # the reference loop's fold
            k = (min(u, v), max(u, v))
            if op == 1:
                i = pos.pop(k, None)
                if i is not None:
                    wts.pop(k)
                    last = lst.pop()
                    if i < len(lst):
                        lst[i] = last
                        pos[last] = i
            elif op == 2:
                if k in pos:
                    wts[k] = w
            elif k not in pos:
                pos[k] = len(lst)
                lst.append(k)
                wts[k] = w
        assert es.edges().tolist() == [[u, v, wts[u, v]] for u, v in lst]
        assert es.pos == pos


def test_scenarios_run_end_to_end():
    for name in ("insert-heavy", "delete-heavy", "bursty", "skewed"):
        cfg = ServeConfig(n=120, deg=3, landmarks=4, batches=2,
                          batch_size=12, queries=8, qps=5000.0,
                          microbatch=8, scenario=name, pipeline=True,
                          quiet=True, keep_history=True)
        rep = ServeLoop(cfg, device="cpu").run()
        assert rep.final.version == 2
        _assert_exact_at_version(rep)


def test_verify_counts_no_mismatch():
    cfg = ServeConfig(n=120, deg=3, landmarks=4, batches=2, batch_size=10,
                      queries=8, qps=5000.0, microbatch=4, verify=True,
                      quiet=True, graph="road", scenario="traffic")
    rep = ServeLoop(cfg, device="cpu").run()
    assert [t.verify_mismatches for t in rep.ticks] == [0, 0]


# --- configuration ----------------------------------------------------------------

def test_unported_settings_raise():
    # The mesh is ported: mesh="host" shards on the CPU's one device, and
    # a model axis that does not divide the devices, or an unknown mesh,
    # raises.
    loop = ServeLoop(ServeConfig(mesh="host"), device="cpu")
    assert loop.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="must divide the 1 local devices"):
        ServeLoop(ServeConfig(mesh="host", shards=2), device="cpu")
    with pytest.raises(ValueError, match="unknown mesh"):
        ServeLoop(ServeConfig(mesh="tpu"), device="cpu")
    # The autotuner is ported: both settings reach the engine.
    loop = ServeLoop(ServeConfig(autotune=True), device="cpu")
    assert loop.engine.autotune and loop.engine.tune_count == 0
    with pytest.raises(ValueError, match="CPU only"):
        ServeLoop(ServeConfig(backend="jnp"), device="meta")
    with pytest.raises(ValueError, match="tiled engine"):
        ServeLoop(ServeConfig(backend="jnp", frontier=True), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ServeLoop(ServeConfig(backend="tpu"), device="cpu")


def test_serve_spec_round_trips_between_packages():
    """Field for field the reference's specs: a JSON written by either
    package loads in the other, the CLI round trip is lossless, and the
    flat config maps by field name."""
    for mod in (tconfig, jconfig):
        assert [(a, [f.name for f in dataclasses.fields(c)])
                for a, c in mod.SPEC_GROUPS] == \
            [(a, [f.name for f in dataclasses.fields(c)])
             for a, c in jconfig.SPEC_GROUPS]
    assert [f.name for f in dataclasses.fields(ServeConfig)] == \
        [f.name for f in dataclasses.fields(jserve.ServeConfig)]
    spec = tconfig.ServeSpec(
        graph=tconfig.GraphSpec(n=300, graph="road", capacity=900,
                                grow=True),
        engine=tconfig.EngineSpec(block_e=64, fused=True, frontier=True),
        stream=tconfig.StreamSpec(pipeline=True, chunk_sweeps=2,
                                  scenario="traffic"),
        checkpoint=tconfig.CheckpointSpec(ckpt_dir="ck", keep=2))
    doc = spec.to_json()
    assert jconfig.ServeSpec.from_json(doc).to_json() == doc
    assert tconfig.ServeSpec.from_json(
        jconfig.ServeSpec.from_json(doc).to_json()) == spec
    parser = tconfig.build_parser("t")
    assert tconfig.ServeSpec.from_parsed_args(
        parser.parse_args(spec.to_args())) == spec
    cfg = spec.to_serve_config()
    assert (cfg.n, cfg.block_e, cfg.chunk_sweeps, cfg.ckpt_dir) == \
        (300, 64, 2, "ck")
    assert tconfig.ServeSpec.from_serve_config(cfg).graph == spec.graph
    with pytest.raises(ValueError, match="unknown config sections"):
        tconfig.ServeSpec.from_json(json.dumps({"nope": {}}))


def test_api_serve_runs_the_loop(tmp_path):
    rep = api.serve(device="cpu", n=100, deg=2, landmarks=4, batches=1,
                    batch_size=6, queries=4, qps=1e5, microbatch=4,
                    quiet=True)
    assert rep.final.version == 1 and rep.backend == "plain"
    # With a publish dir it runs the replica tier, every role on the CPU.
    rep = api.serve(publish_dir=str(tmp_path), device="cpu", n=100, deg=2,
                    landmarks=4, batches=2, batch_size=6, queries=10,
                    qps=200.0, microbatch=4, readers=1, verify=True,
                    quiet=True)
    assert rep.offered == len(rep.answers) + rep.rejected == 20
    assert rep.max_staleness() <= 1
    assert tckpt.current_step(str(tmp_path)) == 2
    with pytest.raises(TypeError, match="unknown serve"):
        api.serve(device="cpu", nope=1)


def test_cli_verifies_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--n", "120", "--batches", "1",
        "--batch-size", "10", "--queries", "8", "--verify"])
    tserve.main()
    out = capsys.readouterr().out
    assert "verify: 0/8 mismatches" in out
    assert "serve loop done [backend=plain" in out


# --- mesh sharding -----------------------------------------------------------

MESH_BASE = dict(n=300, deg=3, landmarks=8, batches=2, batch_size=30,
                 queries=48, qps=5000.0, microbatch=8, verify=True,
                 quiet=True, keep_history=True, block_v=64)


def _same_snapshot(got, want):
    assert (got.version, got.graph.n) == (want.version, want.graph.n)
    for part, fields in (("graph", ("src", "dst", "valid", "w")),
                         ("labelling", ("landmarks", "dist", "hub",
                                        "highway"))):
        for f in fields:
            assert torch.equal(getattr(getattr(got, part), f),
                               getattr(getattr(want, part), f)), (part, f)


@pytest.mark.parametrize("pipeline", [False, True])
def test_serve_mesh_host_multidevice(pipeline):
    """The loop on a prebuilt (data=4, model=2) mesh of 8 CPU shards (the
    counterpart of `tests/test_shard.py::test_serve_mesh_host_multidevice`
    and its forced 8 host devices): 0 mismatches against the oracle, and
    every committed snapshot equals an unsharded loop's."""
    flat = ServeLoop(ServeConfig(**MESH_BASE, pipeline=pipeline),
                     device="cpu").run()
    mesh = make_host_mesh(model=2, devices=["cpu"] * 8)
    loop = ServeLoop(ServeConfig(**MESH_BASE, pipeline=pipeline,
                                 mesh="host", shards=2), mesh=mesh)
    assert loop.mesh is mesh and loop.device == torch.device("cpu")
    rep = loop.run()
    assert [t.verify_mismatches for t in rep.ticks] == [0, 0]
    assert sorted(rep.history) == sorted(flat.history) == [0, 1, 2]
    for v in rep.history:
        _same_snapshot(rep.history[v], flat.history[v])
    assert [t.affected for t in rep.ticks] == \
        [t.affected for t in flat.ticks]
    _assert_exact_at_version(rep)


@pytest.mark.parametrize("fused", [False, True])
def test_serve_loop_on_host_mesh_matches_reference(reference, fused):
    """mesh="host" on the CPU's one device (a 1×1 mesh), pipelined: the
    committed snapshots are `repro`'s, version by version."""
    cfg = ServeConfig(**BASE, pipeline=True, fused=fused, mesh="host",
                      block_v=64)
    rep = ServeLoop(cfg, device="cpu").run()
    want = reference["mixed"]
    for v in want.history:
        _assert_snapshot(rep.history[v], want.history[v])
    _assert_exact_at_version(rep)


def test_serve_mesh_growth_matches_reference(reference):
    """The `growth` scenario on a (data=2, model=4) mesh of 8 CPU shards:
    the grown snapshots go on through the shard twins and commit
    `repro`'s, version by version, with its growth events."""
    cfg = ServeConfig(**BASE, **SCENARIOS["growth"], pipeline=True,
                      block_v=64, mesh="host", shards=4)
    rep = ServeLoop(cfg, mesh=make_host_mesh(model=4,
                                             devices=["cpu"] * 8)).run()
    want = reference["growth"]
    assert rep.growth and [dataclasses.asdict(e) for e in rep.growth] == \
        [dataclasses.asdict(e) for e in want.growth]
    for v in want.history:
        _assert_snapshot(rep.history[v], want.history[v])
    _assert_exact_at_version(rep)


def test_serve_loop_checks_a_given_mesh():
    mesh = make_host_mesh(model=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="model axis is 2, cfg.shards is 4"):
        ServeLoop(ServeConfig(mesh="host", shards=4), mesh=mesh)
    with pytest.raises(ValueError, match="cfg.mesh is 'none'"):
        ServeLoop(ServeConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="not the loop's device"):
        ServeLoop(ServeConfig(mesh="host", shards=2), device="meta",
                  mesh=mesh)
    with pytest.raises(ValueError, match="failing: maintenance grouping "
                       "data×model = 4×2 = 8 —"):
        ServeLoop(ServeConfig(mesh="host", shards=2, landmarks=12),
                  mesh=mesh)


@pytest.mark.cuda
def test_serve_loop_on_a_prebuilt_cuda_mesh():
    """A hand-built mesh that names the card without an index,
    `Mesh([["cuda"] * 4])`, is the loop's device mesh: the loop resolves
    to the same indexed card and serves on it with 0 mismatches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop runs the kernels there")
    mesh = Mesh([["cuda"] * 4])
    loop = ServeLoop(ServeConfig(**MESH_BASE, pipeline=True, mesh="host",
                                 shards=4), mesh=mesh)
    assert loop.mesh is mesh and mesh.first == loop.device == \
        torch.device("cuda", torch.cuda.current_device())
    rep = loop.run()
    assert [t.verify_mismatches for t in rep.ticks] == [0, 0]


def test_cli_mesh_host_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--mesh", "host", "--shards", "1",
        "--n", "120", "--batches", "2", "--batch-size", "10", "--queries",
        "8", "--pipeline", "--verify"])
    tserve.main()
    out = capsys.readouterr().out
    assert out.count("verify: 0/8 mismatches") == 2
    assert "mesh data=1 model=1, mode=pipeline]" in out

