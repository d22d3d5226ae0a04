"""`pipelined_update(mesh=...)` of the port: the chunks' mesh twins.

The counterpart of `tests/test_pipeline.py`'s mesh tests. The plain,
fused and frontier chunk twins of `core/shard.py`, driven by the same
`pipelined_update` as the unsharded chunks, on every factorisation of an
8-shard CPU mesh (and the 1×1 default), with `chunk_sweeps` 1 and 2 and
both search variants: each committed labelling, graph and `aff` equals
the monolithic update, sharded and unsharded, and `repro`'s, bit for
bit. Each step reads its host flags as often as the unsharded step does:
the shards' flags are stacked and read once.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.graphs import coo as jcoo
from repro_torch.core import construct as tcon
from repro_torch.core import engine as teng
from repro_torch.core import shard
from repro_torch.core import snapshot as tsnap
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs import coo as tcoo
from repro_torch.graphs import generators as tgen
from repro_torch.launch.mesh import make_host_mesh

CPU8 = ["cpu"] * 8
MESHES = {f"d{8 // m}m{m}": m for m in (1, 2, 4, 8)}
MESHES["default"] = None
MODES = ["plain", "fused", "frontier"]


def _mesh(name: str):
    model = MESHES[name]
    if model is None:
        return make_host_mesh(device="cpu")
    return make_host_mesh(model=model, devices=CPU8)


@pytest.fixture(scope="module")
def inst():
    """The reference tests' instance (n = 150, R = 8, 8 inserts and 8
    deletes) from the port's generators, `repro`'s monolithic update for
    both variants, and the tiled plans of G' (the frontier plan with
    blocks of 16 vertices, so that its masked waves run)."""
    n = 150
    edges = tgen.random_connected(n, extra_edges=200, seed=3)
    ups = tgen.random_batch_updates(edges, n, n_ins=8, n_del=8, seed=9)
    cap = edges.shape[0] + 64
    gt = tcoo.from_edges(n, edges, cap, device="cpu")
    bt = tcoo.make_batch(ups, pad_to=16, device="cpu")
    gj = jcoo.from_edges(n, edges, cap)
    bj = jcoo.make_batch(ups, pad_to=16)
    lab = tcon.build_labelling(gt, tcon.select_landmarks_by_degree(gt, 8))
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 8))
    want = {imp: jbat.batchhl_update(gj, bj, labj, improved=imp)
            for imp in (True, False)}
    g1 = tcoo.apply_batch(gt, bt)
    plans = {"plain": RelaxEngine(block_v=32, shards=2,
                                  device="cpu").prepare(g1),
             "frontier": RelaxEngine(block_v=32, shards=2, frontier=True,
                                     frontier_block=16,
                                     device="cpu").prepare(g1)}
    plans["fused"] = plans["plain"]
    return SimpleNamespace(snap=tsnap.Snapshot(0, gt, lab, None), bt=bt,
                           g1=g1, want=want, plans=plans)


def _assert_update(nxt, aff, want):
    gj, labj, affj = want
    assert nxt.version == 1
    np.testing.assert_array_equal(aff.numpy(), np.asarray(affj))
    for f in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(getattr(nxt.graph, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    for f in ("landmarks", "dist", "hub", "highway"):
        np.testing.assert_array_equal(getattr(nxt.labelling, f).numpy(),
                                      np.asarray(getattr(labj, f)))


def _gen(inst, mode, mesh, sweeps=1, improved=True):
    return tsnap.pipelined_update(
        inst.snap, inst.bt, plan=inst.plans[mode], g_new=inst.g1, mesh=mesh,
        improved=improved, chunk_sweeps=sweeps, fused=mode == "fused")


@pytest.mark.parametrize("improved", [True, False])
@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipelined_mesh_matches_monolithic(inst, mesh, mode, sweeps,
                                           improved):
    mesh = _mesh(mesh)
    teng.WAVES.clear()
    nxt, aff = tsnap.run_pipelined_update(
        _gen(inst, mode, mesh, sweeps, improved))
    _assert_update(nxt, aff, inst.want[improved])
    assert nxt.plan is inst.plans[mode]
    if mode == "frontier":
        kind = tsnap.search_kind(improved)
        assert teng.WAVES[kind + ".masked"] > 0
        assert teng.WAVES["repair.masked"] > 0
    # The monolithic sharded update lands on the same state.
    _, lab1, aff1 = shard.shard_batchhl_update(
        mesh, inst.snap.graph, inst.bt, inst.snap.labelling,
        improved=improved, plan=inst.plans[mode], g_new=inst.g1)
    assert torch.equal(aff1, aff)
    for f in ("dist", "hub", "highway"):
        assert torch.equal(getattr(lab1, f), getattr(nxt.labelling, f))


def _step_reads(gen, monkeypatch) -> tuple[list, object]:
    """Drive a pipelined update step by step, counting each step's host
    reads of a tensor (`item`, `tolist`, `bool`: the calls that sync on
    the GPU): ([(phase tag, reads)], result)."""
    count = [0]
    for name in ("item", "tolist", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            count[0] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    steps = []
    try:
        while True:
            count[0] = 0
            try:
                tag = next(gen)
            except StopIteration as stop:
                return steps, stop.value
            steps.append((tag, count[0]))
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("mode", MODES)
def test_host_reads_per_step_equal_unsharded(inst, mode, monkeypatch):
    """Every step of the update on the (data=2, model=4) mesh reads its
    flags from the host as often as the unsharded step: one merged
    `changed` per chunk (and, in the frontier mode, one read of every
    shard's frontier per wave)."""
    flat, (_, aff0) = _step_reads(_gen(inst, mode, None), monkeypatch)
    mesh = make_host_mesh(model=4, devices=CPU8)
    sharded, (nxt, aff) = _step_reads(_gen(inst, mode, mesh), monkeypatch)
    assert sharded == flat
    assert torch.equal(aff, aff0)
    _assert_update(nxt, aff, inst.want[True])
    # A step reads the flag of the chunk before it when it resumes (none
    # after an unfused seed, whose flag is a constant), then its own
    # waves' frontier flags.
    chunks = [r for tag, r in sharded if tag in ("search", "repair")]
    assert chunks and max(chunks) == (2 if mode == "frontier" else 1)


def test_chunk_twins_keep_planes_per_shard(inst):
    """Between chunks each shard's planes stay its own [R / 8, V] slice;
    the chunk's `changed` is one scalar on the mesh's first device."""
    mesh = make_host_mesh(model=2, devices=CPU8)
    lab = inst.snap.labelling
    batch = tcoo.resolve_seed_weights(inst.snap.graph, inst.bt)
    seed, seeded, bound, hub_mask = shard.shard_search_seed(
        mesh, inst.g1, batch, lab.dist, lab.hub, lab.landmarks)
    assert len(seed) == 8 and all(s.shape == (1, 150) for s in seed)
    best, changed = shard.shard_search_chunk(
        mesh, inst.g1, seed, seed, bound, hub_mask, inst.plans["plain"])
    assert changed.shape == () and changed.dtype == torch.bool
    assert len(best) == 8 and bool(changed)
    with pytest.raises(ValueError, match="4 plane shards for a mesh of 8"):
        shard.shard_search_chunk(mesh, inst.g1, best[:4], seed[:4],
                                 bound[:4], hub_mask[:4], None)
