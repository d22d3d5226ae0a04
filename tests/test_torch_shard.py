"""Mesh-sharded BatchHL of the port (`core/shard.py`) against `repro`.

The counterpart of `tests/test_shard.py` and of the sharded parts of
`tests/test_shard_tiling.py`. The port's mesh is a grid of torch devices
in one process, and a device may repeat, so every (data, model)
factorisation of an 8-shard mesh runs here on the CPU (8 × cpu), besides
the 1×1 default mesh: the real partitioning, regrouping and collectives,
with the kernels' plain versions. Inputs come from a seed through the
port's generators, and the same numpy arrays go through `repro`'s
unsharded `build_labelling` / `batchhl_update` / `batched_query` (and its
`shard_*` functions on its one-device host mesh). Every comparison is bit
for bit: every output is an integer.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.core import query as jq
from repro.core import shard as jshard
from repro.core.engine import RelaxEngine as JEngine
from repro.graphs import coo as jcoo
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core import construct as tcon
from repro_torch.core import query as tq
from repro_torch.core import shard
from repro_torch.core.engine import RelaxEngine
from repro_torch.core.growth import GrowthPolicy, ensure_capacity
from repro_torch.core.snapshot import Snapshot
from repro_torch.graphs import coo as tcoo
from repro_torch.graphs import generators as tgen
from repro_torch.launch.mesh import Mesh, make_host_mesh

R = 8
CPU8 = ["cpu"] * 8
#: Every factorisation of the 8-shard CPU mesh, and the 1×1 default.
MESHES = {f"d{8 // m}m{m}": m for m in (1, 2, 4, 8)}
MESHES["default"] = None


def _mesh(name: str) -> Mesh:
    model = MESHES[name]
    if model is None:
        return make_host_mesh(device="cpu")
    return make_host_mesh(model=model, devices=CPU8)


def _engine() -> RelaxEngine:
    """A tiled plan with two vertex shards (the reference tests')."""
    return RelaxEngine(block_v=32, shards=2, device="cpu")


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _assert_lab(got, want) -> None:
    for f in ("landmarks", "dist", "hub", "highway"):
        _eq(getattr(got, f), getattr(want, f))


def _both(n, edges, capacity, ups, pad_to):
    """(port graph, port batch, repro graph, repro batch) of one input."""
    gt = tcoo.from_edges(n, edges, capacity, device="cpu")
    gj = jcoo.from_edges(n, edges, capacity)
    return (gt, tcoo.make_batch(ups, pad_to=pad_to, device="cpu"), gj,
            jcoo.make_batch(ups, pad_to=pad_to))


@pytest.fixture(scope="module")
def inst():
    """n = 120, R = 8 (the reference selftest's instance), a mixed batch,
    37 queries (odd: the padded path), and `repro`'s unsharded results."""
    n = 120
    edges = tgen.random_connected(n, extra_edges=150, seed=3)
    ups = tgen.random_batch_updates(edges, n, n_ins=6, n_del=6, seed=9)
    gt, bt, gj, bj = _both(n, edges, edges.shape[0] + 64, ups, 12)
    lm = tcon.select_landmarks_by_degree(gt, R)
    lmj = jcon.select_landmarks_by_degree(gj, R)
    _eq(lm, lmj)
    rng = np.random.default_rng(0)
    qs = rng.integers(0, n, 37).astype(np.int32)
    qt = rng.integers(0, n, 37).astype(np.int32)
    lab0 = jcon.build_labelling(gj, lmj)
    upd = {imp: jbat.batchhl_update(gj, bj, lab0, improved=imp)
           for imp in (True, False)}
    d1 = jq.batched_query(upd[True][0], upd[True][1], jnp.asarray(qs),
                          jnp.asarray(qt))
    g1 = tcoo.apply_batch(gt, bt)
    plans = {"coo": (None, None),
             "engine": (_engine().prepare(gt), _engine().prepare(g1))}
    return SimpleNamespace(n=n, edges=edges, gt=gt, bt=bt, gj=gj, bj=bj,
                           lm=lm, lmj=lmj, qs=qs, qt=qt, lab0=lab0, upd=upd,
                           d1=d1, g1=g1, plans=plans)


# --- build, update, query: every mesh, the COO path and an engine plan -------

@pytest.mark.parametrize("plan", ["coo", "engine"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_update_query_parity(inst, mesh, plan):
    mesh = _mesh(mesh)
    p0, p1 = inst.plans[plan]
    slab = shard.shard_build_labelling(mesh, inst.gt, inst.lm, plan=p0)
    _assert_lab(slab, inst.lab0)
    _assert_lab(tcon.build_labelling(inst.gt, inst.lm, plan=p0), inst.lab0)

    gj1, labj1, affj1 = inst.upd[True]
    sg1, slab1, saff1 = shard.shard_batchhl_update(
        mesh, inst.gt, inst.bt, slab, plan=p1, g_new=inst.g1)
    _eq(saff1, affj1)
    _assert_lab(slab1, labj1)
    for f in ("src", "dst", "valid", "w"):
        _eq(getattr(sg1, f), getattr(gj1, f))
    g1, lab1, aff1 = tbat.batchhl_update(inst.gt, inst.bt, slab, plan=p1)
    assert torch.equal(aff1, saff1) and torch.equal(lab1.dist, slab1.dist)

    qs, qt = torch.from_numpy(inst.qs), torch.from_numpy(inst.qt)
    got = shard.shard_batched_query(mesh, sg1, slab1, qs, qt,
                                    use_kernel=plan == "engine", plan=p1)
    assert got.shape == (37,)
    _eq(got, inst.d1)
    _eq(tq.batched_query(g1, lab1, qs, qt, plan=p1), inst.d1)


@pytest.mark.parametrize("max_iters", [0, 1, 8, None])
def test_shard_build_labelling_max_iters(max_iters):
    """`shard_build_labelling(mesh, g, lm, max_iters)` on a (2, 2) CPU
    mesh equals the reference's `build_labelling` and its
    `shard_build_labelling` on its host mesh, on the 64-vertex path with
    landmarks [0, 63], where 8 sweeps leave 110 of 128 entries at INF_D."""
    path = np.array([[i, i + 1] for i in range(63)], np.int32)
    gt, _, gj, _ = _both(64, path, len(path), [], 1)
    lm = np.array([0, 63, 31, 32], np.int32)
    mesh = make_host_mesh(model=2, devices=["cpu"] * 4)
    got = shard.shard_build_labelling(mesh, gt, torch.from_numpy(lm),
                                      max_iters)
    _assert_lab(got, jcon.build_labelling(gj, jnp.asarray(lm), max_iters))
    _assert_lab(got, jshard.shard_build_labelling(
        jmake_host_mesh(), gj, jnp.asarray(lm), max_iters))
    assert got.dist.shape == (4, 64)


@pytest.mark.parametrize("plan", ["coo", "engine"])
def test_reference_shard_functions_on_its_host_mesh(inst, plan):
    """`repro`'s own `shard_*` on its one-device host mesh (the pallas
    backend in interpret mode for the engine plan) equal the port's on
    the 8-shard (data=2, model=4) mesh."""
    jmesh = jmake_host_mesh()
    mesh = make_host_mesh(model=4, devices=CPU8)
    jp0 = jp1 = None
    if plan == "engine":
        jp0 = JEngine(backend="pallas", block_v=32, shards=2).prepare(inst.gj)
        jp1 = JEngine(backend="pallas", block_v=32, shards=2).prepare(
            jcoo.apply_batch(inst.gj, inst.bj))
    p0, p1 = inst.plans[plan]
    jlab = jshard.shard_build_labelling(jmesh, inst.gj, inst.lmj, plan=jp0)
    slab = shard.shard_build_labelling(mesh, inst.gt, inst.lm, plan=p0)
    _assert_lab(slab, jlab)
    jg1, jlab1, jaff1 = jshard.shard_batchhl_update(jmesh, inst.gj, inst.bj,
                                                    jlab, plan=jp1)
    _, slab1, saff1 = shard.shard_batchhl_update(mesh, inst.gt, inst.bt,
                                                 slab, plan=p1)
    _eq(saff1, jaff1)
    _assert_lab(slab1, jlab1)
    _eq(shard.affected_vertices(mesh, saff1),
        jshard.affected_vertices(jmesh, jaff1))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_basic_search_variant_parity(inst, mesh):
    mesh = _mesh(mesh)
    lab0 = tcon.build_labelling(inst.gt, inst.lm)
    _, slab1, saff1 = shard.shard_batchhl_update(mesh, inst.gt, inst.bt,
                                                 lab0, improved=False)
    _, labj1, affj1 = inst.upd[False]
    _eq(saff1, affj1)
    _assert_lab(slab1, labj1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_affected_vertices_or_merge(inst, mesh):
    mesh = _mesh(mesh)
    lab0 = tcon.build_labelling(inst.gt, inst.lm)
    _, _, aff = shard.shard_batchhl_update(mesh, inst.gt, inst.bt, lab0)
    got = shard.affected_vertices(mesh, aff)
    assert got.dtype == torch.bool and got.shape == (inst.n,)
    _eq(got, jnp.any(inst.upd[True][2], axis=0))
    assert got.any() and not got.all()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_update_accepts_engine_plan(inst, mesh):
    """A tiled plan through the sharded update equals the sharded COO
    path (`test_shard.py::test_sharded_update_accepts_engine_plan`)."""
    mesh = _mesh(mesh)
    lab0 = tcon.build_labelling(inst.gt, inst.lm)
    _, lab_a, aff_a = shard.shard_batchhl_update(mesh, inst.gt, inst.bt,
                                                 lab0)
    plan = RelaxEngine(block_v=16, shards=2, device="cpu").prepare(inst.g1)
    _, lab_b, aff_b = shard.shard_batchhl_update(
        mesh, inst.gt, inst.bt, lab0, plan=plan, g_new=inst.g1)
    assert torch.equal(aff_a, aff_b)
    assert torch.equal(lab_a.dist, lab_b.dist)
    assert torch.equal(lab_a.hub, lab_b.hub)


# --- validation and placement ------------------------------------------------

def test_plane_divisibility_validation(inst):
    with pytest.raises(ValueError, match="divisible"):
        shard._check_planes(3, 2, "model")
    shard._check_planes(4, 2, "model")   # divides: no raise
    with pytest.raises(ValueError, match="divide the 8 local devices"):
        make_host_mesh(model=3, devices=CPU8)
    with pytest.raises(ValueError, match="divide the 1 local devices"):
        make_host_mesh(model=2, device="cpu")
    # R = 12 on model = 8: neither grouping divides.
    mesh = make_host_mesh(model=8, devices=CPU8)
    lm12 = tcon.select_landmarks_by_degree(inst.gt, 12)
    with pytest.raises(ValueError, match="maintenance sharding size 8"):
        shard.shard_build_labelling(mesh, inst.gt, lm12)
    with pytest.raises(ValueError, match="model sharding size 8"):
        lab = tcon.build_labelling(inst.gt, lm12)
        shard.shard_batched_query(mesh, inst.gt, lab, torch.zeros(2, dtype=
                                  torch.int32), torch.zeros(2, dtype=
                                  torch.int32))
    # The messages are the reference's, grouping by grouping.
    for shape, r in (({"data": 2, "model": 4}, 4),
                     ({"data": 2, "model": 4}, 6),
                     ({"data": 8, "model": 1}, 12)):
        tm, jm = SimpleNamespace(shape=shape), SimpleNamespace(shape=shape)
        with pytest.raises(ValueError) as te:
            shard.validate_landmark_sharding(tm, r)
        with pytest.raises(ValueError) as je:
            jshard.validate_landmark_sharding(jm, r)
        assert str(te.value) == str(je.value)
    shard.validate_landmark_sharding(SimpleNamespace(
        shape={"data": 2, "model": 4}), 16)


def test_width_checked_before_any_shard(inst):
    mesh = make_host_mesh(model=2, devices=CPU8)
    lab = tcon.build_labelling(inst.gt, inst.lm)
    wide = tcoo.grow(inst.gt, n=inst.n + 8)
    with pytest.raises(ValueError, match="grow them together"):
        shard.shard_batchhl_update(mesh, wide, inst.bt, lab)


def test_mesh_grid_and_shard_placement():
    """Device i of the list is shard (i // model, i % model), the order of
    `jax.make_mesh`; maintenance plane block k = m·data + d lives on grid
    (d, m) (model-major), queries' plane block m on column m. Distinct
    device labels make the order visible (no tensor is placed)."""
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = make_host_mesh(model=4, devices=devs)
    assert mesh.shape == {"data": 2, "model": 4}
    assert [[x.index for x in row] for row in mesh.grid] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [x.index for x in shard.maint_devices(mesh)] == \
        [0, 4, 1, 5, 2, 6, 3, 7]
    assert mesh.first == devs[0] and mesh.devices == devs
    # The reference's mesh and its combined ("model", "data") spec place
    # the blocks alike: block k on the device at mesh position
    # (k % data, k // data).
    assert shard.MAINT_AXES == jshard.MAINT_AXES == ("model", "data")
    with pytest.raises(ValueError, match="equal, non-empty rows"):
        Mesh([["cpu"], ["cpu", "cpu"]])


def test_mesh_grid_names_cards_by_index(monkeypatch):
    """A grid entry "cuda" is settled to the current card with its index,
    as `make_host_mesh` settles its devices, so a prebuilt mesh's first
    device equals the serve loop's resolved device. Repeats and CPU grids
    stay as they are; an entry of None names no device and is refused."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = Mesh([["cuda"] * 2])
    assert mesh.first == torch.device("cuda", 0)
    assert mesh.devices == [torch.device("cuda", 0)] * 2
    assert Mesh([["cuda:1", "cuda"]]).devices == \
        [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert Mesh([["cpu"] * 4] * 2).devices == [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="not None"):
        Mesh([["cpu", None]])
    with pytest.raises(ValueError, match="not None"):
        make_host_mesh(devices=[None])


# --- queries: padding and the per-data-shard BiBFS ---------------------------

@pytest.mark.parametrize("data", [2, 4, 8])
def test_query_padding_b37(inst, data):
    mesh = make_host_mesh(model=8 // data, devices=CPU8)
    gj1, labj1, _ = inst.upd[True]
    g1 = cv.graph_from_numpy(gj1.src, gj1.dst, gj1.valid, gj1.w, gj1.n,
                             device="cpu")
    lab1 = cv.labelling_from_numpy(labj1.landmarks, labj1.dist, labj1.hub,
                                   labj1.highway, device="cpu")
    got = shard.shard_batched_query(mesh, g1, lab1,
                                    torch.from_numpy(inst.qs),
                                    torch.from_numpy(inst.qt))
    assert 37 % data and got.shape == (37,)
    _eq(got, inst.d1)


def _binding_instance():
    """Two components, R = 8 landmarks on the first: a path of 40 far from
    every landmark hangs off it, and the second component is unreachable
    from the first. With max_steps 4 the BiBFS stops before it settles
    the path's pairs."""
    base = tgen.random_connected(60, extra_edges=60, seed=4)
    path = np.array([[59 + i, 60 + i] for i in range(40)], np.int32)
    other = tgen.random_connected(20, extra_edges=10, seed=5) + 100
    edges = np.concatenate([base, path, other])
    return 120, edges


@pytest.mark.parametrize("data", [2, 4, 8])
def test_query_max_steps_binding_per_data_shard(data):
    """The composition rule of the reference: each data shard runs the
    BiBFS over its own padded sub-batch. The expected answers are
    `repro`'s unsharded `batched_query` on each padded sub-batch in turn,
    concatenated and cut to B."""
    n, edges = _binding_instance()
    gt = tcoo.from_edges(n, edges, edges.shape[0] + 8, device="cpu")
    gj = jcoo.from_edges(n, edges, edges.shape[0] + 8)
    lm = tcon.select_landmarks_by_degree(gt, R)
    lab = tcon.build_labelling(gt, lm)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, R))
    rng = np.random.default_rng(6)
    qs = np.concatenate([rng.integers(0, n, 30), [60, 62, 5, 101, 70, 99,
                                                  104]]).astype(np.int32)
    qt = np.concatenate([rng.integers(0, n, 30), [95, 98, 110, 3, 90, 61,
                                                  115]]).astype(np.int32)
    b, max_steps = qs.shape[0], 4
    pad = (-b) % data
    qs_p = np.concatenate([qs, np.zeros(pad, np.int32)])
    qt_p = np.concatenate([qt, np.zeros(pad, np.int32)])
    per = qs_p.shape[0] // data
    want = np.concatenate([np.asarray(jq.batched_query(
        gj, labj, jnp.asarray(qs_p[i * per:(i + 1) * per]),
        jnp.asarray(qt_p[i * per:(i + 1) * per]), max_steps=max_steps))
        for i in range(data)])[:b]
    mesh = make_host_mesh(model=8 // data, devices=CPU8)
    got = shard.shard_batched_query(mesh, gt, lab, torch.from_numpy(qs),
                                    torch.from_numpy(qt),
                                    max_steps=max_steps)
    _eq(got, want)
    # The binding case: some answer is the landmark bound, above the
    # exact distance, and an unreachable pair answers INF_D.
    exact = np.asarray(jq.batched_query(gj, labj, jnp.asarray(qs),
                                        jnp.asarray(qt), max_steps=64))
    assert (want > exact).any()
    assert (want == tcoo.INF_D).any()


# --- growth (repro/core/growth.py's grown-update mesh parity) ----------------

@pytest.mark.parametrize("plan", ["coo", "engine"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_grown_update_parity(mesh, plan):
    """A batch that outgrows the slots and names vertices >= n: the grown
    snapshot's sharded update equals the unsharded one and `repro`'s."""
    mesh = _mesh(mesh)
    n = 120
    edges = tgen.random_connected(n, extra_edges=150, seed=3)
    ups = tgen.random_batch_updates(edges, n, n_ins=6, n_del=2, seed=9)
    ups += [(5, n, False), (n, n + 1, False)]
    gt, bt, gj, bj = _both(n, edges, edges.shape[0] + 4, ups, 12)
    lab0 = tcon.build_labelling(gt, tcon.select_landmarks_by_degree(gt, R))
    policy = GrowthPolicy(block_v=32, shards=2)
    snap, event = ensure_capacity(Snapshot(0, gt, lab0, None), bt, policy,
                                  tick=0)
    assert event is not None and snap.graph.n == policy.next_n(n, n + 2)
    assert snap.graph.capacity >= edges.shape[0] + 8
    g_new = tcoo.apply_batch(snap.graph, bt)
    pln = _engine().prepare(g_new) if plan == "engine" else None
    _, lab1, aff1 = tbat.batchhl_update(snap.graph, bt, snap.labelling,
                                        plan=pln, g_new=g_new)
    _, slab1, saff1 = shard.shard_batchhl_update(
        mesh, snap.graph, bt, snap.labelling, plan=pln, g_new=g_new)
    assert torch.equal(saff1, aff1)
    for f in ("dist", "hub", "highway"):
        assert torch.equal(getattr(slab1, f), getattr(lab1, f))
    # The reference grows the same way and lands on the same planes.
    from repro.core.growth import GrowthPolicy as JPolicy
    from repro.core.growth import ensure_capacity as jensure
    from repro.core.snapshot import Snapshot as JSnapshot
    jlab0 = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, R))
    jsnap, _ = jensure(JSnapshot(0, gj, jlab0, None), bj,
                       JPolicy(block_v=32, shards=2), tick=0)
    _, jlab1, jaff1 = jbat.batchhl_update(jsnap.graph, bj, jsnap.labelling)
    _eq(saff1, jaff1)
    _assert_lab(slab1, jlab1)
