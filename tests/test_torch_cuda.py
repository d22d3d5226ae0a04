"""The port's CUDA kernels against their plain versions, on the card.

Every test here launches a hand-written kernel of `repro_torch` and skips
where `torch.cuda.is_available()` is false (a CUDA kernel has no CPU
mode). This file imports no JAX, so it also runs on a GPU machine without
it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU files `tests/test_torch_*.py` hold the plain versions to the JAX
package; these hold the kernels to the plain versions: bit for bit for
the integer kernels, and for the float embedding bag to rtol = atol =
1e-5 (float32 sums in another order), NaN rows included.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.engine import WAVES, RelaxEngine
from repro_torch.core.labelling import INF_KEY2
from repro_torch.graphs import coo
from repro_torch.graphs import generators as gen
from repro_torch.graphs.coo import INF_D
from repro_torch.kernels.edge_relax import kernel as rk
from repro_torch.kernels.edge_relax import ops as rops
from repro_torch.kernels.edge_relax import ref as rref
from repro_torch.kernels.embed_bag import kernel as ek
from repro_torch.kernels.embed_bag import ops as eops
from repro_torch.kernels.minplus import kernel as mk
from repro_torch.kernels.seed_match import kernel as sk

import _kernel_cases as kcases
import _sweep_cases as cases


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _sweep_equal(bg, keys, hub, mask, w, step, inf, clear):
    args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
            bg.rowblk_t, mask, w, step, inf, clear, bg.n, bg.block_v, bg.nb)
    before = rk.launches
    got = rk.relax_sweep(*args)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    assert torch.equal(got, rk.relax_sweep_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", cases.names())
def test_relax_sweep_kernel_edge_cases(dev, name):
    """Every sweep of each edge case of `tests/_sweep_cases.py`:
    P in {1, 3, 31, 32, 33, 100, 1024} × block_v in {4, ..., 12288},
    block_e in {None, 1, 7} × S in {1, 2, 3} at P in {3, 33} with every
    parameter set, hub and mask kind, shared and per-plane masks with
    E2 % 4 in {0, 2}, near-INF keys, all-masked, zero capacity, the
    short last shard, and the wide mode (P in {1, 3, 33} at block_v
    28,033 and 65,536, one block, a wide block chunked on two shards)."""
    for c in cases.make(name):
        args = cases.sweep_args(c, dev)
        before = rk.launches
        got = rk.relax_sweep(*args)
        torch.cuda.synchronize()
        assert rk.launches == before + 1
        assert torch.equal(got, rk.relax_sweep_plain(*args)), c.label


@pytest.mark.cuda
@pytest.mark.parametrize("name", cases.names())
def test_sorted_impl_equals_kernel(dev, name):
    """The autotuner's `sorted` impl on the card against kernel A and its
    plain version, over every sweep of the same edge cases."""
    for c in cases.make(name):
        args = cases.sweep_args(c, dev)
        sg = rops.prepare_sorted(c.src, c.dst, c.keep, c.n, device=dev)
        got = rops.relax_sweep_sorted(args[0], sg, args[7], c.step, c.inf,
                                      clear_bit=c.clear, hub=args[1],
                                      w=args[8])
        want = rk.relax_sweep(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), c.label
        assert torch.equal(got, rk.relax_sweep_plain(*args)), c.label


@pytest.mark.cuda
def test_relax_sweep_kernel_block_v_limit(dev):
    """The widest block_v of the tiled mode (three planes, one per CTA),
    one vertex more and 2^17 (the wide mode, three planes in one CTA) each
    equal the plain version, one launch a call."""
    rng = np.random.default_rng(5)
    n, m, p = 40, 120, 3
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = np.ones(m, bool)
    w = torch.from_numpy(rng.integers(1, 9, m).astype(np.int32)).to(dev)
    keys = torch.from_numpy(rng.integers(0, INF_D, (p, n))
                            .astype(np.int32)).to(dev)
    hub = torch.from_numpy(rng.random((p, n)) < 0.3).to(dev)
    mask = torch.from_numpy(keep).to(dev)
    limit = rk.SWEEP_MAX_BLOCK_V
    assert rk.sweep_shared_bytes(1, limit) == rk.SWEEP_SHARED_BYTES
    for block_v, mode in ((limit, "tiled"), (limit + 1, "wide"),
                          (1 << 17, "wide")):
        assert rk.sweep_mode(block_v) == mode
        bg = rops.prepare_topology(src, dst, keep, n, block_v, 1, None,
                                   device=dev)
        _sweep_equal(bg, keys, hub, mask, w, 2, INF_KEY2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", kcases.minplus_names())
def test_minplus_kernel_matches_plain(dev, name):
    """Each min-plus case of `tests/_kernel_cases.py`: B in {0, 1, 31,
    32, 33, 1024} at R = 32, rectangular H, H of 64 KB and 1 MB, all-INF
    rows. B = 0 launches nothing."""
    s, h, t = (torch.from_numpy(x).to(dev) for x in kcases.minplus_case(name))
    before = mk.launches
    got = mk.minplus(s, h, t)
    torch.cuda.synchronize()
    assert mk.launches == before + (s.shape[0] > 0)
    assert torch.equal(got, mk.minplus_plain(s, h, t))



def _seed_inputs(dev, e2: int, n: int, u: int, key: str, seed: int,
                 hi: bool = False):
    """Slots of undirected pairs (both directions), 5 % of the pairs
    copied over others (parallel slots), 45 % dead, weights up to 2^20;
    U row keys drawn from the slots (an eighth of them shifted to keys no
    slot has, a tenth masked to (-1, -1)), sorted. `hi` puts the vertex
    ids just below 2^31 − 1."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, e2 // 2), rng.integers(0, n, e2 // 2)
    if hi:
        a, b = 2**31 - 1 - a, 2**31 - 1 - b
    src = np.stack([a, b], 1).reshape(-1).astype(np.int32)
    dst = np.stack([b, a], 1).reshape(-1).astype(np.int32)
    pairs = e2 // 2
    to, frm = rng.integers(0, pairs, (2, pairs // 20))
    for col in (src, dst):
        col.reshape(-1, 2)[to] = col.reshape(-1, 2)[frm]
    if e2 % 2:
        src, dst = np.append(src, src[:1]), np.append(dst, dst[:1])
    valid = rng.random(e2) < 0.55
    w = rng.integers(1, 2**20, e2).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (src, dst, valid, w)]
    pick = torch.from_numpy(rng.integers(0, e2, u)).to(dev)
    row_dst = t[1][pick].clone()
    row_dst[: u // 8] -= 1
    keep = torch.from_numpy(rng.random(u) >= 0.1).to(dev)
    keys, _ = torch.sort(sk.slot_key(t[0][pick], row_dst, key, keep))
    return t, keys


def _seed_equal(t, keys, key) -> torch.Tensor:
    before = sk.launches
    got = sk.seed_match(*t, keys, key)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    want = sk.seed_match_plain(*t, keys, key)
    assert torch.equal(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("u", [1, 1024, sk.SEED_MATCH_MAX_SHARED_KEYS,
                               sk.SEED_MATCH_MAX_SHARED_KEYS + 1, 40_000])
@pytest.mark.parametrize("key", sk.KEYS)
def test_seed_match_kernel_matches_plain(dev, key, u, hi):
    """The slot match bit for bit against its plain version, one launch a
    call: both key kinds, U on both sides of the shared-memory limit
    (`seed_match_geometry`), E2 = 2^20 + 6 (a tail past the groups of
    four), vertex ids near 2^31 − 1; then the slots one element in, where
    src and dst are not 16-byte aligned (every slot one at a time)."""
    t, keys = _seed_inputs(dev, 2**20 + 6, 4096, u, key, u, hi)
    assert sk.seed_match_geometry(u, 2**20 + 6, 132).shared_keys == (
        u <= sk.SEED_MATCH_MAX_SHARED_KEYS)
    want = _seed_equal(t, keys, key)
    assert int((want > 0).sum()) >= u // 4
    _seed_equal([x[1:] for x in t], keys, key)


@pytest.mark.cuda
@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("key", sk.KEYS)
def test_seed_match_kernel_at_update_scale(dev, key, hi):
    """E2 = 2^24 slots (`ba20`'s) with parallel and dead slots, U = 1,024:
    bit for bit against the plain version, one launch."""
    t, keys = _seed_inputs(dev, 2**24, 2**20, 1024, key, 31, hi)
    _seed_equal(t, keys, key)


@pytest.mark.cuda
def test_seed_match_kernel_unknown_key_raises(dev):
    t, keys = _seed_inputs(dev, 64, 8, 4, "pair", 1)
    before = sk.launches
    with pytest.raises(ValueError, match="key must be one of"):
        sk.seed_match(*t, keys, "both")
    assert sk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("directed", [False, True])
def test_resolve_seed_weights_on_card_equals_cpu(dev, directed):
    """`resolve_seed_weights` on the card (one kernel launch) equals the
    CPU's on a BA graph under a mixed batch with padding rows."""
    from repro_torch.core import directed as tdir
    n = 5000
    edges = gen.barabasi_albert(n, 4, seed=3)
    ups = gen.random_batch_updates(edges, n, n_ins=50, n_del=300, seed=4,
                                   n_rew=100, max_weight=9)
    out = []
    for where in (torch.device("cpu"), dev):
        if directed:
            g = tdir.from_arcs(n, edges, len(edges) + 64, device=where)
        else:
            g = coo.from_edges(n, edges, len(edges) + 64, device=where)
        b = coo.make_batch(ups, pad_to=512, device=where)
        before = sk.launches
        got = coo.resolve_seed_weights(g, b, directed=directed)
        assert sk.launches == before + (where.type == "cuda")
        out.append(got.w.cpu())
    assert torch.equal(*out)

@pytest.mark.cuda
def test_api_on_card_equals_cpu(dev):
    """build → update → query through the kernels on the card equals the
    same verbs on the CPU (the COO reference)."""
    n = 3000
    edges = gen.barabasi_albert(n, 3, seed=5)
    ups = gen.random_batch_updates(edges, n, n_ins=40, n_del=40, seed=6)
    rng = np.random.default_rng(7)
    s, t = rng.integers(0, n, 64), rng.integers(0, n, 64)
    out = {}
    for where in ("cpu", dev):
        engine = (RelaxEngine(block_v=64, block_e=128, device=where)
                  if where != "cpu" else None)
        g, lab = api.build(n, edges, num_landmarks=8, device=where,
                           engine=engine)
        g, lab, aff = api.update(g, lab, ups, pad_to=96, engine=engine)
        d = api.query(g, lab, s, t, engine=engine)
        out[str(where)] = [x.cpu() for x in (g.src, g.valid, g.w, lab.dist,
                                             lab.hub, aff, d)]
    for a, b in zip(*out.values()):
        assert torch.equal(a, b)


def _edge_relax_equal(args):
    before = rk.launches_edge_relax
    got = rk.edge_relax(*args)
    torch.cuda.synchronize()
    assert rk.launches_edge_relax == before + 1
    assert torch.equal(got, rk.edge_relax_plain(*args))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", kcases.edge_relax_names())
def test_edge_relax_kernel_matches_plain(dev, name):
    """Each edge-relax case of `tests/_kernel_cases.py` at steps 1, 2 and
    4: BE % 4 in {0, 1, 3}, chunked and sharded tilings with a short last
    shard, block_v up to the tiled mode's limit and past it (the wide
    mode), near-INF keys, all invalid, zero slots; held to the COO oracle
    too."""
    for c in kcases.edge_relax_case(name):
        for step in kcases.STEPS:
            got = _edge_relax_equal(kcases.edge_relax_args(c, step, dev))
            want = rref.edge_relax(
                *(torch.from_numpy(x).to(dev)
                  for x in (c.keys, c.src, c.dst, c.valid)), step, c.n)
            assert torch.equal(got, want), c.label


@pytest.mark.cuda
def test_edge_relax_kernel_block_v_limit(dev):
    """The widest block_v of the tiled mode, one vertex more and 2^17
    (the wide mode) each equal the plain version at every step, one
    launch a call."""
    limit = rk.EDGE_RELAX_MAX_BLOCK_V
    for block_v, mode in ((limit, "tiled"), (limit + 1, "wide"),
                          (1 << 17, "wide")):
        assert rk.edge_relax_mode(block_v) == mode
        c = dataclasses.replace(kcases.edge_relax_case("near-inf")[0],
                                block_v=block_v)
        for step in kcases.STEPS:
            _edge_relax_equal(kcases.edge_relax_args(c, step, dev))


def _embed_bag_close(table, idx, w):
    before = ek.launches
    got = ek.embed_bag(table, idx, w)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    torch.testing.assert_close(got, ek.embed_bag_plain(table, idx, w),
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 64, 100])
@pytest.mark.parametrize("bag", [1, 7, 50])
def test_embed_bag_kernel_matches_plain(dev, d, bag):
    g = torch.Generator().manual_seed(d * 100 + bag)
    n, b = 500, 37
    table = torch.randn(n, d, generator=g).to(dev)
    idx = torch.randint(0, n, (b, bag), generator=g, dtype=torch.int32)
    w = torch.rand(b, bag, generator=g)
    _embed_bag_close(table, idx.to(dev), w.to(dev))
    _embed_bag_close(table.half(), idx.to(dev), w.to(dev))


@pytest.mark.cuda
def test_embed_bag_kernel_index_wrap_and_nan(dev):
    n, d = 5, 8
    table = torch.arange(n * d, dtype=torch.float32, device=dev).view(n, d)
    idx = torch.tensor([[-1, 0], [n, 0], [-n, 1], [-n - 1, 2], [2, n + 3]],
                       dtype=torch.int32, device=dev)
    w = torch.tensor([[1.0, 0.5], [0.0, 1.0], [1.0, 1.0], [0.0, 1.0],
                      [1.0, 0.0]], device=dev)
    got = _embed_bag_close(table, idx, w).cpu()
    assert torch.isnan(got[[1, 3, 4]]).all()
    assert not torch.isnan(got[[0, 2]]).any()


def _mind_bags(dev, b, seed, nan=True):
    """Bags at the MIND widths (L = 50, D = 64) over a 100,000-row table,
    a few slots wrapped (-1) and, where `nan`, one out of range in the
    last bag."""
    g = torch.Generator().manual_seed(seed)
    n = 100_000
    table = torch.randn(n, 64, generator=g).to(dev)
    idx = torch.randint(0, n, (b, 50), generator=g, dtype=torch.int32)
    idx[::7, 3] = -1
    if nan:
        idx[-1, 49] = n
    return table, idx.to(dev), torch.rand(b, 50, generator=g).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 512, 65_536])
def test_embed_bag_kernel_at_mind_widths(dev, b):
    """Both launch regimes of `embed_bag_geometry`: a bag split over
    warps (B = 1, 512) and a warp a bag (B = 65,536)."""
    table, idx, w = _mind_bags(dev, b, b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = ek.embed_bag_geometry(b, 50, 64, sms)
    assert (geo.warps > 1) == (b < 65_536)
    got = _embed_bag_close(table, idx, w)
    assert torch.isnan(got[-1]).all() and not torch.isnan(got[:-1]).any()


@pytest.mark.cuda
def test_embed_bag_kernel_misaligned_table(dev):
    """A table 4 bytes off a 16-byte boundary goes by floats (the
    scalar path) at D = 64."""
    table, idx, w = _mind_bags(dev, 512, 5)
    flat = torch.empty(table.numel() + 1, device=dev)
    shifted = flat[1:].view_as(table)
    shifted.copy_(table)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    torch.testing.assert_close(_embed_bag_close(shifted, idx, w),
                               ek.embed_bag(table, idx, w), rtol=1e-5,
                               atol=1e-5, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [512, 65_536])
def test_embed_bag_kernel_is_deterministic(dev, b):
    """Two calls on one input give the same bits: the kernel adds its
    partial sums in a fixed order, without atomics."""
    table, idx, w = _mind_bags(dev, b, 7 * b, nan=False)
    assert torch.equal(ek.embed_bag(table, idx, w),
                       ek.embed_bag(table, idx, w))


@pytest.mark.cuda
def test_embed_bag_ops_masked_mean_on_card(dev):
    g = torch.Generator().manual_seed(3)
    table = torch.randn(300, 64, generator=g)
    idx = torch.randint(0, 300, (20, 9), generator=g, dtype=torch.int32)
    mask = torch.rand(20, 9, generator=g) < 0.6
    got = eops.embed_bag(table.to(dev), idx.to(dev), mask.to(dev),
                         mode="mean")
    torch.testing.assert_close(got.cpu(),
                               eops.embed_bag(table, idx, mask, mode="mean"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("improved", [False, True])
@pytest.mark.parametrize("threshold", [0.25, 1.0])
def test_frontier_update_on_card_equals_full_sweep(dev, improved,
                                                   threshold):
    """The frontier update on the card equals the full-sweep one; at
    threshold 1.0 every wave is masked, so the masked path runs on CUDA
    tensors."""
    n = 3000
    edges = gen.barabasi_albert(n, 3, seed=8)
    ups = gen.random_batch_updates(edges, n, n_ins=20, n_del=20, seed=9)
    out = []
    for frontier in (False, True):
        engine = RelaxEngine(block_v=64, block_e=128, frontier=frontier,
                             frontier_threshold=threshold,
                             frontier_block=16, device=dev)
        g, lab = api.build(n, edges, num_landmarks=8, device=dev,
                           engine=engine)
        WAVES.clear()
        g, lab, aff = api.update(g, lab, ups, pad_to=48, engine=engine,
                                 improved=improved)
        out.append([x.cpu() for x in (g.src, g.valid, g.w, lab.dist,
                                      lab.hub, lab.highway, aff)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    if threshold == 1.0:
        assert WAVES["repair.masked"] == WAVES["repair"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["unfused", "fused", "frontier"])
def test_pipelined_update_on_card_equals_cpu(dev, mode):
    """The pipelined update through the kernels on the card (the fused
    chunks lowering planes in place, or the frontier chunks) commits the
    CPU COO path's snapshot, and leaves the snapshot it started from
    untouched."""
    from repro_torch.core import snapshot as tsnap
    from repro_torch.graphs import coo
    n = 3000
    edges = gen.barabasi_albert(n, 3, seed=10)
    ups = gen.random_batch_updates(edges, n, n_ins=30, n_del=30, seed=11)
    out = []
    for where in ("cpu", dev):
        g, lab = api.build(n, edges, num_landmarks=8, device=where,
                           engine=None)
        batch = coo.make_batch(ups, pad_to=64, device=where)
        g_next = coo.apply_batch(g, batch)
        plan = None
        if where != "cpu":
            plan = RelaxEngine(block_v=64, block_e=128,
                               frontier=mode == "frontier",
                               frontier_block=16,
                               device=where).prepare(g_next)
        before = [t._version for t in (g.src, g.valid, g.w, lab.dist,
                                       lab.hub, lab.highway)]
        nxt, aff = tsnap.run_pipelined_update(tsnap.pipelined_update(
            tsnap.Snapshot(0, g, lab), batch, plan=plan, g_new=g_next,
            chunk_sweeps=2, fused=mode == "fused"))
        assert before == [t._version for t in (g.src, g.valid, g.w,
                                               lab.dist, lab.hub,
                                               lab.highway)]
        out.append([x.cpu() for x in (nxt.graph.src, nxt.graph.valid,
                                      nxt.labelling.dist, nxt.labelling.hub,
                                      nxt.labelling.highway, aff)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_serve_loop_on_card_equals_cpu(dev, pipeline, tmp_path):
    """The serve loop on the card (kernels A and B) commits the CPU
    loop's snapshots, version by version, and writes the same checkpoint
    bytes."""
    import filecmp
    import os
    from repro_torch.launch.serve import ServeConfig, ServeLoop
    reps = []
    for where in ("cpu", dev):
        cfg = ServeConfig(n=2000, deg=3, landmarks=8, batches=2,
                          batch_size=40, queries=32, qps=5000.0,
                          microbatch=8, pipeline=pipeline, block_v=64,
                          block_e=128, quiet=True, keep_history=True,
                          ckpt_dir=str(tmp_path / str(where)))
        reps.append(ServeLoop(cfg, device=where).run())
    for v in reps[0].history:
        a, b = reps[0].history[v], reps[1].history[v]
        for x, y in ((a.graph.src, b.graph.src), (a.graph.valid,
                                                   b.graph.valid),
                     (a.labelling.dist, b.labelling.dist),
                     (a.labelling.hub, b.labelling.hub)):
            assert torch.equal(x, y.cpu())
    step = "step_2"
    names = sorted(os.listdir(tmp_path / "cpu" / step))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "cpu" / step, tmp_path / str(dev) / step, names,
        shallow=False)
    assert mismatch == errors == []


@pytest.mark.cuda
@pytest.mark.parametrize("model", [1, 2, 4])
def test_sharded_update_and_query_on_card_equal_cpu(dev, model):
    """The sharded build, update and query on a mesh of 4 × the one card
    (kernels A and B launched per shard) equal the same run on a mesh of
    4 × the CPU."""
    from repro_torch.core import shard
    from repro_torch.core.construct import select_landmarks_by_degree
    from repro_torch.graphs.coo import apply_batch, from_edges, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    n = 2000
    edges = gen.barabasi_albert(n, 3, seed=5)
    ups = gen.random_batch_updates(edges, n, n_ins=40, n_del=40, seed=6)
    rng = np.random.default_rng(7)
    qs = rng.integers(0, n, 37).astype(np.int32)
    qt = rng.integers(0, n, 37).astype(np.int32)
    out = []
    for where in ("cpu", dev):
        mesh = make_host_mesh(model=model, devices=[where] * 4)
        g = from_edges(n, edges, len(edges) + 64, device=where)
        batch = make_batch(ups, pad_to=80, device=where)
        g1 = apply_batch(g, batch)
        eng = RelaxEngine(block_v=64, block_e=128, device=where)
        lm = select_landmarks_by_degree(g, 8)
        before = (rk.launches, mk.launches)
        lab = shard.shard_build_labelling(mesh, g, lm, plan=eng.prepare(g))
        plan1 = eng.prepare(g1)
        g1, lab1, aff = shard.shard_batchhl_update(mesh, g, batch, lab,
                                                   plan=plan1, g_new=g1)
        d = shard.shard_batched_query(
            mesh, g1, lab1, torch.from_numpy(qs).to(where),
            torch.from_numpy(qt).to(where), plan=plan1)
        if where != "cpu":
            torch.cuda.synchronize()
            # B once per (data, model) shard of the query; A in every
            # shard's waves.
            assert mk.launches == before[1] + 4
            assert rk.launches > before[0]
            with pytest.raises(ValueError, match="CPU only"):
                z = torch.zeros(2, dtype=torch.int32, device=where)
                shard.shard_batched_query(mesh, g1, lab1, z, z,
                                          use_kernel=False, plan=plan1)
        out.append([x.cpu() for x in (lab.dist, lab1.dist, lab1.hub,
                                      lab1.highway, aff, d)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_restore_places_a_leaf_on_the_card(dev, tmp_path):
    """`restore(..., shardings=)` puts the leaf it names on the card and
    the others on `device=`."""
    from repro_torch.checkpoint import manager as ckpt
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "b": torch.arange(3)}
    ckpt.save(str(tmp_path), 1, tree)
    back, _ = ckpt.restore(str(tmp_path), tree, {"w": dev}, device="cpu")
    assert back["w"].device == dev and back["b"].device.type == "cpu"
    assert torch.equal(back["w"].cpu(), tree["w"])
    assert torch.equal(back["b"], tree["b"])
