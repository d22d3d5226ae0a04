"""The relax sweep of the PyTorch port against `repro`, bit for bit.

Kernel A's plain version (`kernels/edge_relax/kernel.py:relax_sweep_plain`,
what the wrapper runs for CPU tensors) and the port's COO reference
(`core/engine.relax_sweep(plan=None)`) are held to the reference's Pallas
`relax_sweep_pallas` (interpret mode) and its jnp engine branch, over the
three parameter sets, ragged `block_e`, the short-last-shard tiling,
near-INF weights, an empty mask, per-plane and shared masks and P > 1
planes. Every edge case of `tests/_sweep_cases.py` (plane counts up
to 1024 and block_v up to 12288 among them, and the `wide-*` cases past
`SWEEP_MAX_BLOCK_V`) is held to the reference too, through the kernel's
wrapper and `ops.relax_sweep`, and the kernel's mode rule and
plane-group sizing are checked on their own. The host tiling
arrays and the engine's fingerprint and plan cache are compared too.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.graphs.coo import Graph as JGraph
from repro.kernels.edge_relax import kernel as jker
from repro.kernels.edge_relax import ops as jops
from repro_torch.core import engine as teng
from repro_torch.graphs.coo import INF_D, Graph as TGraph
from repro_torch.core.labelling import INF_KEY2, INF_KEY4
from repro_torch.kernels.edge_relax import kernel as tker
from repro_torch.kernels.edge_relax import ops as tops

import _sweep_cases as cases

PARAMS = [(1, INF_D, 0), (2, INF_KEY2, 1), (4, INF_KEY4, 2)]


def _topology(n=61, m=240, seed=0, planes=3):
    """Random multigraph slots with capacity slack and per-sweep churn:
    `keep` is what prepare sees, `mask` the live edges of one sweep (one
    row per plane), n=61 leaves a ragged tail block."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = rng.random(m) < 0.8
    mask = keep & (rng.random((planes, m)) < 0.85)
    w = rng.integers(1, 9, m).astype(np.int32)
    hub = rng.random((planes, n)) < 0.3
    return src, dst, keep, mask, w, hub


def _keys(rng, planes, n, inf):
    return rng.integers(0, inf, (planes, n), endpoint=True).astype(np.int32)


def _jax_plane(step, inf, clear, bg, keys, mask, hub, w):
    """The reference Pallas sweep (interpret mode) of one plane."""
    return np.asarray(jops.relax_sweep(
        jnp.asarray(keys), bg, jnp.asarray(mask), step, inf,
        clear_bit=clear, hub=None if hub is None else jnp.asarray(hub),
        w=jnp.asarray(w)))


def _jnp_plane(step, inf, clear, g, keys, mask, hub):
    """The reference engine's jnp branch for one plane."""
    return np.asarray(jeng.relax_sweep(
        jeng.JNP_PLAN, g, jnp.asarray(keys), step, inf,
        hub=None if hub is None else jnp.asarray(hub), clear_bit=clear,
        edge_mask=jnp.asarray(mask)))


def _port_tiled(bg, keys, mask, w, step, inf, clear, hub):
    return tops.relax_sweep(torch.from_numpy(keys), bg,
                            torch.from_numpy(mask), step, inf,
                            clear_bit=clear,
                            hub=None if hub is None else torch.from_numpy(hub),
                            w=torch.from_numpy(w)).numpy()


@pytest.mark.parametrize("n,bv,shards,be", [
    (61, 16, 1, None), (61, 16, 2, 7), (61, 16, 3, 1), (24, 8, 2, 4),
    (30, 64, 1, 5)])
def test_tiling_arrays_match(n, bv, shards, be):
    src, dst, keep, *_ = _topology(n=n, m=4 * n, seed=n + bv)
    tiles_t = tker.block_edges_topology(src, dst, keep, n, bv, be)
    tiles_j = jker.block_edges_topology(src, dst, keep, n, bv, be)
    for got, want in zip(tiles_t, tiles_j):
        np.testing.assert_array_equal(got, want)
    nb = -(-n // bv)
    for got, want in zip(
            tker.shard_tiling(shards, nb, tiles_t[4], *tiles_t[:4]),
            jker.shard_tiling(shards, nb, tiles_j[4], *tiles_j[:4])):
        np.testing.assert_array_equal(got, want)
    want = jops.prepare_topology(src, dst, keep, n, bv, shards, be)
    got = tops.prepare_topology(src, dst, keep, n, bv, shards, be,
                                device="cpu")
    for f in ("src_t", "dstloc_t", "perm_t", "slot_t", "rowblk_t"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert (got.n, got.block_v, got.nb, got.chunked) == \
        (want.n, want.block_v, want.nb, want.chunked)
    assert tker.aligned_vertex_count(n, bv, shards) == -(-n // (bv * shards)) \
        * bv * shards


@pytest.mark.parametrize("step,inf,clear", PARAMS)
@pytest.mark.parametrize("block_e", [1, 7, 13])
def test_sweep_matches_pallas_and_jnp(step, inf, clear, block_e):
    """Kernel A's plain version on [P, V] planes, per-plane masks and hub,
    against the reference kernel and jnp branch run plane by plane."""
    n = 61
    src, dst, keep, mask, w, hub = _topology(seed=block_e * 3 + step)
    keys = _keys(np.random.default_rng(step), 3, n, inf)
    jbg = jops.prepare_topology(src, dst, keep, n, 16, 2, block_e)
    tbg = tops.prepare_topology(src, dst, keep, n, 16, 2, block_e,
                                device="cpu")
    jg = JGraph(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(keep),
                jnp.asarray(w), n)
    got = _port_tiled(tbg, keys, mask, w, step, inf, clear, hub)
    want = np.stack([_jnp_plane(step, inf, clear, jg, k, m, h)
                     for k, m, h in zip(keys, mask, hub)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[0], _jax_plane(step, inf, clear, jbg, keys[0], mask[0], hub[0],
                           w))
    # The port's COO reference branch gives the same planes.
    tg = TGraph(torch.from_numpy(src), torch.from_numpy(dst),
                torch.from_numpy(keep), torch.from_numpy(w), n)
    coo = teng.relax_sweep(None, tg, torch.from_numpy(keys), step, inf,
                           hub=torch.from_numpy(hub), clear_bit=clear,
                           edge_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(coo.numpy(), want)


def test_shared_mask_no_hub_equals_per_plane_copies():
    """A shared [E2] mask equals the same mask repeated per plane, and
    hub=None equals an all-False hub."""
    n = 61
    src, dst, keep, mask, w, _ = _topology(seed=21)
    keys = _keys(np.random.default_rng(21), 4, n, INF_D)
    bg = tops.prepare_topology(src, dst, keep, n, 16, 1, 7, device="cpu")
    shared = _port_tiled(bg, keys, mask[0], w, 1, INF_D, 0, None)
    per_plane = _port_tiled(bg, keys, np.repeat(mask[:1], 4, 0), w, 1,
                            INF_D, 0, np.zeros((4, n), bool))
    np.testing.assert_array_equal(shared, per_plane)
    jg = JGraph(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(keep),
                jnp.asarray(w), n)
    np.testing.assert_array_equal(
        shared, np.stack([_jnp_plane(1, INF_D, 0, jg, k, mask[0], None)
                          for k in keys]))


def test_chunked_rows_hidden_in_short_last_shard():
    """n=24, block_v=8, shards=2, block_e=4: the last shard's lone block
    chunks into two rows that exactly fill it, so post-shard shapes look
    unchunked; its partial rows must still fold."""
    n = 24
    rng = np.random.default_rng(0)
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    keep = np.ones(len(dst), bool)
    w = np.ones(len(dst), np.int32)
    keys = rng.integers(0, 2 * n, (1, n)).astype(np.int32)
    tbg = tops.prepare_topology(src, dst, keep, n, 8, 2, 4, device="cpu")
    assert tbg.chunked and tbg.src_t.shape[1] == tbg.nb
    jbg = jops.prepare_topology(src, dst, keep, n, 8, 2, 4)
    got = _port_tiled(tbg, keys, keep, w, 1, 1 << 29, 0, None)
    np.testing.assert_array_equal(
        got[0], _jax_plane(1, 1 << 29, 0, jbg, keys[0], keep, None, w))


@pytest.mark.parametrize("step,inf,clear", PARAMS)
def test_saturating_relaxation_near_inf(step, inf, clear):
    """Keys step·INF_D + step − 1 through w = INF_D edges: the int32 sum
    wraps at step 4 in the reference; every path clamps at inf."""
    n = 6
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 2, 3, 4], np.int32)
    keep = np.ones(4, bool)
    w = np.full(4, INF_D, np.int32)
    keys = np.full((1, n), step * INF_D + step - 1, np.int32)
    hub = np.array([[False, True, False, True, False, False]])
    bg = tops.prepare_topology(src, dst, keep, n, 4, 1, None, device="cpu")
    got = _port_tiled(bg, keys, keep, w, step, inf, clear, hub)
    jbg = jops.prepare_topology(src, dst, keep, n, 4, 1, None)
    np.testing.assert_array_equal(
        got[0], _jax_plane(step, inf, clear, jbg, keys[0], keep, hub[0], w))
    assert (got >= 0).all() and (got <= inf).all()
    assert got[0, 1] == inf & ~clear  # saturated, then hub-cleared


def test_all_edges_masked_out():
    n = 61
    src, dst, keep, _, w, hub = _topology(seed=13)
    keys = _keys(np.random.default_rng(13), 2, n, INF_KEY2)
    bg = tops.prepare_topology(src, dst, keep, n, 16, 2, 7, device="cpu")
    got = _port_tiled(bg, keys, np.zeros_like(keep), w, 2, INF_KEY2, 1,
                      hub[:2])
    np.testing.assert_array_equal(got, np.full((2, n), INF_KEY2))


def _jax_graph(gt: TGraph):
    return JGraph(*(jnp.asarray(x.numpy()) for x in
                    (gt.src, gt.dst, gt.valid, gt.w)), gt.n)


def test_fingerprint_and_plan_cache_match_reference():
    from repro_torch.graphs import coo as tcoo
    from repro.graphs import coo as jcoo
    from repro.graphs import generators as jgen
    edges = jgen.random_connected(30, extra_edges=20, seed=4)
    gt = tcoo.from_edges(30, edges, len(edges) + 8, device="cpu")
    gj = _jax_graph(gt)
    assert teng.RelaxEngine.snapshot_fingerprint(gt) == \
        jeng.RelaxEngine._snapshot_fingerprint(gj)

    # Same edge multiset, different slot layout: different fingerprints.
    swapped = tcoo.from_edges(30, edges[::-1], len(edges) + 8, device="cpu")
    assert teng.RelaxEngine.snapshot_fingerprint(swapped) != \
        teng.RelaxEngine.snapshot_fingerprint(gt)

    eng_t = teng.RelaxEngine(block_v=8, device="cpu")
    eng_j = jeng.RelaxEngine(backend="pallas", block_v=8)
    dele = tcoo.make_batch([(int(edges[0, 0]), int(edges[0, 1]), True)],
                           device="cpu")
    present = {(min(a, b), max(a, b)) for a, b in edges.tolist()}
    new = next((u, v) for u in range(30) for v in range(u + 1, 30)
               if (u, v) not in present)
    ins = tcoo.make_batch([(*new, False)], device="cpu")
    g_del = tcoo.apply_batch(gt, dele)
    g_ins = tcoo.apply_batch(g_del, ins)
    steps = [(gt, True, True), (g_del, False, True), (g_ins, False, True),
             (gt, True, True), (g_ins, True, True)]
    for g, changed, verify in steps:
        pt = eng_t.prepare(g, topology_changed=changed, verify_cache=verify)
        pj = eng_j.prepare(_jax_graph(g), topology_changed=changed,
                           verify_cache=verify)
        for f in ("src_t", "perm_t", "slot_t", "rowblk_t"):
            np.testing.assert_array_equal(getattr(pt.tiles, f).numpy(),
                                          np.asarray(getattr(pj.tiles, f)))
    assert (eng_t.retile_count, eng_t.plan_cache_hits,
            eng_t.stale_cache_retiles) == \
        (eng_j.retile_count, eng_j.plan_cache_hits, eng_j.stale_cache_retiles)
    assert eng_t.stale_cache_retiles == 1


@pytest.mark.parametrize("name", cases.names())
def test_sweep_edge_cases_match_reference(name):
    """Each sweep of the edge case: the port's tiled sweep on the CPU
    (kernel A's plain version, through the wrapper and `ops.relax_sweep`)
    against the reference's jnp branch over all planes (vmapped), and
    plane 0 against its Pallas kernel. (`test_torch_autotune.py` holds
    the `sorted` impl to the plain version on the same cases.)"""
    for c in cases.make(name, max_edges=4096):
        args = cases.sweep_args(c, "cpu")
        got = tker.relax_sweep(*args).numpy()
        bg = tops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                                   c.shards, c.block_e, device="cpu")
        np.testing.assert_array_equal(
            tops.relax_sweep(args[0], bg, args[7], c.step, c.inf,
                             clear_bit=c.clear, hub=args[1],
                             w=args[8]).numpy(), got,
            err_msg=f"ops.relax_sweep: {c.label}")
        jg = JGraph(*(jnp.asarray(x) for x in (c.src, c.dst, c.keep, c.w)),
                    c.n)
        hub = None if c.hub is None else jnp.asarray(c.hub)
        want = jax.vmap(
            lambda k, m, h: jeng.relax_sweep(
                jeng.JNP_PLAN, jg, k, c.step, c.inf, hub=h,
                clear_bit=c.clear, edge_mask=m),
            in_axes=(0, 0 if c.mask.ndim == 2 else None,
                     None if hub is None else 0))(
            jnp.asarray(c.keys), jnp.asarray(c.mask), hub)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=c.label)
        jbg = jops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                                    c.shards, c.block_e)
        np.testing.assert_array_equal(
            got[0], _jax_plane(c.step, c.inf, c.clear, jbg, c.keys[0],
                               c.mask if c.mask.ndim == 1 else c.mask[0],
                               None if c.hub is None else c.hub[0], c.w),
            err_msg=c.label)


@pytest.mark.parametrize("p", cases.PLANES)
@pytest.mark.parametrize("block_v", cases.BLOCK_VS + (tker.SWEEP_MAX_BLOCK_V,)
                         + cases.WIDE_BLOCK_VS + (1 << 20,))
def test_plane_group_fits_shared_memory(p, block_v):
    """Kernel A's plane group: at most 32 planes and the shared-memory
    limit, as few groups as that allows, evened out over them."""
    g = tker.plane_group(p, block_v)
    assert 1 <= g <= min(p, tker.SWEEP_MAX_GROUP)
    assert tker.sweep_shared_bytes(g, block_v) <= tker.SWEEP_SHARED_BYTES
    groups = -(-p // g)
    assert groups * g - p < groups  # evened out: no group short by > 1
    widest = max(k for k in range(1, tker.SWEEP_MAX_GROUP + 1)
                 if tker.sweep_shared_bytes(k, block_v)
                 <= tker.SWEEP_SHARED_BYTES)
    assert groups == -(-p // min(p, widest))


def test_plane_group_limits():
    assert tker.plane_group(32, 512) == 32
    assert tker.sweep_shared_bytes(32, 512) == 75_776  # three CTAs per SM
    assert tker.plane_group(33, 512) == 17
    assert tker.plane_group(100, 512) == 25
    assert tker.plane_group(32, 12288) == 2
    assert tker.SWEEP_MAX_BLOCK_V == 28032
    assert tker.sweep_shared_bytes(1, 28032) == tker.SWEEP_SHARED_BYTES
    # One vertex wider no longer raises: the wide mode takes it, with the
    # staged chunks alone in shared memory and a full group of planes.
    assert tker.sweep_mode(28033) == "wide"
    assert tker.plane_group(1, 28033) == 1
    assert tker.plane_group(32, 28033) == 32
    assert tker.sweep_shared_bytes(32, 28033) == 8 * 4 * tker.SWEEP_CHUNK


@pytest.mark.parametrize("p,block_v,mode,group", [
    (1, 4, "tiled", 1), (32, 512, "tiled", 32), (33, 512, "tiled", 17),
    (32, 12288, "tiled", 2), (32, tker.SWEEP_MAX_BLOCK_V, "tiled", 1),
    (1024, tker.SWEEP_MAX_BLOCK_V, "tiled", 1),
    (1, tker.SWEEP_MAX_BLOCK_V + 1, "wide", 1),
    (3, tker.SWEEP_MAX_BLOCK_V + 1, "wide", 3),
    (33, tker.SWEEP_MAX_BLOCK_V + 1, "wide", 17),
    (32, 65_536, "wide", 32), (100, 65_536, "wide", 25),
    (1024, 1 << 20, "wide", 32), (32, 1 << 24, "wide", 32)])
def test_sweep_mode_rule(p, block_v, mode, group):
    """The wrapper's mode and plane group from (P, block_v) alone: the
    tiled mode up to SWEEP_MAX_BLOCK_V, whose group the shared memory
    sizes; the wide mode past it, min(P, 32) planes evened out, the
    staged chunks alone in shared memory."""
    assert tker.sweep_mode(block_v) == mode
    assert tker.plane_group(p, block_v) == group
    smem = tker.sweep_shared_bytes(group, block_v)
    assert smem <= tker.SWEEP_SHARED_BYTES
    assert (smem == 8 * 4 * tker.SWEEP_CHUNK) == (mode == "wide")
