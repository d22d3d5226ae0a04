"""The reference's call forms, members and knobs on the PyTorch port.

`kernels/edge_relax/ops.relax_sweep` and `relax_sweep_sorted` take the
reference's arguments in its order, `(keys, bg|sg, edge_mask, step, inf,
clear_bit=0, hub=None, w=None)`: one plane [V] in and out, `w=None` the
unweighted metric. Both impls (kernel A's plain version on the CPU, and
`sorted`) are held to the reference's two impls in its call forms
`(keys, bg, mask, 1, INF32)` and `(keys, bg, mask, 2, INF32, 1, hub)`,
bit for bit, on cases of `tests/_sweep_cases.py` and on the chunked
tiling of `tests/test_kernel_tuning.py`. `w=None` equals an explicit
unit weight on every case, [P, V] and [V] alike. `Graph.num_edges`,
`HighwayLabelling.num_landmarks` and `label_values`, and
`BlockedGraph.shards` are held to the reference on the same graphs; the
engine's `cache_plans` retiles as the reference's does; a `Cell` made
from the reference's eight fields gets its output shapes from its step.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import construct as jcon
from repro.core import engine as jeng
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro.kernels.edge_relax import ops as jops
from repro_torch import convert as cv
from repro_torch.configs import common as tcommon
from repro_torch.core import construct as tcon
from repro_torch.core import engine as teng
from repro_torch.graphs import coo as tcoo
from repro_torch.kernels.edge_relax import ops as tops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

import _sweep_cases as cases

INF32 = 1 << 29

#: Cases of `tests/_sweep_cases.py` that the reference's Pallas kernel
#: (interpret mode) runs in both call forms: one plane and many, wide and
#: narrow blocks, chunked rows over shards, per-plane masks (plane 0's),
#: saturating keys, an empty mask, zero capacity and the short last shard.
FORM_CASES = ("planes1-bv4", "planes33-bv512", "rows-be7-s2-p3",
              "rows-beNone-s3-p33", "mask-perplane-e2mod2", "near-inf",
              "all-masked", "zero-capacity", "short-last-shard")


def _plane0(c: cases.SweepInput):
    """Plane 0 of case `c` as the reference sweeps it: keys [V], its mask
    [E2], and a hub [V] (the case's, or every third vertex)."""
    mask = c.mask if c.mask.ndim == 1 else c.mask[0]
    hub = c.hub[0] if c.hub is not None else np.arange(c.n) % 3 == 0
    return c.keys[0], mask, hub


def _reference(impl: str, c: cases.SweepInput, keys, mask, *form):
    if impl == "sorted":
        tiles = jops.prepare_sorted(c.src, c.dst, c.keep, c.n)
        sweep = jops.relax_sweep_sorted
    else:
        tiles = jops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                                      c.shards, c.block_e)
        sweep = jops.relax_sweep
    return np.asarray(sweep(jnp.asarray(keys), tiles, jnp.asarray(mask),
                            *form))


def _port(impl: str, c: cases.SweepInput, keys, mask, *form):
    if impl == "sorted":
        tiles = tops.prepare_sorted(c.src, c.dst, c.keep, c.n, device="cpu")
        sweep = tops.relax_sweep_sorted
    else:
        tiles = tops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                                      c.shards, c.block_e, device="cpu")
        sweep = tops.relax_sweep
    return sweep(torch.from_numpy(keys), tiles, torch.from_numpy(mask),
                 *form).numpy()


@pytest.mark.parametrize("impl", ["kernel", "sorted"])
@pytest.mark.parametrize("name", FORM_CASES)
def test_reference_call_forms_match_reference(impl, name):
    """`(keys, bg, mask, 1, INF32)` and `(keys, bg, mask, 2, INF32, 1,
    hub)` on plane 0, positional as the reference's tests write them:
    [V] out, equal to the reference's bit for bit."""
    c = cases.make(name, max_edges=4096)[0]
    keys, mask, hub = _plane0(c)
    for form in ((1, INF32), (2, INF32, 1)):
        got_hub = () if len(form) == 2 else (torch.from_numpy(hub),)
        want_hub = () if len(form) == 2 else (jnp.asarray(hub),)
        want = _reference(impl, c, keys, mask, *form, *want_hub)
        got = _port(impl, c, keys, mask, *form, *got_hub)
        assert got.shape == (c.n,)
        np.testing.assert_array_equal(got, want, err_msg=f"{form}")


@pytest.mark.parametrize("impl", ["kernel", "sorted"])
def test_chunked_rows_hidden_in_short_last_shard_reference_form(impl):
    """The reference's own chunked tiling and call form
    (`tests/test_kernel_tuning.py::test_chunked_rows_hidden_in_short_last_shard`):
    n=24, block_v=8, shards=2, block_e=4, keys [V], w=None."""
    n = 24
    rng = np.random.default_rng(0)
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    keep = np.ones(len(dst), bool)
    keys = rng.integers(0, 2 * n, n).astype(np.int32)
    c = cases.SweepInput(label="chunked", src=src, dst=dst, keep=keep, n=n,
                         block_v=8, shards=2, block_e=4, keys=keys[None],
                         hub=None, mask=keep, w=np.ones(len(dst), np.int32),
                         step=1, inf=INF32, clear=0)
    bg = tops.prepare_topology(src, dst, keep, n, block_v=8, shards=2,
                               block_e=4, device="cpu")
    assert bg.chunked and bg.src_t.shape[1] == bg.nb
    np.testing.assert_array_equal(
        _port(impl, c, keys, keep, 1, INF32),
        _reference(impl, c, keys, keep, 1, INF32))


@pytest.mark.parametrize("name", cases.names())
def test_unit_w_and_single_plane_forms(name):
    """On every sweep of the case, both impls: `w=None` equals an explicit
    unit weight, and each plane swept alone as [V] (with its mask and
    hub) equals its row of the [P, V] sweep."""
    for c in cases.make(name, max_edges=4096):
        args = cases.sweep_args(c, "cpu")
        keys, hub, mask = args[0], args[1], args[7]
        bg = tops.prepare_topology(c.src, c.dst, c.keep, c.n, c.block_v,
                                   c.shards, c.block_e, device="cpu")
        sg = tops.prepare_sorted(c.src, c.dst, c.keep, c.n, device="cpu")
        unit = torch.ones(len(c.src), dtype=torch.int32)
        for sweep, tiles in ((tops.relax_sweep, bg),
                             (tops.relax_sweep_sorted, sg)):
            full = sweep(keys, tiles, mask, c.step, c.inf, c.clear, hub)
            assert torch.equal(full, sweep(keys, tiles, mask, c.step, c.inf,
                                           c.clear, hub, unit)), c.label
            for p in (0, keys.shape[0] - 1):
                one = sweep(keys[p], tiles, mask if mask.dim() == 1
                            else mask[p], c.step, c.inf, c.clear,
                            None if hub is None else hub[p])
                assert torch.equal(one, full[p]), (c.label, p)


def _graph_pair(n=40, extra=30, seed=5):
    """The same graph in both packages, with free slots, and one batch
    of inserts, deletes and re-weights applied to each."""
    edges = jgen.random_connected(n, extra_edges=extra, seed=seed)
    gj = jcoo.from_edges(n, edges, len(edges) + 6)
    ups = jgen.random_batch_updates(edges, n, n_ins=5, n_del=7, seed=seed,
                                    n_rew=3, max_weight=6)
    bj = jcoo.make_batch(ups, pad_to=16)
    gt = cv.graph_from_numpy(*(np.asarray(x) for x in
                               (gj.src, gj.dst, gj.valid, gj.w)), n,
                             device="cpu")
    bt = cv.batch_from_numpy(*(np.asarray(getattr(bj, f.name)) for f in
                               dataclasses.fields(bj)), device="cpu")
    return (gj, jcoo.apply_batch(gj, bj)), (gt, tcoo.apply_batch(gt, bt))


def test_num_edges_matches_reference():
    for gj, gt in zip(*_graph_pair()):
        got = gt.num_edges()
        assert got.dim() == 0
        assert int(got) == int(gj.num_edges())


@pytest.mark.parametrize("k", [1, 4])
def test_num_landmarks_and_label_values_match_reference(k):
    for gj, gt in zip(*_graph_pair()):
        lm_j = jcon.select_landmarks_by_degree(gj, k)
        lab_j = jcon.build_labelling(gj, lm_j)
        lab_t = tcon.build_labelling(gt, torch.from_numpy(np.array(lm_j)))
        assert lab_t.num_landmarks == lab_j.num_landmarks == k
        np.testing.assert_array_equal(lab_t.label_values().numpy(),
                                      np.asarray(lab_j.label_values()))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_blocked_graph_shards_matches_reference(shards):
    gj, _ = _graph_pair()[0]
    slots = (np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.valid))
    got = tops.prepare_topology(*slots, gj.n, 8, shards, 4, device="cpu")
    want = jops.prepare_topology(*slots, gj.n, 8, shards, 4)
    assert got.shards == want.shards == shards
    np.testing.assert_array_equal(got.src_t.numpy(), np.asarray(want.src_t))


@pytest.mark.parametrize("cache_plans", [1, 2, 3])
def test_cache_plans_retiles_as_reference(cache_plans):
    """Six prepares alternating between two snapshots: with one plan kept
    every prepare retiles, with two or more only the first two do, in
    both packages."""
    (gj, gj2), (gt, gt2) = _graph_pair()
    eng_j = jeng.RelaxEngine(backend="pallas", block_v=16,
                             cache_plans=cache_plans)
    eng_t = teng.RelaxEngine(block_v=16, cache_plans=cache_plans,
                             device="cpu")
    for _ in range(3):
        for g_j, g_t in ((gj, gt), (gj2, gt2)):
            eng_j.prepare(g_j)
            eng_t.prepare(g_t)
            assert (eng_t.retile_count, eng_t.plan_cache_hits) == \
                (eng_j.retile_count, eng_j.plan_cache_hits)
    assert eng_t.retile_count == (6 if cache_plans == 1 else 2)


@pytest.mark.parametrize("bad", [0, -1])
def test_cache_plans_below_one_raises_as_reference(bad):
    with pytest.raises(ValueError, match="cache_plans must be >= 1"):
        jeng.RelaxEngine(backend="pallas", cache_plans=bad)
    with pytest.raises(ValueError, match="cache_plans must be >= 1"):
        teng.RelaxEngine(cache_plans=bad, device="cpu")


def test_cell_of_eight_fields_gets_out_shapes_from_its_step():
    """A `Cell` made with the reference's eight fields (no `out_shapes`)
    gives the dry run the same output bytes as the port's own cell."""
    cell = tcommon.mind_cell(tcommon.get_arch("mind").reduced_config(),
                             "serve_p99", False)
    eight = tcommon.Cell(*(getattr(cell, f.name) for f in
                           dataclasses.fields(cell)
                           if f.name != "out_shapes"))
    assert eight.out_shapes is None
    mesh = make_production_mesh(multi_pod=False)
    assert dryrun.output_bytes(eight, mesh) == \
        dryrun.output_bytes(cell, mesh) > 0
