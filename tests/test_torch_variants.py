"""BHLˢ and UHL⁺ of the PyTorch port against `repro`, bit for bit.

`batchhl_update_split` (insertions, then deletions and re-weights) and
`uhl_update` (one update at a time) on the same numpy inputs through
`repro`'s jnp path and through the port on the CPU, with and without a
`RelaxEngine` (the tiled plain path): graph slots, labelling and `aff`
must equal the reference's, and the final dist planes the port's copy of
the BFS/Dijkstra oracle.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest

from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.core import batch as tbat
from repro_torch.core import ref as tref
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs import coo as tcoo


def _instance(kind: str):
    """The reference test's instance (n = 28, 3 landmarks), or a weighted
    one whose batch also re-weights."""
    n = 28
    edges = jgen.random_connected(n, extra_edges=14, seed=13)
    if kind == "weighted":
        w = np.random.default_rng(14).integers(1, 6, (len(edges), 1))
        edges = np.concatenate([edges, w], 1).astype(np.int32)
        ups = jgen.random_batch_updates(edges, n, n_ins=3, n_del=2, seed=17,
                                        n_rew=2, max_weight=5)
    else:
        ups = jgen.random_batch_updates(edges, n, n_ins=3, n_del=3, seed=17)
    gj = jcoo.from_edges(n, edges, edges.shape[0] + 32)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 3))
    return gj, labj, jcoo.make_batch(ups, pad_to=len(ups) + 1)


def _port(gj, labj, bj):
    return (cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                                device="cpu"),
            cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                    labj.highway, device="cpu"),
            cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                                bj.is_rew, device="cpu"))


@pytest.mark.parametrize("kind", ["unweighted", "weighted"])
@pytest.mark.parametrize("with_engine", [False, True])
@pytest.mark.parametrize("variant", ["split", "unit"])
def test_split_and_unit_variants_parity(variant, with_engine, kind):
    gj, labj, bj = _instance(kind)
    gt, labt, bt = _port(gj, labj, bj)
    jupdate, tupdate = ((jbat.batchhl_update_split, tbat.batchhl_update_split)
                        if variant == "split"
                        else (jbat.uhl_update, tbat.uhl_update))
    want = jupdate(gj, bj, labj)
    engine = RelaxEngine(block_v=16, device="cpu") if with_engine else None
    got_g, got_lab, got_aff = tupdate(gt, bt, labt, engine=engine)
    want_g, want_lab, want_aff = want
    for got, ref in zip(cv.graph_to_numpy(got_g),
                        (want_g.src, want_g.dst, want_g.valid, want_g.w,
                         want_g.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    for got, ref in zip(cv.labelling_to_numpy(got_lab),
                        (want_lab.landmarks, want_lab.dist, want_lab.hub,
                         want_lab.highway)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got_aff.numpy(), np.asarray(want_aff))
    # The third witness: Dijkstra (BFS at w ≡ 1) from every landmark.
    adj = tcoo.to_numpy_wadj(got_g)
    od = tref.minimal_labelling_w(adj, got_g.n,
                                  got_lab.landmarks.tolist())[0]
    want_d = [[int(tcoo.INF_D) if d == tref.INF else d for d in row]
              for row in od]
    assert got_lab.dist.tolist() == want_d
    if with_engine:
        # One tiling per topology change: the split variant tiles once
        # (its deletions reuse it), UHL⁺ once per insert row, and once
        # more when its first row is no insert (nothing is tiled yet).
        ins = ((~bt.is_del) & (~bt.is_rew) & bt.valid).tolist()
        want_tiles = 1 if variant == "split" else sum(ins) + (not ins[0])
        assert engine.retile_count == want_tiles


@pytest.mark.parametrize("variant", ["split", "unit"])
def test_padding_only_batch_changes_nothing(variant):
    gj, labj, bj = _instance("unweighted")
    gt, labt, _ = _port(gj, labj, bj)
    pad = tcoo.make_batch([], pad_to=3, device="cpu")
    update = (tbat.batchhl_update_split if variant == "split"
              else tbat.uhl_update)
    g2, lab2, aff = update(gt, pad, labt, engine=RelaxEngine(device="cpu"))
    assert not aff.any()
    assert g2.valid.equal(gt.valid) and lab2.dist.equal(labt.dist)
