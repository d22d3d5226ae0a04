"""Directed BatchHL of the port against `repro`, bit for bit.

Mirrors `tests/test_directed.py` (construction and a batch update against
the directed BFS oracle, at fixed seeds where the reference draws them
with hypothesis; the batch builds all six fields of `BatchUpdate`) and
`tests/test_directed_engine.py` (construction, update and queries through
one engine per orientation equal the COO path). Every comparison also
holds the port to `repro`'s jnp path on the same numpy inputs: the arc
slots, `fwd`/`bwd` dist, hub and highway, `aff` and the answers. Also a
weighted digraph with re-weights and a delete and re-insert, the
free-slot rule, and the numpy converters.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import directed as jdir
from repro.graphs.coo import BatchUpdate as JBatchUpdate
from repro.graphs.coo import make_batch as jmake_batch
from repro_torch import convert
from repro_torch.core import directed as tdir
from repro_torch.core import engine as teng
from repro_torch.core import ref
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs.coo import INF_D, BatchUpdate, make_batch


def _random_digraph(rng, n):
    """The reference test's generator: a weakly connected backbone, then
    random arcs up to 1–3 per vertex."""
    m = max(n, int(rng.integers(n, 3 * n)))
    arcs = set()
    for v in range(1, n):
        u = int(rng.integers(v))
        arcs.add((u, v) if rng.random() < 0.7 else (v, u))
    while len(arcs) < m:
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if u != v:
            arcs.add((u, v))
    return np.asarray(sorted(arcs), np.int32)


def _landmarks(arcs, n, k):
    deg = np.zeros(n)
    for u, v in arcs[:, :2]:
        deg[u] += 1
        deg[v] += 1
    return np.argsort(-deg, kind="stable")[:k].astype(np.int32)


def _adj_out(g):
    adj = {v: set() for v in range(g.n)}
    for s, d, ok in zip(g.src.tolist(), g.dst.tolist(), g.valid.tolist()):
        if ok:
            adj[s].add(d)
    return adj


def _check_plane(lab_plane, adj_out, n, landmarks):
    """One orientation's labelling against the port's copy of the directed
    oracle."""
    od, oh, _, omask = ref.minimal_labelling_directed(adj_out, n,
                                                      list(landmarks))
    dist, hub = lab_plane.dist.numpy(), lab_plane.hub.numpy()
    mask = lab_plane.label_mask().numpy()
    for i in range(len(landmarks)):
        for v in range(n):
            want = od[i][v] if od[i][v] != ref.INF else INF_D
            assert dist[i, v] == want, (i, v)
            if od[i][v] != ref.INF:
                assert bool(hub[i, v]) == oh[i][v], (i, v)
            assert bool(mask[i, v]) == omask[i][v], (i, v)


def _assert_graph(got, want):
    for f in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _assert_labelling(got, want):
    for plane in ("fwd", "bwd"):
        for f in ("landmarks", "dist", "hub", "highway"):
            np.testing.assert_array_equal(
                getattr(getattr(got, plane), f).numpy(),
                np.asarray(getattr(getattr(want, plane), f)),
                err_msg=f"{plane}.{f}")


def _plans(g, kind, block_v=16):
    """(plan_fwd, plan_bwd): None for the COO path, else one engine per
    orientation (kernel A's plain twin, or the autotuned sorted impl)."""
    if kind == "coo":
        return None, None
    return tuple(RelaxEngine(block_v=block_v, autotune=kind == "sorted",
                             device="cpu").prepare(og)
                 for og in (g.fwd(), g.rev()))


# --- construction and a batch update against the oracle ---------------------

@pytest.mark.parametrize("seed,n", [(0, 8), (7, 19), (42, 32)])
def test_directed_construction_matches_oracle(seed, n):
    rng = np.random.default_rng(seed)
    arcs = _random_digraph(rng, n)
    g = tdir.from_arcs(n, arcs, arcs.shape[0] + 16, device="cpu")
    landmarks = _landmarks(arcs, n, 3)
    lab = tdir.build_directed_labelling(g, torch.from_numpy(landmarks))
    adj_out = _adj_out(g)
    _check_plane(lab.fwd, adj_out, n, landmarks)
    _check_plane(lab.bwd, ref.reverse_adj(adj_out, n), n, landmarks)
    gj = jdir.from_arcs(n, arcs, arcs.shape[0] + 16)
    _assert_graph(g, gj)
    _assert_labelling(lab, jdir.build_directed_labelling(
        gj, jnp.asarray(landmarks)))


@pytest.mark.parametrize("seed,n,n_ins,n_del", [
    (1, 20, 0, 0), (3, 20, 4, 0), (5, 20, 0, 4), (11, 20, 4, 4),
    (13, 20, 2, 3)])
def test_directed_batch_update_and_queries(seed, n, n_ins, n_del):
    """The reference test's draws at fixed seeds. Capacity (3n + 10) and
    the batch's rows (8) are fixed, so `repro` compiles its update once."""
    rng = np.random.default_rng(seed)
    arcs = _random_digraph(rng, n)
    cap = 3 * n + 10
    g = tdir.from_arcs(n, arcs, cap, device="cpu")
    landmarks = _landmarks(arcs, n, 3)
    lab = tdir.build_directed_labelling(g, torch.from_numpy(landmarks))

    existing = {(int(u), int(v)) for u, v in arcs}
    ups = []
    if n_del:
        picks = rng.choice(len(arcs), size=min(n_del, len(arcs)),
                           replace=False)
        ups += [(int(arcs[i, 0]), int(arcs[i, 1]), True) for i in picks]
    tries = 0
    while sum(1 for x in ups if not x[2]) < n_ins and tries < 200:
        tries += 1
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if u != v and (u, v) not in existing:
            existing.add((u, v))
            ups.append((u, v, False))
    if ups:
        batch = make_batch(ups, pad_to=8, device="cpu")
        jbatch = jmake_batch(ups, pad_to=8)
    else:
        # No valid row: all six fields of BatchUpdate, built by hand.
        fields = (np.zeros(8, np.int32), np.ones(8, np.int32),
                  np.zeros(8, bool), np.zeros(8, bool), np.ones(8, np.int32),
                  np.zeros(8, bool))
        batch = BatchUpdate(*map(torch.from_numpy, fields))
        jbatch = JBatchUpdate(*map(jnp.asarray, fields))

    g2, lab2, aff = tdir.batchhl_update_directed(g, batch, lab)
    adj2 = ref.apply_updates_directed(_adj_out(g), ups)
    assert _adj_out(g2) == adj2
    _check_plane(lab2.fwd, adj2, n, landmarks)
    _check_plane(lab2.bwd, ref.reverse_adj(adj2, n), n, landmarks)

    qs = rng.integers(0, n, 12).astype(np.int32)
    qt = rng.integers(0, n, 12).astype(np.int32)
    got = tdir.directed_query(g2, lab2, torch.from_numpy(qs),
                              torch.from_numpy(qt)).numpy()
    for k in range(12):
        want = ref.bfs_dist_directed(adj2, n, int(qs[k]))[int(qt[k])]
        want = 0 if qs[k] == qt[k] else want
        want = INF_D if want == ref.INF else want
        assert got[k] == want, (qs[k], qt[k])

    gj = jdir.from_arcs(n, arcs, cap)
    labj = jdir.build_directed_labelling(gj, jnp.asarray(landmarks))
    g2j, lab2j, affj = jdir.batchhl_update_directed(gj, jbatch, labj)
    _assert_graph(g2, g2j)
    _assert_labelling(lab2, lab2j)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(affj))
    np.testing.assert_array_equal(got, np.asarray(jdir.directed_query(
        g2j, lab2j, jnp.asarray(qs), jnp.asarray(qt))))


# --- one engine per orientation ---------------------------------------------

def _digraph(seed=0, n=40, extra=50):
    rng = np.random.default_rng(seed)
    arcs = set()
    for v in range(1, n):
        u = int(rng.integers(v))
        arcs.add((u, v) if rng.random() < 0.7 else (v, u))
    while len(arcs) < n - 1 + extra:
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if u != v:
            arcs.add((u, v))
    return np.asarray(sorted(arcs), np.int32), n, rng


@pytest.fixture(scope="module")
def reference_update():
    """`repro`'s jnp path on the engine test's instance: build, a 5-row
    batch (2 deletions, 3 insertions, one padding row), 24 queries."""
    arcs, n, rng = _digraph(seed=1)
    lms = np.asarray([0, 3, 7], np.int32)
    ups = [(int(arcs[3, 0]), int(arcs[3, 1]), True),
           (int(arcs[11, 0]), int(arcs[11, 1]), True),
           (7, 31, False), (22, 2, False), (15, 33, False)]
    qs = rng.integers(0, n, 24).astype(np.int32)
    qt = rng.integers(0, n, 24).astype(np.int32)
    gj = jdir.from_arcs(n, arcs, arcs.shape[0] + 8)
    labj = jdir.build_directed_labelling(gj, jnp.asarray(lms))
    out = jdir.batchhl_update_directed(gj, jmake_batch(ups, pad_to=6), labj)
    d = np.asarray(jdir.directed_query(out[0], out[1], jnp.asarray(qs),
                                       jnp.asarray(qt)))
    return dict(arcs=arcs, n=n, lms=lms, ups=ups, qs=qs, qt=qt, lab0=labj,
                out=out, answers=d)


@pytest.mark.parametrize("kind", ["coo", "kernel", "sorted"])
def test_directed_construction_backend_parity(kind):
    arcs, n, _ = _digraph()
    g = tdir.from_arcs(n, arcs, arcs.shape[0] + 8, device="cpu")
    lms = torch.tensor([0, 5, 9], dtype=torch.int32)
    pf, pb = _plans(g, kind)
    if kind != "coo":
        assert (pf.impl, pb.impl) == (kind, kind)
    teng.WAVES.clear()
    lab = tdir.build_directed_labelling(g, lms, pf, pb)
    assert teng.WAVES["construct"] > 0
    gj = jdir.from_arcs(n, arcs, arcs.shape[0] + 8)
    _assert_labelling(lab, jdir.build_directed_labelling(
        gj, jnp.asarray(lms.numpy())))


@pytest.mark.parametrize("kind", ["coo", "kernel", "sorted"])
def test_directed_update_and_query_backend_parity(reference_update, kind):
    r = reference_update
    arcs, n = r["arcs"], r["n"]
    g = tdir.from_arcs(n, arcs, arcs.shape[0] + 8, device="cpu")
    lab = tdir.build_directed_labelling(g, torch.from_numpy(r["lms"]))
    _assert_labelling(lab, r["lab0"])
    batch = make_batch(r["ups"], pad_to=len(r["ups"]) + 1, device="cpu")
    # Plans from the post-update snapshot, one per orientation.
    g2 = tdir.apply_batch_directed(g, batch)
    pf, pb = _plans(g2, kind)
    teng.WAVES.clear()
    gp, labp, aff = tdir.batchhl_update_directed(g, batch, lab, pf, pb,
                                                 g_new=g2)
    assert teng.WAVES["directed_search"] > 0
    g2j, lab2j, affj = r["out"]
    _assert_graph(gp, g2j)
    _assert_labelling(labp, lab2j)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(affj))
    got = tdir.directed_query(gp, labp, torch.from_numpy(r["qs"]),
                              torch.from_numpy(r["qt"]), plan_fwd=pf,
                              plan_bwd=pb).numpy()
    assert teng.WAVES["directed_bibfs"] > 0
    np.testing.assert_array_equal(got, r["answers"])
    adj = _adj_out(gp)
    for k in range(24):
        s, t = int(r["qs"][k]), int(r["qt"][k])
        want = 0 if s == t else ref.bfs_dist_directed(adj, n, s)[t]
        assert got[k] == (INF_D if want == ref.INF else want), (s, t)


# --- weighted arcs -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["coo", "kernel"])
def test_weighted_directed_reweight_delete_reinsert(kind):
    """(tail, head, w) arcs, two ticks: re-weights (one of a non-arc) and a
    deletion, then the deleted arc back at another weight and a re-weight
    of it in the same batch. Each tick against `repro` and the Dijkstra
    oracle on the arcs."""
    rng = np.random.default_rng(4)
    arcs = _random_digraph(rng, 24)
    arcs = np.concatenate([arcs, rng.integers(1, 6, (len(arcs), 1))],
                          axis=1).astype(np.int32)
    n, lms = 24, _landmarks(arcs, 24, 3)
    a0, a1, a2 = (tuple(int(x) for x in arcs[i]) for i in (2, 9, 15))
    ticks = [[(a0[0], a0[1], 2, 7), (a1[0], a1[1], 1), (5, 5, 2, 3),
              (a2[0], a2[1], 2, 1)],
             [(a1[0], a1[1], 0, 4), (a1[0], a1[1], 2, 2),
              (a0[0], a0[1], 2, 1)]]
    g = tdir.from_arcs(n, arcs, len(arcs) + 4, device="cpu")
    gj = jdir.from_arcs(n, arcs, len(arcs) + 4)
    lab = tdir.build_directed_labelling(g, torch.from_numpy(lms),
                                        *_plans(g, kind))
    labj = jdir.build_directed_labelling(gj, jnp.asarray(lms))
    _assert_labelling(lab, labj)
    qs = rng.integers(0, n, 16).astype(np.int32)
    qt = rng.integers(0, n, 16).astype(np.int32)
    for ups in ticks:
        batch = make_batch(ups, pad_to=5, device="cpu")
        g2 = tdir.apply_batch_directed(g, batch)
        pf, pb = _plans(g2, kind)
        g, lab, aff = tdir.batchhl_update_directed(g, batch, lab, pf, pb)
        gj, labj, affj = jdir.batchhl_update_directed(
            gj, jmake_batch(ups, pad_to=5), labj)
        _assert_graph(g, gj)
        _assert_labelling(lab, labj)
        np.testing.assert_array_equal(aff.numpy(), np.asarray(affj))
        got = tdir.directed_query(g, lab, torch.from_numpy(qs),
                                  torch.from_numpy(qt), plan_fwd=pf,
                                  plan_bwd=pb).numpy()
        np.testing.assert_array_equal(got, np.asarray(jdir.directed_query(
            gj, labj, jnp.asarray(qs), jnp.asarray(qt))))
        wadj = {v: {} for v in range(n)}
        for s, d, ok, w in zip(g.src.tolist(), g.dst.tolist(),
                               g.valid.tolist(), g.w.tolist()):
            if ok:
                wadj[s][d] = min(wadj[s].get(d, w), w)
        for i, r in enumerate(lms):
            want = ref.dijkstra_dist(wadj, n, int(r))
            np.testing.assert_array_equal(
                lab.fwd.dist[i].numpy(),
                [INF_D if x == ref.INF else x for x in want])
        for k in range(16):
            want = ref.dijkstra_dist(wadj, n, int(qs[k]))[int(qt[k])]
            assert got[k] == (INF_D if want == ref.INF else want)


# --- slots and converters ------------------------------------------------------

def test_free_slot_rule_matches_reference():
    """Inserts take the free slots in order; past them they land on the
    last slot, whatever it holds (the reference's rule): here a live arc
    that an earlier batch inserted. Six arcs in eight slots, batches of
    four rows, against `repro` batch by batch."""
    arcs = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 0]],
                    np.int32)
    g = tdir.from_arcs(6, arcs, 8, device="cpu")
    gj = jdir.from_arcs(6, arcs, 8)
    apply_j = jax.jit(jdir.apply_batch_directed)
    for ups in ([(1, 0, 1), (0, 2, 0), (1, 3, 0)],   # delete, two inserts
                [(1, 0, 0), (2, 4, 0)]):             # one free, two inserts
        g = tdir.apply_batch_directed(g, make_batch(ups, pad_to=4,
                                                    device="cpu"))
        gj = apply_j(gj, jmake_batch(ups, pad_to=4))
        _assert_graph(g, gj)
    # (1, 3) sat in the last slot; the second insert past the free slots
    # overwrote it.
    assert (g.src[7].item(), g.dst[7].item()) == (2, 4)
    assert bool(g.valid.all())


def test_directed_state_round_trips_through_numpy():
    arcs, n, _ = _digraph(seed=3, n=20, extra=10)
    g = tdir.from_arcs(n, arcs, len(arcs) + 4, device="cpu")
    lab = tdir.build_directed_labelling(g, torch.tensor([0, 4],
                                                        dtype=torch.int32))
    g2 = convert.directed_graph_from_numpy(
        *convert.directed_graph_to_numpy(g), device="cpu")
    lab2 = convert.directed_labelling_from_numpy(
        *convert.directed_labelling_to_numpy(lab), device="cpu")
    for f in ("src", "dst", "valid", "w"):
        assert torch.equal(getattr(g2, f), getattr(g, f))
    assert g2.n == g.n
    for plane in ("fwd", "bwd"):
        for f in ("landmarks", "dist", "hub", "highway"):
            assert torch.equal(getattr(getattr(lab2, plane), f),
                               getattr(getattr(lab, plane), f))
    gj = jdir.from_arcs(n, arcs, len(arcs) + 4)
    _assert_graph(convert.directed_graph_from_numpy(
        gj.src, gj.dst, gj.valid, gj.w, gj.n, device="cpu"), gj)
