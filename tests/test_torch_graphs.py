"""Graph substrate of the PyTorch port against `repro.graphs`, bit for bit.

The same seeded numpy inputs go through `repro` (JAX, CPU) and
`repro_torch` (device="cpu"); integer outputs must be equal, with no
tolerance. Covers `from_edges`, `make_batch`, `apply_batch` and
`resolve_seed_weights` on mixed insert/delete/re-weight batches — with
unmatched deletes, duplicate re-weights of one edge, free-slot reuse and
padding rows — the masked segment-min, and the generator copy.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest
import torch

from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro.graphs import segment as jseg
from repro_torch import convert as cv
from repro_torch.graphs import coo as tcoo
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import segment as tseg

CPU = "cpu"


def _port_graph(gj) -> tcoo.Graph:
    return cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                               device=CPU)


def _port_batch(bj) -> tcoo.BatchUpdate:
    return cv.batch_from_numpy(bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                               bj.is_rew, device=CPU)


def _assert_graph_equal(gt: tcoo.Graph, gj) -> None:
    for got, want in zip(cv.graph_to_numpy(gt),
                         (gj.src, gj.dst, gj.valid, gj.w, gj.n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_batch_equal(bt: tcoo.BatchUpdate, bj) -> None:
    for got, want in zip(cv.batch_to_numpy(bt),
                         (bj.src, bj.dst, bj.is_del, bj.valid, bj.w,
                          bj.is_rew)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _weighted_edges(n, extra, seed):
    rng = np.random.default_rng(seed)
    e = jgen.random_connected(n, extra_edges=extra, seed=seed)
    return np.concatenate([e, rng.integers(1, 9, (len(e), 1))], 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_from_edges_and_make_batch(weighted):
    edges = (_weighted_edges(20, 10, 1) if weighted
             else jgen.random_connected(20, extra_edges=10, seed=1))
    _assert_graph_equal(tcoo.from_edges(20, edges, 40, device=CPU),
                        jcoo.from_edges(20, edges, 40))
    ups = [(1, 2, jcoo.OP_INS, 3), (3, 4, True), (5, 6, jcoo.OP_REW, 7),
           (7, 8, False)]
    _assert_batch_equal(tcoo.make_batch(ups, pad_to=7, device=CPU),
                        jcoo.make_batch(ups, pad_to=7))
    with pytest.raises(tcoo.CapacityError):
        tcoo.from_edges(20, edges, 3, device=CPU)


def _mixed_cases():
    """(n, edges, capacity, update rows, pad_to) for `apply_batch`."""
    edges = _weighted_edges(16, 12, 3)
    e = [tuple(map(int, r)) for r in edges]
    ins = [(0, 15, jcoo.OP_INS, 5), (2, 13, jcoo.OP_INS, 2),
           (4, 11, jcoo.OP_INS, 9)]
    return [
        # Mixed ops with an unmatched delete and an unmatched re-weight.
        (16, edges, len(edges) + 8,
         [(e[0][0], e[0][1], jcoo.OP_DEL), (e[1][1], e[1][0], jcoo.OP_DEL),
          (14, 15, jcoo.OP_DEL), (e[2][0], e[2][1], jcoo.OP_REW, 6),
          (1, 14, jcoo.OP_REW, 3)] + ins, 12),
        # Two re-weights of one edge (the first row wins) and a re-weight
        # of an edge the same batch deletes (gated on post-delete validity).
        (16, edges, len(edges) + 4,
         [(e[3][0], e[3][1], jcoo.OP_REW, 7), (e[3][1], e[3][0],
                                                jcoo.OP_REW, 2),
          (e[4][0], e[4][1], jcoo.OP_DEL), (e[4][0], e[4][1], jcoo.OP_REW, 5),
          (e[5][0], e[5][1], jcoo.OP_DEL), (e[5][1], e[5][0], jcoo.OP_DEL)],
         8),
        # Deletions free slot pairs in the middle that the inserts reuse,
        # with no spare capacity left at the end.
        (16, edges, len(edges),
         [(e[6][0], e[6][1], jcoo.OP_DEL), (e[9][0], e[9][1], jcoo.OP_DEL)]
         + ins[:2], 6),
        # Only padding rows.
        (16, edges, len(edges) + 2, [], 4),
    ]


@pytest.mark.parametrize("case", range(4))
def test_apply_batch_and_seed_weights(case):
    n, edges, cap, ups, pad = _mixed_cases()[case]
    gj = jcoo.from_edges(n, edges, cap)
    bj = jcoo.make_batch(ups, pad_to=pad)
    gt, bt = _port_graph(gj), _port_batch(bj)
    _assert_graph_equal(tcoo.apply_batch(gt, bt), jcoo.apply_batch(gj, bj))
    _assert_batch_equal(tcoo.resolve_seed_weights(gt, bt),
                        jcoo.resolve_seed_weights(gj, bj))


#: Slots for the seed-weight cases: (src, dst, valid, w), n = 8. (0, 1) has
#: three live slots (weights 3, 3 and 8), (2, 3) two (4 and 9), (4, 5) a
#: live slot of weight 2 beside a dead one of weight 50, (1, 2) only a
#: dead slot; (6, 7) is one plain edge.
_SEED_SLOTS = [(0, 1, True, 3), (1, 0, True, 3), (2, 3, True, 4),
               (3, 2, True, 9), (4, 5, False, 50), (5, 4, True, 2),
               (6, 7, True, 5), (7, 6, True, 5), (0, 1, True, 8),
               (1, 2, False, 60)]
_SEED_CASES = {
    # Two rows of one key (both orientations of one pair).
    "two-rows-one-key": ([(0, 1, jcoo.OP_DEL), (1, 0, jcoo.OP_REW, 5)], 2),
    # Parallel live slots of different weights: the maximum wins.
    "parallel-slots-max": ([(2, 3, jcoo.OP_DEL), (0, 1, jcoo.OP_REW, 20),
                            (3, 2, jcoo.OP_REW, 1)], 3),
    # A dead slot of a higher weight is ignored.
    "dead-slot-ignored": ([(4, 5, jcoo.OP_DEL), (5, 4, jcoo.OP_REW, 7)], 2),
    # A non-edge (only a dead slot, or none): the weight becomes 1.
    "non-edge": ([(1, 2, jcoo.OP_DEL), (3, 6, jcoo.OP_REW, 4),
                  (2, 1, jcoo.OP_REW, 9), (1, 5, jcoo.OP_DEL)], 4),
    # Padding rows beside a delete and an insert.
    "padding-rows": ([(6, 7, jcoo.OP_DEL), (2, 6, jcoo.OP_INS, 4)], 6),
    "u-1": ([(3, 2, jcoo.OP_DEL)], 1),
    "u-0": ([], 0),
}


def _seed_graphs(directed: bool):
    src, dst, valid, w = (np.array(c, dtype) for c, dtype in zip(
        zip(*_SEED_SLOTS), (np.int32, np.int32, bool, np.int32)))
    if directed:
        from repro.core import directed as jdir
        from repro_torch.core import directed as tdir
        return (jdir.DirectedGraph(src, dst, valid, w, 8),
                tdir.DirectedGraph(*(torch.from_numpy(a)
                                     for a in (src, dst, valid, w)), 8))
    return (jcoo.Graph(src, dst, valid, w, 8),
            cv.graph_from_numpy(src, dst, valid, w, 8, device=CPU))


def _seed_batch(ups, pad):
    if pad == 0:
        z = np.zeros(0, np.int32)
        return jcoo.BatchUpdate(z, z, z.astype(bool), z.astype(bool), z,
                                z.astype(bool))
    return jcoo.make_batch(ups, pad_to=pad)


@pytest.mark.parametrize("case", list(_SEED_CASES))
def test_seed_weights_edge_cases(case):
    """`resolve_seed_weights` on slot patterns the batch generators rarely
    make, against the reference bit for bit (on the CPU the slot match is
    `kernels/seed_match`'s plain version)."""
    gj, gt = _seed_graphs(directed=False)
    bj = _seed_batch(*_SEED_CASES[case])
    _assert_batch_equal(tcoo.resolve_seed_weights(gt, _port_batch(bj)),
                        jcoo.resolve_seed_weights(gj, bj))


def test_directed_seed_weights_match_the_exact_arc():
    """The arc key: (u, v) and (v, u) are two keys, each seeded at its own
    arc's maximum live weight (3 against 9 for (2, 3) and (3, 2))."""
    from repro.core import directed as jdir
    from repro_torch.core import directed as tdir
    gj, gt = _seed_graphs(directed=True)
    bj = jcoo.make_batch([(2, 3, jcoo.OP_DEL), (3, 2, jcoo.OP_DEL),
                          (1, 0, jcoo.OP_REW, 2), (4, 5, jcoo.OP_DEL),
                          (2, 1, jcoo.OP_DEL), (0, 1, jcoo.OP_DEL)], pad_to=8)
    got = tdir.resolve_seed_weights_directed(gt, _port_batch(bj))
    _assert_batch_equal(got, jdir.resolve_seed_weights_directed(gj, bj))
    assert got.w[:6].tolist() == [4, 9, 2, 1, 1, 8]


def test_apply_batch_chain_reuses_freed_slots():
    """Three ticks of random churn applied in turn stay slot-identical."""
    n = 40
    edges = jgen.random_connected(n, extra_edges=30, seed=5)
    gj = jcoo.from_edges(n, edges, len(edges) + 6)
    gt = _port_graph(gj)
    cur = edges
    for tick in range(3):
        ups = jgen.random_batch_updates(cur, n, n_ins=5, n_del=5,
                                        seed=tick, n_rew=3, max_weight=6)
        bj = jcoo.make_batch(ups, pad_to=16)
        gj = jcoo.apply_batch(gj, bj)
        gt = tcoo.apply_batch(gt, _port_batch(bj))
        _assert_graph_equal(gt, gj)
        valid = np.asarray(gj.valid)[0::2]
        cur = np.stack([np.asarray(gj.src)[0::2][valid],
                        np.asarray(gj.dst)[0::2][valid]], 1)
    assert tcoo.to_numpy_adj(gt) == jcoo.to_numpy_adj(gj)
    assert tcoo.to_numpy_wadj(gt) == jcoo.to_numpy_wadj(gj)


@pytest.mark.parametrize("planes", [None, 3])
def test_masked_segment_min(planes):
    rng = np.random.default_rng(2)
    e, n, fill = 50, 12, 1000
    shape = (e,) if planes is None else (planes, e)
    data = rng.integers(0, 2000, shape).astype(np.int32)
    seg = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(shape) < 0.6
    got = tseg.masked_segment_min(torch.from_numpy(data),
                                  torch.from_numpy(seg), n,
                                  torch.from_numpy(mask), fill)
    one = lambda d, m: jseg.masked_segment_min(d, seg, n, m, fill)  # noqa
    want = (one(data, mask) if planes is None
            else np.stack([one(d, m) for d, m in zip(data, mask)]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7])
def test_generator_copy_matches_reference(seed):
    e_t = tgen.barabasi_albert(300, 3, seed)
    np.testing.assert_array_equal(e_t, jgen.barabasi_albert(300, 3, seed))
    for kw in (dict(n_ins=6, n_del=6), dict(n_ins=4, n_del=2, n_rew=3,
                                             max_weight=5)):
        assert (tgen.random_batch_updates(e_t, 300, seed=seed, **kw)
                == jgen.random_batch_updates(e_t, 300, seed=seed, **kw))


@pytest.mark.parametrize("seed", [0, 7])
def test_serving_generators_match_reference(seed):
    """The generators the scenarios and the serve loop draw from."""
    for t, j in ((tgen.random_connected(60, 40, seed),
                  jgen.random_connected(60, 40, seed)),
                 (tgen.erdos_renyi(40, 0.1, seed),
                  jgen.erdos_renyi(40, 0.1, seed)),
                 (tgen.grid_mesh(5, 7), jgen.grid_mesh(5, 7)),
                 (tgen.road_grid(50, 6, seed), jgen.road_grid(50, 6, seed)),
                 (tgen.zipf_vertices(np.random.default_rng(seed), 90, 64),
                  jgen.zipf_vertices(np.random.default_rng(seed), 90, 64))):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chip_smoke_bfs_oracle_matches_scipy(directed, seed):
    """chip_smoke's multi-source BFS (its oracle for phases 4 and 6) gives
    `scipy.sparse.csgraph.shortest_path(unweighted=True)`'s hop distances,
    with unreachable vertices and repeated sources."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)
    n, reach = 80, 60   # vertices reach.. have no arcs at all
    m = 150
    src = rng.integers(0, reach, m)
    dst = rng.integers(0, reach, m)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    csr = sp.csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                        shape=(n, n))
    sources = np.concatenate([rng.integers(0, n, 12), [3, 3, n - 1]])
    inf_d = 1 << 20
    got = cs.bfs_dist(csr, sources, np, inf_d)
    want = shortest_path(csr, directed=True, unweighted=True,
                         indices=sources)
    want = np.where(np.isinf(want), inf_d, want).astype(np.int64)
    assert got.shape == (len(sources), n)
    np.testing.assert_array_equal(got, want)
    assert (got == inf_d).any() and (got[:, reach:] == inf_d).sum() > 0
