"""The graph families and the traffic generator: each repeats with its
seed and gives the stated shapes, at a small scale."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness, traffic


def family(name):
    return harness.load_module(harness.HERE / "graphs" / f"{name}.py")


def edges_ok(e: torch.Tensor, n: int) -> None:
    assert e.dtype == torch.int64 and e.shape[1] == 2
    assert bool((e[:, 0] < e[:, 1]).all()) and int(e.max()) < n
    key = e[:, 0] * n + e[:, 1]
    assert torch.unique(key).shape[0] == key.shape[0]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 1, -3])
def test_ba_repeats_per_seed_and_has_the_stated_shape(seed):
    cfg = {"n": 3000, "m": 4}
    gen = family("ba").generate
    a = gen(cfg, traffic.generator(seed, "graph", "cpu"))
    b = gen(cfg, traffic.generator(seed, "graph", "cpu"))
    c = gen(cfg, traffic.generator(seed + 1, "graph", "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    edges_ok(a, cfg["n"])
    # (n - m)·m picks, less the few that repeat within a vertex.
    assert 0.97 * (3000 - 4) * 4 <= a.shape[0] <= (3000 - 4) * 4
    # Every vertex past the first m joins the graph; preferential
    # attachment gives hubs far above the mean degree.
    deg = torch.bincount(a.reshape(-1), minlength=3000)
    assert bool((deg[4:] >= 1).all()) and int(deg.max()) > 10 * 8


def test_ba_edge_count_matches_the_programs_generator():
    from repro_torch.graphs.generators import barabasi_albert
    ours = family("ba").generate({"n": 20000, "m": 4},
                                 traffic.generator(1, "graph", "cpu"))
    theirs = barabasi_albert(20000, 4, seed=1)
    assert abs(ours.shape[0] - theirs.shape[0]) < 0.005 * theirs.shape[0]


@pytest.mark.parametrize("seed", [0, 2**33 + 7])
def test_kronecker_repeats_per_seed_and_has_the_stated_shape(seed):
    cfg = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
    gen = family("kronecker").generate
    a = gen(cfg, traffic.generator(seed, "graph", "cpu"))
    b = gen(cfg, traffic.generator(seed, "graph", "cpu"))
    assert torch.equal(a, b)
    edges_ok(a, 1024)
    assert a.shape[0] <= 16 * 1024
    # Skew: many vertices are isolated and a few carry many edges.
    deg = torch.bincount(a.reshape(-1), minlength=1024)
    assert int((deg == 0).sum()) > 50 and int(deg.max()) > 100


def test_relabel_names_the_same_graph_anew_per_seed():
    edges = family("ba").generate({"n": 800, "m": 3},
                                  traffic.generator(0, "graph", "cpu"))
    a = traffic.relabel(edges, 800, traffic.generator(4, "labels", "cpu"))
    b = traffic.relabel(edges, 800, traffic.generator(4, "labels", "cpu"))
    c = traffic.relabel(edges, 800, traffic.generator(5, "labels", "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    edges_ok(a, 800)
    for e in (a, c):
        deg = torch.bincount(e.reshape(-1), minlength=800)
        want = torch.bincount(edges.reshape(-1), minlength=800)
        assert torch.equal(torch.sort(deg).values, torch.sort(want).values)


def test_query_stream_repeats_and_stays_in_the_component():
    comp = torch.arange(100, 400)
    mix = {"microbatch": 8, "pool": 64}
    a = traffic.query_stream(mix, 7, comp)
    b = traffic.query_stream(mix, 7, comp)
    assert np.array_equal(a.qs, b.qs) and np.array_equal(a.qt, b.qt)
    assert a.qs.min() >= 100 and a.qt.max() < 400
    s, t = a.batch(9)          # round the pool again
    assert np.array_equal(s, a.qs[8:16]) and len(t) == 8
    ps, _ = a.take(np.arange(72))
    assert np.array_equal(ps[64:], a.qs[:8])
    with pytest.raises(ValueError):
        traffic.query_stream({"microbatch": 8, "pool": 60}, 7, comp)


def test_update_stream_repeats_and_applies():
    edges = family("ba").generate({"n": 500, "m": 3},
                                  traffic.generator(5, "graph", "cpu"))
    mix = {"deletes": 10, "inserts": 6, "insert_pool": 600}
    a = traffic.update_stream(mix, 9, edges, 500, deletion_seed=2)
    b = traffic.update_stream(mix, 9, edges, 500, deletion_seed=2)
    assert a.rows(3) == b.rows(3) and len(a.rows(0)) == 16
    assert a.batches() == 100
    keys = set((edges[:, 0] * 500 + edges[:, 1]).tolist())
    ins = a.inserts[:, 0] * 500 + a.inserts[:, 1]
    assert len(set(ins.tolist())) == len(ins) and not keys & set(ins)
    after = a.edges_after(edges, 500, 4)
    assert after.shape[0] == edges.shape[0] - 40 + 24
    with pytest.raises(IndexError):
        a.rows(100)


def test_streams_of_a_seed_are_independent():
    x = torch.rand(4, generator=traffic.generator(1, "graph", "cpu"))
    y = torch.rand(4, generator=traffic.generator(1, "queries", "cpu"))
    z = torch.rand(4, generator=traffic.generator(1, "graph", "cpu"))
    assert torch.equal(x, z) and not torch.equal(x, y)


def test_every_seed_deletes_the_same_edges_of_the_graph_in_its_names():
    """The deletion stream is the configuration's: a run's seed renames
    the edges it deletes and leaves the work as it is."""
    n = 600
    edges = family("ba").generate({"n": n, "m": 3},
                                  traffic.generator(0, "graph", "cpu"))
    mix = {"deletes": 10, "inserts": 0}
    deleted, named = [], []
    for seed in (4, 5):
        perm = torch.randperm(n, generator=traffic.generator(seed, "labels",
                                                             "cpu"))
        order = traffic.relabel(edges, n, traffic.generator(
            seed, "labels", "cpu"), keep_order=True)
        both = traffic.relabel(edges, n, traffic.generator(seed, "labels",
                                                           "cpu"))
        assert torch.equal(torch.sort(order[:, 0] * n + order[:, 1]).values,
                           both[:, 0] * n + both[:, 1])   # one graph
        s = traffic.update_stream(mix, seed, order, n, deletion_seed=0)
        named.append(torch.as_tensor(s.deletes))
        back = torch.argsort(perm)[torch.as_tensor(s.deletes)]
        deleted.append(torch.sort(back, dim=1).values)
    assert torch.equal(deleted[0], deleted[1])
    assert not torch.equal(named[0], named[1])
