"""The plain reference against scipy and against the definitions, on
small graphs; and beside it, the program's own construction on the CPU
as a second witness."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

from perfbench import reference as ref


def random_graph(n: int, m: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, (2, m))
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = np.unique((lo * n + hi)[lo != hi])
    return torch.from_numpy(np.stack([key // n, key % n], 1))


def scipy_dist(edges: torch.Tensor, n: int, sources) -> np.ndarray:
    e = edges.numpy()
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    d = csg.shortest_path(a, directed=False, unweighted=True,
                          indices=np.asarray(sources))
    return np.where(np.isinf(d), ref.INF, d).astype(np.int64)


GRAPHS = [(60, 70, 0), (60, 200, 1), (200, 260, 2), (300, 1500, 3)]


@pytest.mark.parametrize("n,m,seed", GRAPHS)
def test_bfs_equals_scipy(n, m, seed):
    edges = random_graph(n, m, seed)
    sources = torch.tensor([0, 5, n - 1, 7])
    dist, _ = ref.bfs(ref.adjacency(edges, n), sources)
    assert np.array_equal(dist.numpy(), scipy_dist(edges, n, sources))


@pytest.mark.parametrize("n,m,seed", GRAPHS)
def test_pair_distances_equal_scipy(n, m, seed):
    edges = random_graph(n, m, seed)
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(0, n, 50))
    t = torch.from_numpy(rng.integers(0, n, 50))
    got = ref.pair_distances(ref.adjacency(edges, n), s, t, block=16)
    full = scipy_dist(edges, n, np.arange(n))
    assert np.array_equal(got.numpy(), full[s.numpy(), t.numpy()])


def hub_by_definition(edges, n, landmarks) -> np.ndarray:
    """hub[r, v]: some shortest r-v path meets a landmark other than r
    (v itself counts), by enumerating predecessors layer by layer."""
    d = scipy_dist(edges, n, landmarks)
    adj = [[] for _ in range(n)]
    for a, b in edges.tolist():
        adj[a].append(b)
        adj[b].append(a)
    lm = set(landmarks)
    out = np.zeros((len(landmarks), n), bool)
    for i, r in enumerate(landmarks):
        order = sorted((v for v in range(n) if d[i, v] < ref.INF),
                       key=lambda v: d[i, v])
        for v in order:
            if v == r:
                continue
            out[i, v] = (v in lm) or any(
                out[i, u] for u in adj[v] if d[i, u] == d[i, v] - 1)
    return out


@pytest.mark.parametrize("n,m,seed", GRAPHS)
def test_labelling_follows_the_definitions(n, m, seed):
    edges = random_graph(n, m, seed)
    lms = ref.top_degree(edges, n, 5)
    dist, hub, highway = ref.labelling(edges, n, lms)
    assert np.array_equal(dist.numpy(), scipy_dist(edges, n, lms.numpy()))
    assert np.array_equal(hub.numpy(),
                          hub_by_definition(edges, n, lms.tolist()))
    assert np.array_equal(highway.numpy(), dist[:, lms].numpy())


@pytest.mark.parametrize("n,m,seed", GRAPHS[1:])
def test_labelling_equals_the_programs_construction(n, m, seed):
    """A second witness: the program's COO construction on the CPU."""
    from repro_torch.core.construct import (build_labelling,
                                            select_landmarks_by_degree)
    from repro_torch.graphs.coo import from_edges
    edges = random_graph(n, m, seed)
    g = from_edges(n, edges.numpy().astype(np.int32), m + 8, device="cpu")
    lab = build_labelling(g, select_landmarks_by_degree(g, 6))
    lms = ref.top_degree(edges, n, 6)
    dist, hub, highway = ref.labelling(edges, n, lms)
    assert torch.equal(lab.landmarks.to(torch.int64), lms)
    assert torch.equal(lab.dist, dist) and torch.equal(lab.hub, hub)
    assert torch.equal(lab.highway, highway)


def test_components_equal_scipy():
    edges = random_graph(400, 300, 4)
    label = ref.components(edges, 400)
    e = edges.numpy()
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(400, 400))
    count, theirs = csg.connected_components(a, directed=False)
    assert torch.unique(label).shape[0] == count
    for x, y in itertools.combinations(range(0, 400, 7), 2):
        assert (label[x] == label[y]) == (theirs[x] == theirs[y])
    big = ref.largest_component(edges, 400)
    assert big.shape[0] == np.bincount(theirs).max()


def test_top_degree_breaks_ties_to_the_lower_id():
    edges = torch.tensor([[0, 5], [1, 5], [2, 6], [3, 6], [4, 7], [1, 7]])
    assert ref.top_degree(edges, 8, 4).tolist() == [1, 5, 6, 7]


def test_multiset_difference_counts_unpaired_entries():
    a = torch.tensor([1, 2, 2, 5])
    assert ref.multiset_difference(a, a.clone()) == 0
    assert ref.multiset_difference(a, torch.tensor([1, 2, 5])) == 1
    assert ref.multiset_difference(a, torch.tensor([1, 2, 2, 6])) == 2
    assert ref.arc_keys(torch.tensor([[0, 1], [1, 2]]), 3).tolist() == \
        [1, 3, 5, 7]
