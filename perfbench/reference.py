"""The plain reference of the benchmark: breadth-first search in PyTorch.

BatchHL's guarantee is exact hop distances on an unweighted undirected
graph: a query answers d_G(s, t), and after every batch the labelling
holds, for each landmark r and vertex v, d_G(r, v) and whether some
shortest r-v path passes through a landmark other than r (a "hub";
endpoints count). This module works all of that out again from the edge
list alone, with level-synchronous BFS: each level is one sparse-dense
product of the adjacency with the frontier columns. It imports torch
only, nothing of the program, and runs on whatever device its tensors
are on.

Edges are int64 [E, 2] tensors of undirected pairs (u, v), u != v, each
pair once. Unreached vertices read `INF`, the value the program's
contract gives an unreachable distance.
"""
from __future__ import annotations

import warnings

import torch

#: The distance of an unreached vertex.
INF = 1 << 28


def adjacency(edges: torch.Tensor, n: int) -> torch.Tensor:
    """The symmetric adjacency of `edges` as a float32 CSR [n, n] matrix,
    row v holding v's neighbours."""
    u, v = edges[:, 0], edges[:, 1]
    rows = torch.cat([u, v])
    cols = torch.cat([v, u])
    order = torch.argsort(rows * n + cols)
    rows, cols = rows[order], cols[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=edges.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    vals = torch.ones(cols.shape[0], dtype=torch.float32,
                      device=edges.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR is in beta"
        return torch.sparse_csr_tensor(crow, cols, vals, (n, n))


def bfs(adj: torch.Tensor, sources: torch.Tensor,
        marked: torch.Tensor | None = None,
        targets: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Hop distances from each of `sources` [P], as int32 [P, n].

    With `marked` (bool [n], the landmarks) it also returns the hub flags
    [P, n]: v is a hub of source p when v is marked and is not p's
    source, or when some neighbour one level nearer to the source is a
    hub of p. With `targets` [P] it stops once every source has reached
    its target (the other columns are then partial).
    """
    n = adj.shape[0]
    p = sources.shape[0]
    dev = sources.device
    cols = torch.arange(p, device=dev)
    dist = torch.full((n, p), INF, dtype=torch.int32, device=dev)
    dist[sources, cols] = 0
    front = torch.zeros((n, p), dtype=torch.float32, device=dev)
    front[sources, cols] = 1.0
    hub = None
    if marked is not None:
        other = marked[:, None].expand(n, p).clone()
        other[sources, cols] = False
        hub = torch.zeros((n, p), dtype=torch.bool, device=dev)
    level = 0
    while bool(front.any()):
        if targets is not None and bool((dist[targets, cols] < INF).all()):
            break
        level += 1
        if hub is None:
            reach = adj @ front
            new = (reach > 0) & (dist == INF)
        else:
            both = adj @ torch.cat([front, front * hub], dim=1)
            new = (both[:, :p] > 0) & (dist == INF)
            hub |= new & ((both[:, p:] > 0) | other)
        dist[new] = level
        front = new.to(torch.float32)
    return dist.T.contiguous(), None if hub is None else hub.T.contiguous()


def pair_distances(adj: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                   block: int = 256) -> torch.Tensor:
    """d(s[i], t[i]) for each pair, int64 [len(s)]: BFS from `block`
    sources at a time, each stopping once its targets are reached."""
    out = torch.empty(s.shape[0], dtype=torch.int64, device=s.device)
    for lo in range(0, s.shape[0], block):
        ss, tt = s[lo:lo + block], t[lo:lo + block]
        dist, _ = bfs(adj, ss, targets=tt)
        out[lo:lo + block] = dist[torch.arange(ss.shape[0],
                                               device=s.device), tt]
    return out


def top_degree(edges: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The k highest-degree vertices, ties to the lower id (the paper's
    landmark policy), int64 [k]."""
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    # Descending degree, then ascending id: one key, sorted once.
    key = -deg * n + torch.arange(n, device=edges.device)
    return torch.argsort(key)[:k]


def labelling(edges: torch.Tensor, n: int, landmarks: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The highway-cover labelling of the graph: (dist int32 [R, n], hub
    bool [R, n], highway int32 [R, R] with highway[i, j] = dist[i,
    landmarks[j]])."""
    marked = torch.zeros(n, dtype=torch.bool, device=edges.device)
    marked[landmarks] = True
    dist, hub = bfs(adjacency(edges, n), landmarks, marked=marked)
    hub &= dist < INF
    return dist, hub, dist[:, landmarks].contiguous()


def components(edges: torch.Tensor, n: int) -> torch.Tensor:
    """The connected component of each vertex, named by its least vertex,
    int64 [n]: hooking and pointer jumping until nothing moves."""
    label = torch.arange(n, device=edges.device)
    u, v = edges[:, 0], edges[:, 1]
    while True:
        lu, lv = label[u], label[v]
        nxt = label.clone()
        nxt.scatter_reduce_(0, torch.maximum(lu, lv), torch.minimum(lu, lv),
                            "amin")
        while True:
            jumped = nxt[nxt]
            if torch.equal(jumped, nxt):
                break
            nxt = jumped
        if torch.equal(nxt, label):
            return label
        label = nxt


def largest_component(edges: torch.Tensor, n: int) -> torch.Tensor:
    """The vertices of the largest connected component, int64, ascending
    (the lowest-named one where two tie)."""
    label = components(edges, n)
    root = torch.argmax(torch.bincount(label, minlength=n))
    return torch.nonzero(label == root).reshape(-1)


def arc_keys(edges: torch.Tensor, n: int) -> torch.Tensor:
    """Both directions of each edge as sorted int64 keys src·n + dst."""
    u, v = edges[:, 0], edges[:, 1]
    return torch.sort(torch.cat([u * n + v, v * n + u])).values


def multiset_difference(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many entries of the two sorted key lists do not pair off one
    to one: 0 exactly when they hold the same keys, each as often."""
    if a.shape == b.shape and torch.equal(a, b):
        return 0
    ua, ca = torch.unique(a, return_counts=True)
    ub, cb = torch.unique(b, return_counts=True)
    keys = torch.cat([ua, ub])
    counts = torch.cat([ca, -cb])
    uk, inv = torch.unique(keys, return_inverse=True)
    net = torch.zeros(uk.shape[0], dtype=counts.dtype, device=a.device)
    net.index_add_(0, inv, counts)
    return int(net.abs().sum())
