"""Pure-Python oracle for BatchHL invariants (host-side, test-only).

The port's own copy of `repro.core.ref`, so that the port imports nothing
of the JAX package. Implements from first principles (plain BFS /
Dijkstra / DP):
  * exact distances — BFS for the hop-count metric, binary-heap Dijkstra
    for the weighted metric (adjacency `{u: {v: w}}`, weights >= 1),
  * landmark lengths d^L(r, v) = (distance, hub flag) with the paper's
    True < False ordering (flag True iff ANY shortest r->v path passes
    through a landmark other than r; endpoints count, r excluded) — the
    weighted predecessor test is dist[u] + w(u, v) == dist[v],
  * the unique minimal highway-cover labelling,
  * affected / LD-affected sets (Definitions 5.1 and 5.12).
"""
from __future__ import annotations

import heapq
from collections import deque

INF = float("inf")


def bfs_dist(adj: dict[int, set[int]], n: int, src: int) -> list[float]:
    dist = [INF] * n
    dist[src] = 0
    q = deque([src])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if dist[w] == INF:
                dist[w] = dist[u] + 1
                q.append(w)
    return dist


def landmark_length(adj: dict[int, set[int]], n: int, landmarks: list[int],
                    r: int) -> tuple[list[float], list[bool]]:
    """d^L(r, ·): (distance, hub flag) per vertex."""
    others = set(landmarks) - {r}
    dist = bfs_dist(adj, n, r)
    order = sorted((v for v in range(n) if dist[v] < INF),
                   key=lambda v: dist[v])
    hub = [False] * n
    for v in order:
        if v == r:
            continue
        if v in others:
            hub[v] = True
            continue
        hub[v] = any(hub[u] for u in adj[v]
                     if dist[u] == dist[v] - 1)
    return dist, hub


def minimal_labelling(adj: dict[int, set[int]], n: int,
                      landmarks: list[int]):
    """Returns (dist[R][V], hub[R][V], highway[R][R], label_mask[R][V])."""
    r_count = len(landmarks)
    dist, hub, mask = [], [], []
    for r in landmarks:
        d, h = landmark_length(adj, n, landmarks, r)
        dist.append(d)
        hub.append(h)
        mask.append([d[v] < INF and not h[v] and v not in landmarks
                     for v in range(n)])
    highway = [[dist[i][landmarks[j]] for j in range(r_count)]
               for i in range(r_count)]
    return dist, hub, highway, mask


def affected_set(adj_old, adj_new, n: int, r: int) -> set[int]:
    """Definition 5.1: P_G(r,v) != P_G'(r,v). We compare the shortest-path
    DAGs (distance + predecessor sets at shortest level), which determine
    the shortest-path sets exactly."""
    d0 = bfs_dist(adj_old, n, r)
    d1 = bfs_dist(adj_new, n, r)
    aff = set()
    # Process by level so predecessors are classified before dependents.
    for v in sorted(range(n), key=lambda x: min(d0[x], d1[x])):
        if v == r:
            continue
        if d0[v] != d1[v]:
            aff.add(v)
            continue
        if d0[v] == INF:
            continue
        pred0 = {u for u in adj_old[v] if d0[u] == d0[v] - 1}
        pred1 = {u for u in adj_new[v] if d1[u] == d1[v] - 1}
        if pred0 != pred1 or any(u in aff for u in pred0 | pred1):
            aff.add(v)
    return aff


def ld_affected_set(adj_old, adj_new, n: int, landmarks: list[int],
                    r: int) -> set[int]:
    """Definition 5.12 via Lemma 5.15: d^L_G(r,v) != d^L_G'(r,v)."""
    d0, h0 = landmark_length(adj_old, n, landmarks, r)
    d1, h1 = landmark_length(adj_new, n, landmarks, r)
    out = set()
    for v in range(n):
        if d0[v] != d1[v]:
            out.add(v)
        elif d0[v] < INF and h0[v] != h1[v]:
            out.add(v)
    return out


def apply_updates(adj: dict[int, set[int]], updates) -> dict[int, set[int]]:
    """updates: list of (u, v, is_del). Returns a new adjacency dict."""
    new = {v: set(s) for v, s in adj.items()}
    for u, v, is_del in updates:
        if is_del:
            new[u].discard(v)
            new[v].discard(u)
        else:
            new[u].add(v)
            new[v].add(u)
    return new


def pair_distance(adj, n: int, s: int, t: int) -> float:
    return bfs_dist(adj, n, s)[t]


# --- weighted oracle (Dijkstra; adjacency {u: {v: w}}, weights >= 1) --------

def dijkstra_dist(wadj: dict[int, dict[int, int]], n: int,
                  src: int) -> list[float]:
    """Single-source shortest paths under positive integer edge weights."""
    dist = [INF] * n
    dist[src] = 0
    heap = [(0, src)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, w in wadj.get(u, {}).items():
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def unit_wadj(adj: dict[int, set[int]]) -> dict[int, dict[int, int]]:
    """Lift an unweighted adjacency to the weighted form with w ≡ 1."""
    return {u: {v: 1 for v in s} for u, s in adj.items()}


def landmark_length_w(wadj: dict[int, dict[int, int]], n: int,
                      landmarks: list[int],
                      r: int) -> tuple[list[float], list[bool]]:
    """Weighted d^L(r, ·): (distance, hub flag) per vertex. The hub DP
    visits vertices in distance order; u precedes v on a shortest path
    iff dist[u] + w(u, v) == dist[v]."""
    others = set(landmarks) - {r}
    dist = dijkstra_dist(wadj, n, r)
    order = sorted((v for v in range(n) if dist[v] < INF),
                   key=lambda v: dist[v])
    hub = [False] * n
    for v in order:
        if v == r:
            continue
        if v in others:
            hub[v] = True
            continue
        hub[v] = any(hub[u] for u, w in wadj.get(v, {}).items()
                     if dist[u] + w == dist[v])
    return dist, hub


def minimal_labelling_w(wadj: dict[int, dict[int, int]], n: int,
                        landmarks: list[int]):
    """Weighted (dist[R][V], hub[R][V], highway[R][R], label_mask[R][V])."""
    r_count = len(landmarks)
    dist, hub, mask = [], [], []
    for r in landmarks:
        d, h = landmark_length_w(wadj, n, landmarks, r)
        dist.append(d)
        hub.append(h)
        mask.append([d[v] < INF and not h[v] and v not in landmarks
                     for v in range(n)])
    highway = [[dist[i][landmarks[j]] for j in range(r_count)]
               for i in range(r_count)]
    return dist, hub, highway, mask


def apply_updates_w(wadj: dict[int, dict[int, int]],
                    updates) -> dict[int, dict[int, int]]:
    """updates: (u, v, op[, w]) with op 0=insert, 1=delete, 2=reweight
    (insert and reweight default to w=1). Returns a new weighted
    adjacency; reweighting an absent edge inserts it, matching
    `coo.apply_batch`'s slot semantics only for edges that exist — tests
    only reweight live edges, so keep the simple set-the-weight rule."""
    new = {v: dict(d) for v, d in wadj.items()}
    for up in updates:
        u, v, op = up[0], up[1], int(up[2])
        w = int(up[3]) if len(up) > 3 else 1
        if op == 1:
            new[u].pop(v, None)
            new[v].pop(u, None)
        else:
            new[u][v] = w
            new[v][u] = w
    return new


def pair_distance_w(wadj, n: int, s: int, t: int) -> float:
    return dijkstra_dist(wadj, n, s)[t]


# --- directed-graph oracle (paper §6) ---------------------------------------

def bfs_dist_directed(adj_out: dict[int, set[int]], n: int,
                      src: int) -> list[float]:
    dist = [INF] * n
    dist[src] = 0
    q = deque([src])
    while q:
        u = q.popleft()
        for w in adj_out[u]:
            if dist[w] == INF:
                dist[w] = dist[u] + 1
                q.append(w)
    return dist


def reverse_adj(adj_out: dict[int, set[int]], n: int) -> dict[int, set[int]]:
    rev: dict[int, set[int]] = {v: set() for v in range(n)}
    for u, outs in adj_out.items():
        for v in outs:
            rev[v].add(u)
    return rev


def landmark_length_directed(adj_out, n, landmarks, r):
    """d^L(r → ·) along arcs: (distance, hub flag) per vertex."""
    others = set(landmarks) - {r}
    dist = bfs_dist_directed(adj_out, n, r)
    rev = reverse_adj(adj_out, n)
    order = sorted((v for v in range(n) if dist[v] < INF),
                   key=lambda v: dist[v])
    hub = [False] * n
    for v in order:
        if v == r:
            continue
        if v in others:
            hub[v] = True
            continue
        hub[v] = any(hub[u] for u in rev[v] if dist[u] == dist[v] - 1)
    return dist, hub


def minimal_labelling_directed(adj_out, n, landmarks):
    """(dist, hub, highway, mask) for one directed plane."""
    r_count = len(landmarks)
    dist, hub, mask = [], [], []
    for r in landmarks:
        d, h = landmark_length_directed(adj_out, n, landmarks, r)
        dist.append(d)
        hub.append(h)
        mask.append([d[v] < INF and not h[v] and v not in landmarks
                     for v in range(n)])
    highway = [[dist[i][landmarks[j]] for j in range(r_count)]
               for i in range(r_count)]
    return dist, hub, highway, mask


def apply_updates_directed(adj_out, updates):
    new = {v: set(s) for v, s in adj_out.items()}
    for u, v, is_del in updates:
        if is_del:
            new[u].discard(v)
        else:
            new[u].add(v)
    return new
