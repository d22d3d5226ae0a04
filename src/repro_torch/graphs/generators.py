"""Synthetic graph generators (host-side numpy), copied from `repro`.

The port keeps its own copy so that it never imports the JAX package; the
rng streams are the same, so a seed gives both packages the same graph and
the same update batches (`tests/test_torch_graphs.py` pins it).
"""
from __future__ import annotations

import math

import numpy as np


def barabasi_albert(n: int, m: int, seed: int = 0) -> np.ndarray:
    """BA preferential attachment; returns unique undirected edges [E, 2]."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = []
    edges = []
    for v in range(m, n):
        for t in set(targets):
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = [int(repeated[rng.integers(len(repeated))])
                   for _ in range(m)]
    return _dedupe(np.asarray(edges, np.int32))


def erdos_renyi(n: int, p: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows, cols = np.triu_indices(n, k=1)
    keep = rng.random(rows.shape[0]) < p
    return np.stack([rows[keep], cols[keep]], axis=1).astype(np.int32)


def random_connected(n: int, extra_edges: int, seed: int = 0) -> np.ndarray:
    """Random tree + extra random edges — always connected."""
    rng = np.random.default_rng(seed)
    edges = [(v, int(rng.integers(v))) for v in range(1, n)]
    for _ in range(extra_edges):
        u, v = rng.integers(n), rng.integers(n)
        if u != v:
            edges.append((int(u), int(v)))
    return _dedupe(np.asarray(edges, np.int32))


def grid_mesh(rows: int, cols: int) -> np.ndarray:
    """4-connected grid."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1))
    return np.concatenate(e).astype(np.int32)


def road_grid(n: int, max_weight: int = 8, seed: int = 0) -> np.ndarray:
    """Road-like weighted planar graph: a 4-connected grid of ~n vertices
    with uniform integer weights in [1, max_weight] per edge (large
    diameter, bounded degree). Returns edges [E, 3] = (u, v, w); the
    vertex count is rows·cols = `edges[:, :2].max() + 1`."""
    rows = max(2, int(math.isqrt(n)))
    cols = max(2, (n + rows - 1) // rows)
    e = grid_mesh(rows, cols)
    rng = np.random.default_rng(seed)
    w = rng.integers(1, max_weight + 1, size=e.shape[0])
    return np.concatenate([e, w[:, None]], axis=1).astype(np.int32)


def molecule_batch(n_mols: int, atoms_per_mol: int, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Batched random molecules: positions [N,3] + radius-graph edges."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_mols * atoms_per_mol, 3)).astype(np.float32)
    edges = []
    for m in range(n_mols):
        base = m * atoms_per_mol
        p = pos[base:base + atoms_per_mol]
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        src, dst = np.nonzero((d < 1.8) & (d > 0))
        keep = src < dst
        edges.append(np.stack([src[keep] + base, dst[keep] + base], axis=1))
    return pos, np.concatenate(edges).astype(np.int32)


def random_batch_updates(edges: np.ndarray, n: int, n_ins: int, n_del: int,
                         seed: int = 0, existing=None, n_rew: int = 0,
                         max_weight: int = 1) -> list[tuple]:
    """Valid updates: deletions sampled from existing edges, insertions are
    fresh non-edges (paper §3: invalid updates are ignored), reweights
    (`n_rew` > 0) re-draw the weight of existing edges not already chosen
    for deletion. With `max_weight` > 1 inserts/reweights carry a uniform
    weight in [1, max_weight] as 4-tuples (u, v, op, w); the default
    (n_rew=0, max_weight=1) emits the legacy (u, v, is_del) 3-tuples from
    a bit-identical rng sequence.

    `existing` optionally passes a prebuilt membership set/dict of
    canonical (min, max) edge keys, sparing the O(E) rebuild per call for
    callers that maintain one incrementally (launch/serve.py).
    """
    rng = np.random.default_rng(seed)
    pairs = edges[:, :2] if getattr(edges, "ndim", 0) == 2 \
        and edges.shape[0] and edges.shape[1] > 2 else edges
    if existing is None:
        existing = {(min(u, v), max(u, v)) for u, v in pairs}
    out: list[tuple] = []
    if n_del:
        sel = rng.choice(len(edges), size=min(n_del, len(edges)),
                         replace=False)
        chosen = set()
        for i in sel:
            u, v = int(edges[i, 0]), int(edges[i, 1])
            out.append((u, v, True))
            chosen.add((min(u, v), max(u, v)))
    else:
        chosen = set()
    tries = 0
    while sum(1 for e in out if not e[2]) < n_ins and tries < 100 * n_ins + 100:
        tries += 1
        u, v = int(rng.integers(n)), int(rng.integers(n))
        key = (min(u, v), max(u, v))
        if u == v or key in existing or key in chosen:
            continue
        chosen.add(key)
        if max_weight > 1:
            out.append((u, v, 0, int(rng.integers(1, max_weight + 1))))
        else:
            out.append((u, v, False))
    if n_rew and len(edges):
        sel = rng.choice(len(edges), size=min(n_rew, len(edges)),
                         replace=False)
        for i in sel:
            u, v = int(edges[i, 0]), int(edges[i, 1])
            key = (min(u, v), max(u, v))
            if key in chosen:
                continue
            chosen.add(key)
            out.append((u, v, 2, int(rng.integers(1, max(2, max_weight + 1)))))
    rng.shuffle(out)
    return out


def zipf_vertices(rng: np.random.Generator, n: int, size: int,
                  a: float = 1.2) -> np.ndarray:
    """Bounded-Zipf(a) vertex ids over [0, n): P(id = k) ∝ (k + 1)^-a.

    Low ids are the oldest, highest-degree vertices of the BA generator,
    so skewed query traffic concentrates on the hubs. The law is
    normalised over [0, n), not sampled unbounded and clipped (which
    would pile the tail mass onto vertex n-1).
    """
    if a <= 1.0:
        raise ValueError(f"zipf exponent must be > 1, got {a}")
    w = np.arange(1, n + 1, dtype=np.float64) ** -a
    return rng.choice(n, size=size, p=w / w.sum()).astype(np.int32)


def _dedupe(edges: np.ndarray) -> np.ndarray:
    if edges.size == 0:
        return edges.reshape(0, 2)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    keep = lo != hi
    uniq = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    return uniq.astype(np.int32)
