"""Graph500 Kronecker graphs, generated on the device.

The Graph500 specification's generator: `edge_factor`·2^scale edge
tuples, each placed bit by bit in one of the four quadrants of the
adjacency with probabilities A, B, C and D = 1 - A - B - C, then every
vertex label permuted at random. The benchmark's graph is undirected and
simple, so self-loops and repeated pairs are dropped, as the
specification's kernel 1 allows.

Config keys: `scale`, `edge_factor`, `a`, `b`, `c`.
"""
from __future__ import annotations

import torch


def generate(cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """Unique undirected edges (u, v), u < v, int64 [E, 2], sorted."""
    scale = int(cfg["scale"])
    count = int(cfg["edge_factor"]) << scale
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    dev = gen.device
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = torch.zeros((2, count), dtype=torch.int64, device=dev)
    for bit in range(scale):
        ii = torch.rand(count, generator=gen, device=dev) > ab
        jj = torch.rand(count, generator=gen, device=dev) > torch.where(
            ii, c_norm, a_norm)
        ij[0] += ii.to(torch.int64) << bit
        ij[1] += jj.to(torch.int64) << bit
    n = 1 << scale
    ij = torch.randperm(n, generator=gen, device=dev)[ij]
    u, v = torch.minimum(ij[0], ij[1]), torch.maximum(ij[0], ij[1])
    key = torch.unique((u * n + v)[u != v])
    return torch.stack([key // n, key % n], dim=1)
