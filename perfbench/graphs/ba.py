"""Barabási–Albert graphs, generated on the device.

Each vertex v >= m brings m edges; vertex m joins 0..m-1, and every later
edge of v picks its other end uniformly among the endpoint entries of all
edges before v (preferential attachment: a vertex is picked in proportion
to its degree). Picks that repeat within a vertex collapse to one edge.
This is the distribution of the repo's `barabasi_albert` (it picks from
the same multiset, in another order), generated as Batagelj and Brandes
do: edge e's entries sit at positions 2e (its new vertex) and 2e + 1 (its
pick), a pick is a uniform position below 2·(first edge of v), and a pick
that lands on another pick copies it, resolved for all edges at once by
pointer jumping.

Config keys: `n` (vertices), `m` (edges each new vertex brings).
"""
from __future__ import annotations

import torch


def generate(cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """Unique undirected edges (u, v), u < v, int64 [E, 2], sorted."""
    n, m = int(cfg["n"]), int(cfg["m"])
    dev = gen.device
    count = (n - m) * m
    e = torch.arange(count, device=dev)
    new = m + e // m
    span = 2 * (new - m) * m        # entries of every edge before v's
    pos = (torch.rand(count, dtype=torch.float64, generator=gen, device=dev)
           * span).to(torch.int64)
    pos = torch.minimum(pos, (span - 1).clamp_min(0))
    pick = torch.where(pos % 2 == 0, m + (pos // 2) // m,
                       torch.full_like(pos, -1))
    pick[:m] = torch.arange(m, device=dev)   # vertex m joins 0..m-1
    ptr = torch.where(pick < 0, pos // 2, -1)
    while True:
        todo = torch.nonzero(pick < 0).reshape(-1)
        if todo.numel() == 0:
            break
        hop = ptr[todo]
        got = pick[hop]
        done = got >= 0
        pick[todo[done]] = got[done]
        ptr[todo[~done]] = ptr[hop[~done]]
    key = torch.unique(pick * n + new)
    return torch.stack([key // n, key % n], dim=1)
