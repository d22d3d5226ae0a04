"""Highway-cover labelling construction: R pruned BFSs as wave relaxation.

The port of `repro.core.construct`. Each BFS is a fixpoint of edge
relaxation sweeps over key2 planes; all R planes advance together on the
plane axis of one sweep (the reference vmaps them). Pass a `RelaxPlan`
to run the tiled kernel; `plan=None` runs the COO reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import RelaxPlan, fixpoint, relax_sweep
from repro_torch.core.labelling import (
    HighwayLabelling, INF_KEY2, key2_dist, key2_hub, per_plane_hub_mask,
)
from repro_torch.graphs.coo import INF_D, Graph


def construct_key2_planes(g: Graph, own: torch.Tensor,
                          landmarks_full: torch.Tensor,
                          max_iters: int | None = None,
                          plan: RelaxPlan | None = None) -> torch.Tensor:
    """Pruned-BFS fixpoints for a plane slice; returns key2 [P, V].

    `own` is the owning landmark of each plane [P]; `landmarks_full` the
    complete landmark set [R] (the hub flags see every landmark). Each
    plane's own landmark is seeded (d=0, l=False) and never hub-forced.
    At most `max_iters` sweeps run (None: until the fixpoint, at most
    V + 1); each plane of the reference's vmap stops at min(max_iters,
    its own fixpoint), and a converged plane is unchanged by more sweeps,
    so one loop over [P, V] capped at `max_iters` gives the same planes.
    """
    p_count = own.shape[0]
    dst_is_hub = per_plane_hub_mask(landmarks_full, own, g.n)
    key2_0 = torch.full((p_count, g.n), INF_KEY2, dtype=torch.int32,
                        device=g.device)
    key2_0[torch.arange(p_count, device=g.device), own.to(torch.int64)] = 1

    def sweep(k: torch.Tensor) -> torch.Tensor:
        ext = relax_sweep(plan, g, k, 2, INF_KEY2, hub=dst_is_hub,
                          clear_bit=1)
        return torch.minimum(k, ext)

    return fixpoint("construct", sweep, key2_0,
                    limit=max_iters if max_iters is not None else g.n + 1)


def build_labelling(g: Graph, landmarks: torch.Tensor,
                    max_iters: int | None = None,
                    plan: RelaxPlan | None = None) -> HighwayLabelling:
    """Construct the minimal highway-cover labelling for G (with
    `max_iters`, the labelling after at most that many sweeps)."""
    landmarks = landmarks.to(torch.int32)
    key2 = construct_key2_planes(g, landmarks, landmarks, max_iters, plan)
    dist = key2_dist(key2).clamp_max(INF_D)
    hub = key2_hub(key2) & (dist < INF_D)
    highway = dist[:, landmarks.to(torch.int64)]  # [i, j] = dist[i, lm[j]]
    return HighwayLabelling(landmarks, dist, hub, highway.contiguous())


def select_landmarks_by_degree(g: Graph, k: int) -> torch.Tensor:
    """Paper's landmark policy: the top-k highest-degree vertices.

    Ties go to the lower vertex id, as `lax.top_k` breaks them; the order
    fixes the plane order, and `torch.topk` promises no tie order on the
    GPU, so this is a stable descending sort.
    """
    deg = torch.zeros(g.n, dtype=torch.int32, device=g.device)
    deg.scatter_add_(0, g.dst.to(torch.int64), g.valid.to(torch.int32))
    order = torch.sort(deg, descending=True, stable=True).indices
    return order[:k].to(torch.int32)
