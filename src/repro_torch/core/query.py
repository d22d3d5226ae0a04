"""Distance queries: Eq.-3 highway upper bound + bounded BiBFS on G[V\\R].

The port of `repro.core.query`. The bound over a batch is a min-plus
product d⊤[q] = min_{i,j} L[i, s_q] + H[i, j] + L[j, t_q], through the
`minplus` kernel when `use_kernel` (the default on the GPU) and through
plain PyTorch otherwise. The BiBFS runs all queries of a batch as planes
of one relaxation sweep per wave (`core/engine.py`), with a host check
per wave where the reference has a `lax.while_loop`. With
`trace.enable(True)` the bound runs under the span `query.bound` and the
search under `query.bibfs` (`repro_torch/trace.py`).
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core.engine import WAVES, RelaxPlan, relax_sweep
from repro_torch.core.labelling import HighwayLabelling, landmark_onehot
from repro_torch.graphs.coo import INF_D, Graph
from repro_torch.kernels.minplus import ops as minplus_ops


def effective_label_planes(dist: torch.Tensor, hub: torch.Tensor,
                           own: torch.Tensor,
                           landmarks_full: torch.Tensor) -> torch.Tensor:
    """[P, V] effective label values for a plane slice (dist/hub [P, V]).

    `own` [P] is each plane's landmark id, `landmarks_full` [R] the
    complete landmark set. Landmark columns get the trivial (own, 0)
    one-hot entry.
    """
    is_landmark_v = landmark_onehot(landmarks_full, dist.shape[1])
    mask = (dist < INF_D) & ~hub & ~is_landmark_v[None, :]
    vals = torch.where(mask, dist, INF_D)
    onehot = torch.where(own[:, None] == landmarks_full[None, :], 0,
                         INF_D).to(torch.int32)
    cols = landmarks_full.to(torch.int64)
    vals[:, cols] = torch.minimum(vals[:, cols], onehot)
    return vals


def effective_labels(labelling: HighwayLabelling) -> torch.Tensor:
    """[R, V] label values with landmark columns replaced by highway
    one-hots (Def. 3.3)."""
    return effective_label_planes(labelling.dist, labelling.hub,
                                  labelling.landmarks, labelling.landmarks)


def query_upper_bound(labelling: HighwayLabelling, s: torch.Tensor,
                      t: torch.Tensor,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """d⊤ for query pairs (s[q], t[q]) — Eq. 3.

    use_kernel=True goes through `kernels.minplus.ops.minplus_bound` (the
    CUDA kernel on the GPU), which clamps at INF32 = 2^29 like the
    reference's Pallas kernel; False is the reference's jnp contraction,
    clamped at INF_D. None picks the kernel on the GPU. `batched_query`'s
    answers are the same either way. Runs under the span `query.bound`.
    """
    with trace.span("query.bound"):
        lab = effective_labels(labelling)
        s_lab = lab[:, s.to(torch.int64)].T.clamp_max(INF_D).contiguous()
        t_lab = lab[:, t.to(torch.int64)].T.clamp_max(INF_D).contiguous()
        if use_kernel is None:
            use_kernel = lab.device.type == "cuda"
        if use_kernel:
            return minplus_ops.minplus_bound(
                s_lab, labelling.highway.contiguous(), t_lab)
        mid = (s_lab[:, :, None] + labelling.highway[None, :, :]).amin(dim=1)
        return (mid + t_lab).amin(dim=1).clamp_max(INF_D)


def bounded_bibfs(g: Graph, landmarks: torch.Tensor, s: torch.Tensor,
                  t: torch.Tensor, bound: torch.Tensor, max_steps: int = 64,
                  plan: RelaxPlan | None = None, *,
                  rev: Graph | None = None, plan_rev: RelaxPlan | None = None,
                  kind: str = "bibfs") -> torch.Tensor:
    """Distance-bounded bidirectional search on G[V\\R], batched over
    queries.

    Returns d_{G[V\\R]}(s,t) clamped at `bound`. Each wave is a
    Bellman-Ford sweep of one side's [B, V] plane. After ls/lt waves any
    path not yet seen has ≥ ls+lt+1 edges and so weight ≥ (ls+lt+1)·wmin,
    which ends the loop once no query can improve. The side to expand is
    chosen for the whole batch, from the changed-entry counts summed over
    all queries (`fs <= ft`), as the reference does: with `max_steps`
    binding, another order gives other answers.

    The s side expands over `g` with `plan`, the t side over `rev` with
    `plan_rev` (default: the same); the directed variant passes the
    reversed arcs there. Waves count under `WAVES[kind]`.

    One host read before each wave (site "query.bibfs": go on, and which
    side), and one more that ends the loop unless `max_steps` binds. The
    search runs under the span `query.bibfs`, each wave after its read
    under `query.bibfs.wave`.
    """
    with trace.span("query.bibfs"):
        if rev is None:
            rev, plan_rev = g, plan
        n = g.n
        b = s.shape[0]
        dev = g.device
        s, t = s.to(torch.int64), t.to(torch.int64)
        blocked = landmark_onehot(landmarks, n)
        rows = torch.arange(b, device=dev)

        def seeded(x: torch.Tensor) -> torch.Tensor:
            d = torch.full((b, n), INF_D, dtype=torch.int32, device=dev)
            d[rows, x] = 0
            # A landmark endpoint never expands (searches run on G[V\R]).
            return torch.where(~blocked[x][:, None], d, INF_D)

        ds, dt = seeded(s), seeded(t)
        # Smallest live edge weight for the termination bound, clipped to
        # [1, 2^20] so (ls+lt+1)·wmin stays far from int32 wrap.
        wmin = (torch.where(g.valid, g.w, INF_D).amin() if g.w.numel()
                else torch.tensor(INF_D, device=dev)).clamp(1, 1 << 20)

        def expand(dx: torch.Tensor, og: Graph,
                   og_plan: RelaxPlan | None) -> torch.Tensor:
            cand = relax_sweep(og_plan, og, dx, 1, INF_D)
            cand = torch.where(blocked[None, :], INF_D, cand)
            return torch.minimum(dx, cand)

        def best_meet(ds: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
            return (ds + dt).clamp_max(INF_D).amin(dim=1)

        ls = lt = 0
        fs, ft = (ds == 0).sum(), (dt == 0).sum()
        best = best_meet(ds, dt)
        for _ in range(max_steps):
            can_improve = ((ls + lt + 1) * wmin
                           < torch.minimum(best, bound)).any()
            go, expand_s = trace.host_read(
                "query.bibfs", torch.stack([can_improve, fs <= ft]))
            if not go:
                break
            with trace.span("query.bibfs.wave"):
                if expand_s:
                    nd = expand(ds, g, plan)
                    ds, fs, ls = nd, (nd != ds).sum(), ls + 1
                else:
                    nd = expand(dt, rev, plan_rev)
                    dt, ft, lt = nd, (nd != dt).sum(), lt + 1
                WAVES[kind] += 1
                best = torch.minimum(best, best_meet(ds, dt))
        return best


def batched_query(g: Graph, labelling: HighwayLabelling, s: torch.Tensor,
                  t: torch.Tensor, max_steps: int = 64,
                  use_kernel: bool | None = None,
                  plan: RelaxPlan | None = None) -> torch.Tensor:
    """Exact distances Q(s,t) = min(d_{G[V\\R]}(s,t), d⊤) — paper §4;
    INF_D where t is unreachable."""
    d_top = query_upper_bound(labelling, s, t, use_kernel=use_kernel)
    d_sparse = bounded_bibfs(g, labelling.landmarks, s, t, d_top, max_steps,
                             plan)
    out = torch.minimum(d_sparse, d_top)
    return torch.where(out >= INF_D, INF_D, out)
