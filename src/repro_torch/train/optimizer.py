"""In-house AdamW + global-norm clipping + optional gradient compression.

The port of `repro.train.optimizer`, as functions on nested dicts of
tensors (`repro_torch.tree`), not `torch.optim`: weight decay rides
inside the update's delta, gradients are clipped by their global norm,
and `compress="int8_ef"` quantises each gradient tensor to int8 with
error feedback before the norm. The state keeps the reference's layout,
`{"m", "v", "step"[, "ef"]}`: m, v and ef float32 trees mirroring the
params, `step` an int32 scalar tensor, so `convert` carries it across.

Everything runs where the tensors are and reads nothing back to the
host: the norm, the clip and the bias corrections stay on the device.
Each elementwise step is the reference's arithmetic in its order, run
a slice of `INPLACE_SLICE` elements at a time and written into given
tensors: fresh ones in `adamw_update`, which leaves its inputs as they
were, or the params, m and v themselves in `adamw_update_`, since a
full-width LM's state (50.3 GB for 4.19 B bfloat16 params) has no room
for a second copy on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: str | None = None  # None | "int8_ef"


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments (and error feedback) beside each param; `step` on the
    device of the first param leaf."""
    state = {"m": tree_map(_zeros_f32, params),
             "v": tree_map(_zeros_f32, params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}
    if cfg.compress == "int8_ef":
        state["ef"] = tree_map(_zeros_f32, params)
    return state


def opt_state_shapes(params: Any, cfg: AdamWConfig) -> dict:
    """The optimiser state's tree as meta tensors (shapes and dtypes
    only; the reference's ShapeDtypeStruct mirror)."""
    def f32_like(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    state = {"m": tree_map(f32_like, params),
             "v": tree_map(f32_like, params),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if cfg.compress == "int8_ef":
        state["ef"] = tree_map(f32_like, params)
    return state


def _global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def _int8_codes(gf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of one float32 tensor: round half to
    even of gf / scale, clipped to ±127, scale = max|gf| / 127."""
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_int8_ef(grads: Any, ef: Any) -> tuple[Any, Any]:
    """Error-feedback int8 round-trip: returns (dequantized grads, new ef)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, scale = _int8_codes(gf)
        deq = q.to(torch.float32) * scale
        return deq, gf.sub_(deq)
    pairs = tree_map(one, grads, ef)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


#: Elements of one slice of an AdamW update (1 GB of each float32
#: temporary).
INPLACE_SLICE = 1 << 28


def _prepare(grads: Any, state: dict, cfg: AdamWConfig):
    """(grads, new ef or None, clip, step, bc1, bc2) of one update."""
    if cfg.compress == "int8_ef":
        grads, new_ef = _quantize_int8_ef(grads, state["ef"])
    else:
        new_ef = None
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state["step"] + 1
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    return grads, new_ef, clip, step, bc1, bc2


def _leaf_update(p, g, m, v, cfg: AdamWConfig, clip, bc1, bc2,
                 p_out, m_out, v_out) -> None:
    """The new p, m and v into p_out, m_out and v_out, which may be p, m
    and v themselves."""
    g = g.to(torch.float32) * clip
    torch.mul(m, cfg.b1, out=m_out).add_(g * (1 - cfg.b1))
    torch.mul(v, cfg.b2, out=v_out).add_((g * (1 - cfg.b2)).mul_(g))
    del g
    denom = (v_out / bc2).sqrt_().add_(cfg.eps)
    delta = (m_out / bc1).div_(denom)
    del denom
    pf = p.to(torch.float32)
    delta.add_(pf * cfg.weight_decay)
    torch.sub(pf, delta.mul_(cfg.lr), out=p_out)


def _update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
            out: tuple) -> dict:
    """One AdamW step into `out` = (params, m, v) trees of contiguous
    tensors; returns the state's new `step` (and `ef`)."""
    grads, new_ef, clip, step, bc1, bc2 = _prepare(grads, state, cfg)
    leaves = [tree_leaves(t) for t in (params, grads, state["m"],
                                       state["v"], *out)]
    for tensors in zip(*leaves):
        if not all(t.is_contiguous() for t in tensors[4:]):
            raise ValueError("AdamW writes contiguous params, m and v")
        for sl in zip(*(t.reshape(-1).split(INPLACE_SLICE)
                        for t in tensors)):
            _leaf_update(*sl[:4], cfg, clip, bc1, bc2, *sl[4:])
    new = {"step": step}
    if new_ef is not None:
        new["ef"] = new_ef
    return new


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict,
                 cfg: AdamWConfig) -> tuple[Any, dict]:
    """One AdamW step: (new params, new state). The inputs are left as
    they were."""
    def fresh(t):
        return torch.empty_like(t, memory_format=torch.contiguous_format)
    new_params, m, v = (tree_map(fresh, t)
                        for t in (params, state["m"], state["v"]))
    new_state = {"m": m, "v": v}
    new_state.update(_update(params, grads, state, cfg,
                             (new_params, m, v)))
    return new_params, new_state


@torch.no_grad()
def adamw_update_(params: Any, grads: Any, state: dict,
                  cfg: AdamWConfig) -> tuple[Any, dict]:
    """One AdamW step in place: the params' and m's and v's tensors take
    the new values, `state["step"]` and `state["ef"]` are replaced;
    returns (params, state). Params, m and v must be contiguous."""
    state.update(_update(params, grads, state, cfg,
                         (params, state["m"], state["v"])))
    return params, state
