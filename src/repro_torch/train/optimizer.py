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
Each elementwise step is the reference's arithmetic in its order; the
update writes into fresh temporaries in place to keep their count low.
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


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict,
                 cfg: AdamWConfig) -> tuple[Any, dict]:
    """One AdamW step: (new params, new state). The inputs are left as
    they were."""
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

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_new = (m * cfg.b1).add_(g * (1 - cfg.b1))
        v_new = (v * cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        del g
        denom = (v_new / bc2).sqrt_().add_(cfg.eps)
        delta = (m_new / bc1).div_(denom)
        del denom
        pf = p.to(torch.float32)
        delta.add_(pf * cfg.weight_decay)
        p_new = (pf - delta.mul_(cfg.lr)).to(p.dtype)
        return p_new, m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": tree_map(lambda t: t[1], out),
                 "v": tree_map(lambda t: t[2], out),
                 "step": step}
    if new_ef is not None:
        new_state["ef"] = new_ef
    return tree_map(lambda t: t[0], out), new_state
