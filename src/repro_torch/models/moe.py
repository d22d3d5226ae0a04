"""Capacity-based top-k MoE FFN (GShard/Mixtral/DeepSeek style).

The port of `repro.models.moe`. Tokens are processed in dispatch groups
of `_GROUP` tokens; each expert takes at most
cap = max(int(tg·k/E·capacity_factor), 4) tokens of a group, in the
order of the flattened (token, k) pairs, and the rest are dropped (the
shared experts and the residual carry them).

The reference dispatches and combines through one-hot tensors
[G, tg, k, E, cap] (1.5 GB in bfloat16 at DeepSeek's prefill_32k). The
port moves rows by index instead, with the same result: each kept
(token, k) pair owns one slot (expert, position) of its group, so the
dispatch copies its token's row there (the reference's one-hot sum of a
single row, exact) and the combine gathers each pair's expert output
and sums the pairs of a token with their gates, in float32, the gates
rounded to the activations' dtype first as the reference's combine
tensor is. A dropped pair's slot is a scratch row past the end, which
reads as zeros. Top-k breaks ties toward the lower expert id, as
`lax.top_k` does (a stable descending sort).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_GROUP = 512  # dispatch group size (tokens)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(h)
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    r = F.relu(h)
    return r * r


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, xt: torch.Tensor, c) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(gates renormalised over the top k, float32; expert ids) [g, tg, k]
    of the tokens xt [g, tg, d]."""
    logits = torch.matmul(xt.float(), p["router"].float())   # [g, tg, e]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_idx = top_k(probs, c.top_k)
    return gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9), top_idx


def moe_ffn(p: dict, x: torch.Tensor, c) -> torch.Tensor:
    """x [B, S, D] → [B, S, D] through routed experts."""
    b, s, d = x.shape
    t = b * s
    e, k = c.n_experts, c.top_k
    tg = min(_GROUP, t)
    g = t // tg
    if t % tg:
        raise ValueError(f"{t} tokens do not split into groups of {tg}")
    xt = x.reshape(g, tg, d)
    gate_vals, top_idx = route(p, xt, c)                     # [g, tg, k]

    cap = max(int(tg * k / e * c.capacity_factor), 4)
    # Position of each (token, k) within its expert's per-group capacity.
    flat = top_idx.reshape(g, tg * k)
    onehot = (flat[..., None] == torch.arange(e, device=x.device)).to(
        torch.int32)                                          # [g, tg*k, e]
    pos = torch.gather(torch.cumsum(onehot, dim=1) - 1, -1,
                       flat[..., None])[..., 0]               # [g, tg*k]
    group = torch.arange(g, device=x.device)[:, None]
    scratch = g * e * cap
    slot = torch.where(pos < cap, (group * e + flat) * cap + pos,
                       scratch).reshape(-1)

    src = xt[:, :, None, :].expand(g, tg, k, d).reshape(g * tg * k, d)
    xe = x.new_zeros(scratch + 1, d).index_copy(0, slot, src)[:scratch]
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    # per-expert products, accumulated in float32 in the params' dtype
    gt = torch.bmm(xe, p["w_gate"])
    if c.gated:
        h = _act(gt, c.act) * torch.bmm(xe, p["w_up"])
    else:
        h = _act(gt, c.act)
    ye = torch.bmm(h, p["w_down"])                            # [e, g·cap, d]
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(scratch, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    picked = ye[slot].reshape(g, tg, k, d).float()
    gates = gate_vals.to(x.dtype).float()[..., None]
    yt = torch.sum(picked * gates, dim=2).to(x.dtype)
    return yt.reshape(b, s, d)


def load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (exposed for training drivers)."""
    probs = torch.softmax(logits.reshape(-1, n_experts).float(), dim=-1)
    me = torch.mean(probs, dim=0)
    first = top_idx.reshape(-1, top_idx.shape[-1])[:, 0]
    ce = torch.mean(F.one_hot(first.long(), n_experts).float(), dim=0)
    return n_experts * torch.sum(me * ce)
