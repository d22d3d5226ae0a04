"""MIND: Multi-Interest Network with Dynamic routing (recsys).

The port of `repro.models.mind`. Pipeline: item-embedding gather over
user history → B2I capsule routing (3 iterations) extracting K=4 interest
capsules → label-aware attention for training / max-over-interests
scoring for retrieval.

Every gather is the reference's `jnp.take` (`repro_torch.gather`), so the
table's gradient is dense, as JAX's is: each step decays every row and
advances its moments. Each contraction takes its inputs in float32 and
returns float32 before the cast to the config's dtype, as the reference's
`preferred_element_type=float32` followed by `.astype(dtype)`. Retrieval
scores its candidates as one batched matmul, never a loop.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.gather import take_rows
from repro_torch.launch.mesh import P


@dataclasses.dataclass(frozen=True)
class MindConfig:
    name: str
    n_items: int
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    dtype: torch.dtype = torch.float32
    temperature: float = 0.05


def param_shapes(c: MindConfig) -> dict:
    """{name: (shape, dtype)}."""
    d = c.embed_dim
    return {"item_embed": ((c.n_items, d), c.dtype),
            "bilinear": ((d, d), c.dtype),
            "out_proj": ((d, d), c.dtype)}


def param_specs(c: MindConfig, pod: bool = False) -> dict:
    """Placement specs on the production mesh: the item table row-sharded
    over every axis, the square matrices replicated."""
    rows = ("model", "pod", "data") if pod else ("model", "data")
    return {"item_embed": P(rows, None),
            "bilinear": P(None, None),
            "out_proj": P(None, None)}


def init_params(c: MindConfig, *, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> dict:
    """N(0, 0.1²) item rows; N(0, 1/d) square matrices. On the GPU unless
    `device` says otherwise; `generator` must live on that device."""
    dev = resolve_device(device)
    d = c.embed_dim

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(c.dtype)
    return {"item_embed": normal((c.n_items, d), 0.1),
            "bilinear": normal((d, d), 1.0 / math.sqrt(d)),
            "out_proj": normal((d, d), 1.0 / math.sqrt(d))}


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 inputs and a float32 result."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _squash(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return (sq / (1.0 + sq)) * x / torch.sqrt(sq + 1e-9)


def extract_interests(params: dict, hist: torch.Tensor,
                      hist_mask: torch.Tensor, c: MindConfig) -> torch.Tensor:
    """B2I dynamic routing. hist [B, L] item ids → interests [B, K, D]."""
    emb = take_rows(params["item_embed"], hist)            # [B, L, D]
    u_hat = _contract("bld,de->ble", emb,
                      params["bilinear"]).to(emb.dtype)    # [B, L, D]
    b_logit = torch.zeros(hist.shape[:1] + (c.n_interests, hist.shape[1]),
                          dtype=torch.float32, device=hist.device)
    u_sg = u_hat.detach()
    for it in range(c.capsule_iters):
        logit = torch.where(hist_mask[:, None, :], b_logit, -1e9)
        w = torch.softmax(logit, dim=1)                    # over interests
        src = u_hat if it == c.capsule_iters - 1 else u_sg
        z = _contract("bkl,bld->bkd", w.to(src.dtype), src).to(src.dtype)
        caps = _squash(z.to(torch.float32)).to(src.dtype)
        if it < c.capsule_iters - 1:
            b_logit = b_logit + _contract("bkd,bld->bkl", caps, u_sg)
    return _contract("bkd,de->bke", caps,
                     params["out_proj"]).to(caps.dtype)


def label_aware_user_vec(interests: torch.Tensor, target_emb: torch.Tensor,
                         power: float = 2.0) -> torch.Tensor:
    """Label-aware attention (paper eq. 8): pow-sharpened softmax over K."""
    logits = _contract("bkd,bd->bk", interests, target_emb)
    w = torch.softmax(logits * power, dim=-1)
    return _contract("bk,bkd->bd", w.to(interests.dtype),
                     interests).to(interests.dtype)


def train_loss(params: dict, batch: dict, c: MindConfig) -> torch.Tensor:
    """Sampled-softmax with in-batch negatives:
    mean_b(logsumexp(logits[b]) − logits[b, b]).

    `F.cross_entropy` over the labels 0..B-1 computes that function
    (`tests/test_torch_mind.py` holds it to the literal form); its
    backward keeps fewer [B, B] copies alive."""
    interests = extract_interests(params, batch["hist"], batch["hist_mask"],
                                  c)
    tgt = take_rows(params["item_embed"], batch["target"])  # [B, D]
    user = label_aware_user_vec(interests, tgt)             # [B, D]
    logits = _contract("bd,cd->bc", user, tgt) / c.temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def serve_scores(params: dict, batch: dict, c: MindConfig) -> torch.Tensor:
    """Online inference: score candidate items. hist [B,L], cands [B,C]
    → scores [B, C] (max over interests)."""
    interests = extract_interests(params, batch["hist"], batch["hist_mask"],
                                  c)
    cand = take_rows(params["item_embed"], batch["cands"])   # [B, C, D]
    scores = _contract("bkd,bcd->bkc", interests, cand)
    return torch.amax(scores, dim=1)


def retrieval_scores(params: dict, batch: dict,
                     c: MindConfig) -> torch.Tensor:
    """Retrieval: one query against the full candidate set [C] (10⁶) —
    a single batched matmul against the embedding rows."""
    interests = extract_interests(params, batch["hist"], batch["hist_mask"],
                                  c)                         # [1, K, D]
    cand = take_rows(params["item_embed"], batch["cands"])   # [C, D]
    scores = _contract("bkd,cd->bkc", interests, cand)
    return torch.amax(scores, dim=1)                         # [1, C]
