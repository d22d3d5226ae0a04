"""Composable decoder-only transformer covering the five LM archs.

The port of `repro.models.transformer`: GQA and MLA attention, RoPE,
sliding-window and local/global-alternating attention, attention and
final logit softcaps (Gemma-2), gated and ungated FFNs, the
capacity-based top-k MoE with shared experts (`models/moe.py`),
flash-style chunked attention that never holds an [S, S] buffer, and
KV-cache decode, with the reference's params tree (stacked
`dense_layers`/`moe_layers` leaves with a leading L axis), so `convert`
and checkpoints carry it leaf for leaf.

Numerics, as the reference's:
- `_mm` accumulates in float32 and returns the input's dtype (one
  float32-accumulated GEMM in that dtype); `rms_norm` and `rope` work in
  float32 and cast back; the embedding scale √d_model is rounded to the
  activations' dtype before the product.
- Attention scores, the online softmax and the P·V sums are float32:
  each q block and kv chunk is upcast to float32 before its product (a
  bfloat16 value is exact in float32, so the products equal the
  reference's `preferred_element_type=float32` ones), and P is rounded
  to V's dtype before P·V, as the reference's `p.astype(v.dtype)`.
  Upcasting was chosen over `torch.bmm(..., out_dtype=float32)` because
  that op has no autograd formula, and training goes through the same
  attention. The output is bfloat16 for bfloat16 q, else float32.
- Masked scores are `NEG_INF` (-1e30), never -inf: a row whose first kv
  chunks are all masked collects exp(0) terms that the first chunk it
  sees erases exactly (its correction factor is exp(-1e30 - m) = 0).

What differs from the reference, with the same values:
- Attention loops in Python over q blocks and, inside each, over kv
  chunks; a chunk masked for every row of its q block (past the causal
  diagonal, outside the window, or past the valid cache length) is
  skipped, which leaves each row's (m, l, acc) as the reference's
  all-masked step leaves it. Each row's sequence of updates does not
  depend on how rows are grouped, so q blocks (and kv chunks) are the
  config's `q_chunk`/`kv_chunk` grown by whole multiples while a block
  of float32 scores stays within `SCORE_BLOCK` elements and a float32
  kv chunk within `KV_BLOCK` (fewer, larger launches; a decode step
  reads its cache in a few chunks).
- Layers run in a Python loop over the stacked params, one `unbind`
  view per layer (the stacked leaf's gradient is assembled once). With
  gradients on, each layer and each loss chunk goes through
  `torch.utils.checkpoint` (`use_reentrant=False`), as the reference's
  `jax.checkpoint`: only layer inputs and loss-chunk inputs are kept.
  `unroll_layers` changes nothing here (the loop is always unrolled);
  `attn_2d_batch` only adds sharding constraints in the reference and
  does nothing on one device.
- `decode_step` writes the new cache entries into `cache` in place and
  returns it (the reference returns a new cache; a full-width cache does
  not fit twice), and takes `cache_len` as a Python int. It runs without
  autograd.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.gather import take_rows
from repro_torch.launch.mesh import P
from repro_torch.models import moe as moe_lib
from repro_torch.tree import tree_map

NEG_INF = -1e30
#: The most float32 elements of one block of attention scores [b, heads,
#: q rows, kv columns] (256 MB), and of one kv chunk upcast to float32.
SCORE_BLOCK = 1 << 26
KV_BLOCK = 1 << 28


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # attention flavour
    attn_pattern: str = "full"       # full | swa | local_global
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # FFN flavour
    act: str = "silu"                # silu | gelu | relu2
    gated: bool = True
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # attention chunking (flash-style)
    q_chunk: int = 512
    kv_chunk: int = 512
    loss_chunk: int = 512
    # the reference's analysis mode (a Python loop over layers); the
    # port's layer loop is always one
    unroll_layers: bool = False
    # sliding-window layers keep a ring-buffer KV cache of `window`
    # entries instead of the full context
    ring_local: bool = False
    # the reference's sharding constraint around attention; nothing to
    # constrain on one device
    attn_2d_batch: bool = False

    @property
    def params_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        c = self
        embed = c.vocab * c.d_model
        if c.use_mla:
            attn = c.d_model * (c.n_heads * (c.qk_nope_dim + c.qk_rope_dim))
            attn += c.d_model * (c.kv_lora_rank + c.qk_rope_dim)
            attn += c.kv_lora_rank * c.n_heads * (c.qk_nope_dim
                                                  + c.v_head_dim)
            attn += c.n_heads * c.v_head_dim * c.d_model
        else:
            attn = c.d_model * c.n_heads * c.d_head
            attn += 2 * c.d_model * c.n_kv_heads * c.d_head
            attn += c.n_heads * c.d_head * c.d_model
        ffn_dense = c.d_model * c.d_ff * (3 if c.gated else 2)
        if c.moe:
            ffn_moe = (c.n_experts
                       * c.d_model * c.d_ff_expert * (3 if c.gated else 2))
            ffn_moe += c.n_shared_experts * c.d_model * c.d_ff_expert * 3
            ffn_moe += c.d_model * c.n_experts  # router
            n_moe = c.n_layers - c.first_k_dense
            ffn_total = c.first_k_dense * ffn_dense + n_moe * ffn_moe
        else:
            ffn_total = c.n_layers * ffn_dense
        return embed + c.n_layers * attn + ffn_total + embed  # + lm head

    @property
    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only routed-to experts)."""
        c = self
        if not c.moe:
            return self.params_count
        embed = c.vocab * c.d_model
        attn = (c.d_model * c.n_heads * c.d_head
                + 2 * c.d_model * c.n_kv_heads * c.d_head
                + c.n_heads * c.d_head * c.d_model)
        if c.use_mla:
            attn = (c.d_model * (c.n_heads * (c.qk_nope_dim + c.qk_rope_dim))
                    + c.d_model * (c.kv_lora_rank + c.qk_rope_dim)
                    + c.kv_lora_rank * c.n_heads * (c.qk_nope_dim
                                                    + c.v_head_dim)
                    + c.n_heads * c.v_head_dim * c.d_model)
        act_ffn = ((c.top_k + c.n_shared_experts)
                   * c.d_model * c.d_ff_expert * (3 if c.gated else 2))
        return embed * 2 + c.n_layers * (attn + act_ffn)


# ---------------------------------------------------------------------------
# Parameter init / shape declaration
# ---------------------------------------------------------------------------

def _meta(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _n_moe(c: TransformerConfig) -> int:
    return c.n_layers - c.first_k_dense if c.moe else 0


def layer_param_shapes(c: TransformerConfig, moe_layer: bool) -> dict:
    """{name: (shape, dtype)} of one layer's params (stacked under a
    leading L axis by `param_shapes`)."""
    d, dt, f32 = c.d_model, c.dtype, torch.float32
    p: dict[str, Any] = {"ln_attn": ((d,), f32), "ln_ffn": ((d,), f32)}
    if c.use_mla:
        p.update({
            "wq": ((d, c.n_heads * (c.qk_nope_dim + c.qk_rope_dim)), dt),
            "wkv_a": ((d, c.kv_lora_rank + c.qk_rope_dim), dt),
            "kv_ln": ((c.kv_lora_rank,), f32),
            "wkv_b": ((c.kv_lora_rank,
                       c.n_heads * (c.qk_nope_dim + c.v_head_dim)), dt),
            "wo": ((c.n_heads * c.v_head_dim, d), dt),
        })
    else:
        p.update({
            "wq": ((d, c.n_heads * c.d_head), dt),
            "wk": ((d, c.n_kv_heads * c.d_head), dt),
            "wv": ((d, c.n_kv_heads * c.d_head), dt),
            "wo": ((c.n_heads * c.d_head, d), dt),
        })
    if moe_layer:
        e, f = c.n_experts, c.d_ff_expert
        p["router"] = ((d, e), f32)
        p["w_gate"] = ((e, d, f), dt)
        p["w_up"] = ((e, d, f), dt)
        p["w_down"] = ((e, f, d), dt)
        if c.n_shared_experts:
            fs = c.n_shared_experts * f
            p["ws_gate"] = ((d, fs), dt)
            p["ws_up"] = ((d, fs), dt)
            p["ws_down"] = ((fs, d), dt)
    else:
        p["w_gate"] = ((c.d_model, c.d_ff), dt)
        if c.gated:
            p["w_up"] = ((c.d_model, c.d_ff), dt)
        p["w_down"] = ((c.d_ff, c.d_model), dt)
    return p


def param_shapes(c: TransformerConfig) -> dict:
    """The params tree as tensors on the meta device (shapes and dtypes
    only; the reference's ShapeDtypeStruct tree)."""
    def stack(shapes: dict, n: int) -> dict:
        return {k: _meta((n,) + s, d) for k, (s, d) in shapes.items()}

    n_moe = _n_moe(c)
    n_dense = c.n_layers - n_moe
    out = {
        "embed": _meta((c.vocab, c.d_model), c.dtype),
        "final_ln": _meta((c.d_model,), torch.float32),
        "lm_head": _meta((c.d_model, c.vocab), c.dtype),
    }
    if n_dense:
        out["dense_layers"] = stack(layer_param_shapes(c, False), n_dense)
    if n_moe:
        out["moe_layers"] = stack(layer_param_shapes(c, True), n_moe)
    return out


def param_specs(c: TransformerConfig, pod: bool = False,
                scheme: str = "v2") -> dict:
    """The params tree's placement specs on the production mesh
    (`launch/mesh.py:P`), rule for rule as the reference's.

    scheme="v1": every projection output-sharded over 'model'.
    scheme="v2" (default), Megatron-style: attention weights FSDP on the
    d_model dim only (heads whole); the FFN tensor-parallel on d_ff over
    'model'; embedding and lm_head vocab-parallel over 'model'. MoE
    experts are expert-parallel when their count divides the 16-way model
    axis, else tensor-parallel on the ffn dim.
    """
    fsdp = ("pod", "data") if pod else ("data",)
    tp = "model"
    v2 = scheme == "v2"

    def dense_specs(moe_layer: bool) -> dict:
        s: dict[str, Any] = {"ln_attn": P(None, None),
                             "ln_ffn": P(None, None)}
        if c.use_mla:
            s.update({
                "wq": P(None, fsdp, None) if v2 else P(None, fsdp, tp),
                "wkv_a": P(None, fsdp, None),
                "kv_ln": P(None, None),
                "wkv_b": P(None, None, None) if v2 else P(None, fsdp, tp),
                "wo": P(None, None, fsdp) if v2 else P(None, tp, fsdp),
            })
        else:
            qkv = P(None, fsdp, None) if v2 else P(None, fsdp, tp)
            s.update({"wq": qkv, "wk": qkv, "wv": qkv,
                      "wo": P(None, None, fsdp) if v2 else P(None, tp, fsdp)})
        if moe_layer:
            s["router"] = P(None, fsdp, None)
            if c.n_experts % 16 == 0:
                s["w_gate"] = P(None, tp, fsdp, None)
                s["w_up"] = P(None, tp, fsdp, None)
                s["w_down"] = P(None, tp, None, fsdp)
            else:
                s["w_gate"] = P(None, None, fsdp, tp)
                s["w_up"] = P(None, None, fsdp, tp)
                s["w_down"] = P(None, None, tp, fsdp)
            if c.n_shared_experts:
                s["ws_gate"] = P(None, fsdp, tp)
                s["ws_up"] = P(None, fsdp, tp)
                s["ws_down"] = P(None, tp, fsdp)
        else:
            s["w_gate"] = P(None, fsdp, tp)
            if c.gated:
                s["w_up"] = P(None, fsdp, tp)
            s["w_down"] = P(None, tp, fsdp)
        return s

    n_moe = _n_moe(c)
    out = {"embed": P(tp, None) if v2 else P(tp, fsdp),
           "final_ln": P(None),
           "lm_head": P(None, tp) if v2 else P(fsdp, tp)}
    if c.n_layers - n_moe:
        out["dense_layers"] = dense_specs(False)
    if n_moe:
        out["moe_layers"] = dense_specs(True)
    return out


def init_params(c: TransformerConfig, *,
                generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> dict:
    """Random params with the reference's distributions, on the GPU
    unless `device` says otherwise (`generator` must live there): every
    leaf of rank >= 2 is N(0, 1) / sqrt(shape[-2]) drawn in float32 and
    cast to its dtype, the norms ones. A stacked leaf is drawn one slice
    of its leading axis at a time, to bound the float32 draw."""
    dev = resolve_device(device)

    def leaf(s: torch.Tensor) -> torch.Tensor:
        if s.dim() < 2:
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        scale = 1.0 / math.sqrt(s.shape[-2])
        for part in (out if s.dim() >= 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev).mul_(scale))
        return out
    return tree_map(leaf, param_shapes(c))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S]. The halves of the head are
    rotated as pairs (not interleaved)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq       # [.., S, half]
    angles = angles[..., None, :]                         # [.., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in their common dtype, accumulated in float32: the CPU's
    bfloat16 GEMMs do, and on the card `device.resolve_device`, which
    `init_params` and `make_cache` call, has turned cuBLAS's
    reduced-precision (bfloat16) split-K reduction off."""
    return torch.matmul(x, w)


def _grow(n: int, fits) -> int:
    """The largest divisor m of n with fits(m), at least 1."""
    return max([m for m in range(1, n + 1) if n % m == 0 and fits(m)],
               default=1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int, c: TransformerConfig, is_local: bool,
                      kv_len_valid: int | None,
                      scale: float | None = None) -> torch.Tensor:
    """Flash-style attention: q blocks × kv chunks, online softmax.

    q [B, Sq, H, Dq]; k [B, Skv, KV, Dq]; v [B, Skv, KV, Dv].
    q_offset: absolute position of q[0] (decode: the cache length).
    is_local: apply the sliding window (pattern-dependent).
    kv_len_valid: the number of valid cache entries (decode; every row
    of the batch has the same), else None.
    Causal masking is in absolute positions. Never holds S².
    """
    b, sq, h, dq = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dq)
    cq, ckv = min(c.q_chunk, sq), min(c.kv_chunk, skv)
    if sq % cq or skv % ckv:
        raise ValueError(f"q length {sq} and kv length {skv} must be "
                         f"whole multiples of their chunks {cq}, {ckv}")
    cq *= _grow(sq // cq, lambda m: b * h * cq * m * ckv <= SCORE_BLOCK)
    ckv *= _grow(skv // ckv, lambda m: (
        b * h * cq * ckv * m <= SCORE_BLOCK
        and b * ckv * m * kvh * (dq + dv) <= KV_BLOCK))
    n_valid = skv if kv_len_valid is None else kv_len_valid
    dev = q.device
    outs = []
    for q0 in range(0, sq, cq):
        lo, hi = q_offset + q0, q_offset + q0 + cq - 1   # row positions
        # [b, kv, g·cq, dq]: the group folds into the rows, so each kv
        # head's keys serve its g query heads in one product.
        qb = q[:, q0:q0 + cq].reshape(b, cq, kvh, g, dq).permute(
            0, 2, 3, 1, 4).reshape(b, kvh, g * cq, dq).float()
        m = l = acc = None
        for k0 in range(0, min(skv, n_valid), ckv):
            k1 = k0 + ckv - 1
            if k0 > hi or (is_local and lo - k1 >= c.window):
                continue   # masked for every row of the block
            kb = k[:, k0:k0 + ckv].permute(0, 2, 3, 1).float()
            s = torch.matmul(qb, kb) * scale             # [b, kv, g·cq, ckv]
            s = _softcap(s, c.attn_softcap)
            if k1 > lo or k1 >= n_valid or (is_local
                                            and hi - k0 >= c.window):
                q_pos = torch.arange(lo, hi + 1, device=dev)[:, None]
                kv_pos = torch.arange(k0, k1 + 1, device=dev)[None, :]
                mask = (q_pos >= kv_pos) & (kv_pos < n_valid)
                if is_local:
                    mask = mask & (q_pos - kv_pos < c.window)
                s = torch.where(mask.expand(g, cq, ckv).reshape(
                    g * cq, ckv), s, NEG_INF)
            blk = torch.amax(s, dim=-1)
            m_new = blk if m is None else torch.maximum(m, blk)
            p = torch.exp(s - m_new[..., None])
            vb = v[:, k0:k0 + ckv].permute(0, 2, 1, 3).float()
            pv = torch.matmul(p.to(v.dtype).float(), vb)  # [b, kv, g·cq, dv]
            if m is None:   # the reference's first step from (NEG_INF, 0, 0)
                l, acc = torch.sum(p, dim=-1), pv
            else:
                corr = torch.exp(m - m_new)
                l = l * corr + torch.sum(p, dim=-1)
                acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(b, kvh, g, cq, dv).permute(
            0, 3, 1, 2, 4).reshape(b, cq, h, dv))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    return out.to(torch.bfloat16) if q.dtype == torch.bfloat16 else out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_valid: int, scale: float,
                    softcap: float | None) -> torch.Tensor:
    """Decode attention over a ring-buffer window cache.

    RoPE is applied at write time, and softmax is permutation-invariant,
    so slot order inside the ring is irrelevant — only slot validity
    matters. q [B,1,H,Dh]; k/v [B,W,KV,Dh]; n_valid: live slots.
    """
    b, s, h, dh = q.shape
    w, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qr = q.reshape(b, s, kvh, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, kvh, g * s, dh).float()
    scores = torch.matmul(qr, k.permute(0, 2, 3, 1).float()) * scale
    scores = _softcap(scores, softcap)
    mask = torch.arange(w, device=q.device) < n_valid
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.permute(0, 2, 1, 3).float())
    return out.reshape(b, kvh, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h, dh).to(q.dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """Write `new` [B, s, ...] into `cache` [B, S, ...] at `at`, in place."""
    if at + new.shape[1] > cache.shape[1]:
        raise ValueError(f"cache of length {cache.shape[1]} has no room for "
                         f"{new.shape[1]} entries at {at}")
    cache[:, at:at + new.shape[1]] = new
    return cache


def _attention_block(p: dict, x: torch.Tensor, c: TransformerConfig,
                     positions: torch.Tensor, is_local: bool,
                     cache: dict | None, cache_len: int | None,
                     ring: bool = False) -> torch.Tensor:
    """The attention output; a layer's `cache` (views into the stacked
    cache) gets this step's entries in place."""
    b, s, _ = x.shape
    valid = cache_len + s if cache is not None else None
    offset = cache_len if cache is not None else 0
    if c.use_mla:
        nope, r = c.qk_nope_dim, c.kv_lora_rank
        q = _mm(x, p["wq"]).reshape(b, s, c.n_heads, nope + c.qk_rope_dim)
        q_nope = q[..., :nope]
        q_rope = rope(q[..., nope:], positions, c.rope_theta)
        kv_a = _mm(x, p["wkv_a"])
        c_kv = rms_norm(kv_a[..., :r], p["kv_ln"], c.norm_eps)
        k_rope = rope(kv_a[..., None, r:], positions,
                      c.rope_theta)                        # [b,s,1,rope]
        if cache is not None:
            c_kv = _write(cache["c_kv"], c_kv, cache_len)
            k_rope = _write(cache["k_rope"], k_rope, cache_len)
        wkv_b = p["wkv_b"].reshape(r, c.n_heads, nope + c.v_head_dim)
        w_uk = wkv_b[..., :nope]                           # [r, h, nope]
        w_uv = wkv_b[..., nope:]                           # [r, h, vdim]
        # Absorbed MLA: score in latent space (production decode path).
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        q_eff = torch.cat([q_lat, q_rope], -1)             # [b,s,h,r+rope]
        k_eff = torch.cat([c_kv[:, :, None, :], k_rope], -1)
        # Absorbed scores equal q_nope·k_nope + q_rope·k_rope, so the
        # scale is that of the original head dim, not the latent dim.
        mla_scale = 1.0 / math.sqrt(nope + c.qk_rope_dim)
        attn_lat = chunked_attention(q_eff, k_eff, c_kv[:, :, None, :],
                                     offset, c, is_local, valid,
                                     scale=mla_scale)      # [b,s,h,r]
        out = torch.einsum("bshr,rhv->bshv", attn_lat.float(),
                           w_uv.float())
        out = out.reshape(b, s, c.n_heads * c.v_head_dim).to(x.dtype)
        return _mm(out, p["wo"])

    q = _mm(x, p["wq"]).reshape(b, s, c.n_heads, c.d_head)
    k = _mm(x, p["wk"]).reshape(b, s, c.n_kv_heads, c.d_head)
    v = _mm(x, p["wv"]).reshape(b, s, c.n_kv_heads, c.d_head)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    if ring:
        # ring-buffer window cache: overwrite the oldest slot
        if cache is None or s != 1:
            raise ValueError("a ring cache takes one token a step")
        slot = cache_len % c.window
        k = _write(cache["k"], k, slot)
        v = _write(cache["v"], v, slot)
        out = _ring_attention(q, k, v, min(cache_len + s, c.window),
                              1.0 / math.sqrt(c.d_head), c.attn_softcap)
        return _mm(out.reshape(b, s, c.n_heads * c.d_head), p["wo"])
    if cache is not None:
        k = _write(cache["k"], k, cache_len)
        v = _write(cache["v"], v, cache_len)
    out = chunked_attention(q, k, v, offset, c, is_local, valid)
    return _mm(out.reshape(b, s, c.n_heads * c.d_head), p["wo"])


def _ffn_block(p: dict, x: torch.Tensor, c: TransformerConfig,
               moe_layer: bool) -> torch.Tensor:
    if moe_layer:
        out = moe_lib.moe_ffn(p, x, c)
        if c.n_shared_experts:
            g = _act(_mm(x, p["ws_gate"]), c.act)
            out = out + _mm(g * _mm(x, p["ws_up"]), p["ws_down"])
        return out
    g = _act(_mm(x, p["w_gate"]), c.act)
    h = g * _mm(x, p["w_up"]) if c.gated else g
    return _mm(h, p["w_down"])


def _layer(p: dict, x: torch.Tensor, c: TransformerConfig,
           positions: torch.Tensor, is_local: bool, moe_layer: bool,
           cache: dict | None = None, cache_len: int | None = None,
           ring: bool = False) -> torch.Tensor:
    a_in = rms_norm(x, p["ln_attn"], c.norm_eps)
    x = x + _attention_block(p, a_in, c, positions, is_local, cache,
                             cache_len, ring=ring)
    return x + _ffn_block(p, rms_norm(x, p["ln_ffn"], c.norm_eps), c,
                          moe_layer)


def _is_local_flags(c: TransformerConfig, n: int, offset: int) -> list:
    if c.attn_pattern == "swa":
        return [True] * n
    if c.attn_pattern == "local_global":
        return [(offset + i) % 2 == 0 for i in range(n)]
    return [False] * n


def _unstack(stack: dict) -> list:
    """The per-layer params of a stacked tree: layer i's leaves are views
    `a[i]` (one `unbind` per leaf, so autograd stacks the gradients
    once)."""
    parts = {k: a.unbind(0) for k, a in stack.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _embed(params: dict, tokens: torch.Tensor,
           c: TransformerConfig) -> torch.Tensor:
    x = take_rows(params["embed"], tokens)   # jnp.take's rule
    # sqrt(d_model) rounded to the activations' dtype first, as the
    # reference's jnp.asarray(sqrt(d), x.dtype); a host scalar, so no
    # copy to the device (which would wait for it)
    return x * float(torch.tensor(math.sqrt(c.d_model), dtype=x.dtype))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: torch.Tensor, c: TransformerConfig,
            return_hidden: bool = False) -> torch.Tensor:
    """Training / prefill forward. tokens [B, S] → logits [B, S, vocab]
    (or final hidden states when return_hidden)."""
    b, s = tokens.shape
    x = _embed(params, tokens, c)
    positions = torch.arange(s, device=x.device).expand(b, s)
    n_moe = _n_moe(c)
    n_dense = c.n_layers - n_moe
    remat = torch.is_grad_enabled()

    def run_stack(x, stack, n, offset, moe_layer):
        flags = _is_local_flags(c, n, offset)
        for layer_p, flag in zip(_unstack(stack), flags):
            if remat:
                x = checkpoint(_layer, layer_p, x, c, positions, flag,
                               moe_layer, use_reentrant=False)
            else:
                x = _layer(layer_p, x, c, positions, flag, moe_layer)
        return x

    if n_dense:
        x = run_stack(x, params["dense_layers"], n_dense, 0, False)
    if n_moe:
        x = run_stack(x, params["moe_layers"], n_moe, n_dense, True)
    x = rms_norm(x, params["final_ln"], c.norm_eps)
    if return_hidden:
        return x
    return _softcap(_mm(x, params["lm_head"]), c.final_softcap)


def _chunk_loss(h: torch.Tensor, t: torch.Tensor, lm_head: torch.Tensor,
                cap: float | None) -> torch.Tensor:
    logits = _softcap(_mm(h, lm_head), cap).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                 c: TransformerConfig) -> torch.Tensor:
    """Cross-entropy over seq chunks — never a [B, S, vocab] logits
    buffer (with gradients on, each chunk's logits are recomputed in the
    backward pass)."""
    hidden = forward(params, tokens, c, return_hidden=True)
    b, s, _ = hidden.shape
    ck = min(c.loss_chunk, s)
    if s % ck:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {ck}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, ck):
        args = (hidden[:, i:i + ck], targets[:, i:i + ck],
                params["lm_head"], c.final_softcap)
        part = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _chunk_loss(*args))
        total = total + part
    return total / (b * s)


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------

def cache_shapes(c: TransformerConfig, batch: int, max_len: int) -> dict:
    """The KV cache tree (per layer stack) as meta tensors.

    With ring_local, sliding-window layers hold `window` slots instead of
    `max_len` (ring buffer): swa → every layer; local_global → the local
    half of each (local, global) pair."""
    n_moe = _n_moe(c)
    n_dense = c.n_layers - n_moe

    def one(n, length):
        if c.use_mla:
            return {
                "c_kv": _meta((n, batch, length, c.kv_lora_rank), c.dtype),
                "k_rope": _meta((n, batch, length, 1, c.qk_rope_dim),
                                c.dtype),
            }
        shape = (n, batch, length, c.n_kv_heads, c.d_head)
        return {"k": _meta(shape, c.dtype), "v": _meta(shape, c.dtype)}

    if c.ring_local and c.attn_pattern == "swa":
        w = min(c.window, max_len)
        out = {}
        if n_dense:
            out["dense"] = one(n_dense, w)
        if n_moe:
            out["moe"] = one(n_moe, w)
        return out
    if _paired(c):
        w = min(c.window, max_len)
        return {"dense_local": one(c.n_layers // 2, w),
                "dense_global": one(c.n_layers // 2, max_len)}
    out = {}
    if n_dense:
        out["dense"] = one(n_dense, max_len)
    if n_moe:
        out["moe"] = one(n_moe, max_len)
    return out


def cache_specs(c: TransformerConfig, pod: bool = False) -> dict:
    """The KV cache's placement specs, as the reference's: the sequence
    over the data axes (flash-decoding), kv heads (MLA: the latent dim)
    over 'model'."""
    seq_ax = ("pod", "data") if pod else ("data",)
    n_moe = _n_moe(c)

    def one():
        if c.use_mla:
            return {"c_kv": P(None, None, seq_ax, "model"),
                    "k_rope": P(None, None, seq_ax, None, None)}
        return {"k": P(None, None, seq_ax, "model", None),
                "v": P(None, None, seq_ax, "model", None)}
    out = {}
    if c.n_layers - n_moe:
        out["dense"] = one()
    if n_moe:
        out["moe"] = one()
    return out


def _paired(c: TransformerConfig) -> bool:
    return (c.ring_local and c.attn_pattern == "local_global"
            and not c.moe and c.n_layers % 2 == 0)


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: a[i] for k, a in cache.items()}


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cache_len: int, c: TransformerConfig):
    """One decode step: tokens [B, s] at positions cache_len.. →
    (logits of the last token [B, vocab], cache). `cache` (a tree of
    `cache_shapes`) is written in place; a tensor `cache_len` is read
    once to the host."""
    b, s = tokens.shape
    cache_len = int(cache_len)
    x = _embed(params, tokens, c)
    positions = (cache_len + torch.arange(s, device=x.device)).expand(b, s)
    n_moe = _n_moe(c)
    n_dense = c.n_layers - n_moe
    ring_all = c.ring_local and c.attn_pattern == "swa"

    def run_stack(x, stack, layer_cache, n, offset, moe_layer):
        flags = _is_local_flags(c, n, offset)
        for i, (layer_p, flag) in enumerate(zip(_unstack(stack), flags)):
            x = _layer(layer_p, x, c, positions, flag, moe_layer,
                       cache=_layer_cache(layer_cache, i),
                       cache_len=cache_len, ring=ring_all)
        return x

    if _paired(c):
        # (local, global) pairs: local layers use ring window caches.
        layers = _unstack(params["dense_layers"])
        for i in range(c.n_layers // 2):
            x = _layer(layers[2 * i], x, c, positions, True, False,
                       cache=_layer_cache(cache["dense_local"], i),
                       cache_len=cache_len, ring=True)
            x = _layer(layers[2 * i + 1], x, c, positions, False, False,
                       cache=_layer_cache(cache["dense_global"], i),
                       cache_len=cache_len)
    else:
        if n_dense:
            x = run_stack(x, params["dense_layers"], cache["dense"],
                          n_dense, 0, False)
        if n_moe:
            x = run_stack(x, params["moe_layers"], cache["moe"], n_moe,
                          n_dense, True)
    x = rms_norm(x, params["final_ln"], c.norm_eps)
    logits = _softcap(_mm(x[:, -1], params["lm_head"]), c.final_softcap)
    return logits, cache
