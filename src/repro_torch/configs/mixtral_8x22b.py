"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768 — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

The port of `repro.configs.mixtral_8x22b`, with the same values
and torch dtypes.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "mixtral-8x22b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=16384, vocab=32768,
        attn_pattern="swa", window=4096,
        moe=True, n_experts=8, n_shared_experts=0, top_k=2,
        d_ff_expert=16384, first_k_dense=0,
        act="silu", gated=True, rope_theta=1000000.0, dtype=torch.bfloat16)


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=128, vocab=512,
        attn_pattern="swa", window=8,
        moe=True, n_experts=4, n_shared_experts=0, top_k=2, d_ff_expert=64,
        act="silu", gated=True, dtype=torch.float32,
        q_chunk=16, kv_chunk=16, loss_chunk=16)
