"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].

The port of `repro.configs.granite_8b`, with the same values
and torch dtypes.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "granite-8b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=14336, vocab=49152,
        attn_pattern="full", act="silu", gated=True,
        rope_theta=10000.0, dtype=torch.bfloat16)


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=160, vocab=512, attn_pattern="full",
        act="silu", gated=True, dtype=torch.float32,
        q_chunk=16, kv_chunk=16, loss_chunk=16)
