"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

The port of `repro.configs.gemma2_9b`, with the same values
and torch dtypes.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma2-9b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_head=256, d_ff=14336, vocab=256000,
        attn_pattern="local_global", window=4096,
        attn_softcap=50.0, final_softcap=30.0, act="gelu", gated=True,
        rope_theta=10000.0, dtype=torch.bfloat16)


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        attn_pattern="local_global", window=8, attn_softcap=50.0,
        final_softcap=30.0, act="gelu", gated=True, dtype=torch.float32,
        q_chunk=16, kv_chunk=16, loss_chunk=16)
