"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron (squared-ReLU MLP, ungated)
[arXiv:2407.14679; hf].

The port of `repro.configs.minitron_4b`, with the same values
and torch dtypes.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "minitron-4b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_head=128, d_ff=9216, vocab=256000,
        attn_pattern="full", act="relu2", gated=False,
        rope_theta=10000.0, dtype=torch.bfloat16)


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=48, n_heads=6,
        n_kv_heads=2, d_head=8, d_ff=96, vocab=512, attn_pattern="full",
        act="relu2", gated=False, dtype=torch.float32,
        q_chunk=16, kv_chunk=16, loss_chunk=16)
