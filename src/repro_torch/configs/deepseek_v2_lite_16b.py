"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed experts top-6
[arXiv:2405.04434; hf].

Spec note (also in DESIGN.md): the assignment line says both "MoE 64e
top-6" and "160 routed"; 160 routed is full V2 — we follow the primary
64-routed spec matching the HF v2-lite card. First layer is a dense FFN
(first_k_dense_replace=1), dense d_ff=10944.

The port of `repro.configs.deepseek_v2_lite_16b`, with the same values
and torch dtypes.
"""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-v2-lite-16b"
FAMILY = "lm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=10944, vocab=102400,
        attn_pattern="full",
        use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        moe=True, n_experts=64, n_shared_experts=2, top_k=6,
        d_ff_expert=1408, first_k_dense=1,
        act="silu", gated=True, rope_theta=10000.0, dtype=torch.bfloat16)


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, attn_pattern="full",
        use_mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        moe=True, n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=32,
        first_k_dense=1, act="silu", gated=True, dtype=torch.float32,
        q_chunk=16, kv_chunk=16, loss_chunk=16)
