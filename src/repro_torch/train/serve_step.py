"""Serving-step factories: prefill, decode, and a sampling generate loop.

The port of `repro.train.serve_step`: build a cache, prefill the prompt
(a `decode_step` at cache length 0), then step the decoder. The steps
are plain functions (no `jit`); each writes its cache in place and
returns it, as `transformer.decode_step` does.

Greedy decoding (`temperature <= 0`) gives the reference's tokens.
Sampling draws from a `torch.Generator` seeded by `seed` on the prompt's
device: the reference's JAX PRNG stream cannot be reproduced, so the
same seed gives the same tokens here, not the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map


def make_cache(cfg, batch: int, max_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """A zero cache of `cache_shapes(cfg, batch, max_len)`, on the GPU
    unless `device` says otherwise."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=dev),
                    tfm.cache_shapes(cfg, batch, max_len))


def make_prefill_step(cfg) -> Callable:
    """(params, cache, tokens[B,S]) → (last-token logits [B,V], cache)."""
    def prefill(params, cache, tokens):
        return tfm.decode_step(params, cache, tokens, 0, cfg)
    return prefill


def make_decode_step(cfg) -> Callable:
    """(params, cache, token[B,1], cache_len) → (logits [B,V], cache)."""
    def decode(params, cache, token, cache_len):
        return tfm.decode_step(params, cache, token, cache_len, cfg)
    return decode


@torch.no_grad()
def generate(params, cfg, prompt: torch.Tensor, n_new: int,
             temperature: float = 1.0, seed: int = 0,
             max_len: int | None = None) -> torch.Tensor:
    """Batched autoregressive sampling. prompt [B, S] → [B, S + n_new],
    int32, on the prompt's device (the params' device)."""
    b, s = prompt.shape
    max_len = max_len or (s + n_new + 8)
    # cache length must align with the attention kv-chunking
    max_len = -(-max_len // cfg.kv_chunk) * cfg.kv_chunk
    cache = make_cache(cfg, b, max_len, device=prompt.device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    logits, cache = prefill(params, cache, prompt)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=prompt.device).manual_seed(seed)
    out = [prompt.to(torch.int32)]
    for i in range(n_new):
        if temperature <= 0:
            tok = torch.argmax(logits, dim=-1)[:, None]
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        tok = tok.to(torch.int32)
        out.append(tok)
        if i < n_new - 1:
            logits, cache = decode(params, cache, tok, s + i)
    return torch.cat(out, dim=1)
