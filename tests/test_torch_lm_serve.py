"""The port's LM serving path (`transformer.cache_shapes`, `decode_step`,
`train/serve_step.py`) against `repro`'s.

On each LM's `reduced_config()`, params made by `repro` and carried
across by `convert`:
- `cache_shapes` (with and without `ring_local`) equal the reference's;
- a prefill of 16 tokens and 4 single-token steps through `decode_step`
  on both sides (the reference's jitted once per arch), at the default
  capacity factor: logits at atol 1e-5 × their largest |value| and the
  whole cache after at atol 1e-5 (float32 sums in another order);
- the reference's own tests on the port: teacher-forced decode against
  the forward logits (rtol = atol = 2e-3, the capacity factor raised to
  16 so that no token drops, as the reference does), the ring-buffer
  window cache against the full-length one for gemma2 and mixtral
  (2e-3) and against the reference's ring decode (1e-5), and greedy
  generation (deterministic; at least 0.75 agreeing with the forward
  argmax, the reference's bound);
- greedy `generate` gives the reference's tokens; sampling (a
  `torch.Generator`, not JAX's PRNG) gives tokens in [0, vocab), the
  same for the same seed.
One case runs gemma2's reduced config (local and global layers,
softcaps) in bfloat16 on both sides: the logits of the prefill and 2
steps within 2^-6 of their largest |value| (a few bfloat16 roundings,
2^-9 each). (The reference's bfloat16 decode of the MoE archs does not
run on JAX's CPU backend: "Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32".)
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.models import transformer as jtfm
from repro.train import serve_step as jss
from repro_torch import convert as cv
from repro_torch.configs import common as tcommon
from repro_torch.models import transformer as tfm
from repro_torch.train import serve_step as tss
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["gemma2-9b", "minitron-4b", "granite-8b", "deepseek-v2-lite-16b",
         "mixtral-8x22b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _setup(arch, seed, **changes):
    jc = dataclasses.replace(jcommon.get_arch(arch).reduced_config(),
                             **changes)
    tc = dataclasses.replace(tcommon.get_arch(arch).reduced_config(),
                             **{k: DTYPES.get(v, v) if k == "dtype" else v
                                for k, v in changes.items()})
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, cv.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def _ref_decode(jc, jp, toks, steps, max_len):
    """The reference's prefill of toks[:, :16] then `steps` single-token
    steps: (logits [steps + 1, B, V], final cache)."""
    dec = jax.jit(lambda p, c, t, n: jtfm.decode_step(p, c, t, n, jc))
    cache = jss.make_cache(jc, toks.shape[0], max_len)
    out = []
    logits, cache = dec(jp, cache, toks[:, :16], jnp.int32(0))
    out.append(np.asarray(logits.astype(jnp.float32)))
    for i in range(steps):
        logits, cache = dec(jp, cache, toks[:, 16 + i:17 + i],
                            jnp.int32(16 + i))
        out.append(np.asarray(logits.astype(jnp.float32)))
    return np.stack(out), cache


def _port_decode(tc, tp, toks, steps, max_len):
    cache = tss.make_cache(tc, toks.shape[0], max_len, device="cpu")
    t = torch.from_numpy(toks)
    prefill, decode = tss.make_prefill_step(tc), tss.make_decode_step(tc)
    logits, cache = prefill(tp, cache, t[:, :16])
    out = [logits.float()]
    for i in range(steps):
        logits, cache = decode(tp, cache, t[:, 16 + i:17 + i], 16 + i)
        out.append(logits.float())
    return torch.stack(out).numpy(), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_reference(arch):
    for ring in (False, True):
        for full in (False, True):
            mod = "model_config" if full else "reduced_config"
            jc = dataclasses.replace(
                getattr(jcommon.get_arch(arch), mod)(), ring_local=ring)
            tc = dataclasses.replace(
                getattr(tcommon.get_arch(arch), mod)(), ring_local=ring)
            js, ts = jtfm.cache_shapes(jc, 3, 1024), \
                tfm.cache_shapes(tc, 3, 1024)
            assert jax.tree_util.tree_structure(js) == \
                jax.tree_util.tree_structure(tree_map(lambda t: 0, ts))
            for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
                assert tuple(a.shape) == tuple(b.shape) and b.is_meta
                assert DTYPES[a.dtype.type] == b.dtype
    tc = tcommon.get_arch(arch).reduced_config()
    cache = tss.make_cache(tc, 2, 32, device="cpu")
    assert all(not t.any() and t.device.type == "cpu"
               for t in tree_leaves(cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    jc, tc, jp, tp = _setup(arch, 5)
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 20)).astype(
        np.int32)
    want, jcache = _ref_decode(jc, jp, toks, 4, 32)
    got, tcache = _port_decode(tc, tp, toks, 4, 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for a, b in zip(jax.tree_util.tree_leaves(jcache), tree_leaves(tcache)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_decode_step_matches_reference_in_bfloat16():
    jc, tc, jp, tp = _setup("gemma2-9b", 6, dtype=jnp.bfloat16)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(6).integers(0, jc.vocab, (2, 18)).astype(
        np.int32)
    want, _ = _ref_decode(jc, jp, toks, 2, 32)
    got, tcache = _port_decode(tc, tp, toks, 2, 32)
    assert tcache["dense"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_matches_prefill(arch):
    """Teacher-forced decode reproduces the forward logits (the
    reference's test, on the port)."""
    _, tc, _, tp = _setup(arch, 1, capacity_factor=16.0)
    s = 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (2, s)).astype(np.int32))
    with torch.no_grad():
        full = tfm.forward(tp, toks, tc)
    cache = tss.make_cache(tc, 2, s + 16, device="cpu")
    got = torch.stack([tfm.decode_step(tp, cache, toks[:, i:i + 1], i, tc)[0]
                       for i in range(s)], 1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x22b"])
def test_ring_cache_decode_matches_full(arch):
    """The ring-buffer window cache equals the full-length cache decode
    (24 steps > window 8, so the ring wraps), and the reference's ring
    decode."""
    jc, tc, jp, tp = _setup(arch, 2, capacity_factor=16.0)
    s = 24
    toks = np.random.default_rng(2).integers(0, tc.vocab, (2, s)).astype(
        np.int32)
    t = torch.from_numpy(toks)

    def roll(c):
        cache = tss.make_cache(c, 2, 32, device="cpu")
        return torch.stack([tfm.decode_step(tp, cache, t[:, i:i + 1], i,
                                            c)[0] for i in range(s)], 1)

    ring_cfg = dataclasses.replace(tc, ring_local=True)
    full, ring = roll(tc), roll(ring_cfg)
    np.testing.assert_allclose(ring.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    jring = dataclasses.replace(jc, ring_local=True)
    dec = jax.jit(lambda p, c, x, n: jtfm.decode_step(p, c, x, n, jring))
    cache = jss.make_cache(jring, 2, 32)
    want = []
    for i in range(s):
        logits, cache = dec(jp, cache, toks[:, i:i + 1], jnp.int32(i))
        want.append(np.asarray(logits))
    want = np.stack(want, 1)
    np.testing.assert_allclose(ring.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_generate_loop():
    """Greedy generation is deterministic and agrees with the forward
    pass (the reference's test, on the port), and gives the reference's
    tokens."""
    jc, tc, jp, tp = _setup("granite-8b", 3)
    prompt = np.random.default_rng(3).integers(0, tc.vocab, (2, 8)).astype(
        np.int32)
    out1 = tss.generate(tp, tc, torch.from_numpy(prompt), n_new=6,
                        temperature=0.0)
    out2 = tss.generate(tp, tc, torch.from_numpy(prompt), n_new=6,
                        temperature=0.0)
    assert out1.shape == (2, 14) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)
    with torch.no_grad():
        full_logits = tfm.forward(tp, out1[:, :-1], tc)
    greedy = torch.argmax(full_logits[:, 7:], dim=-1)
    agree = float((greedy == out1[:, 8:]).float().mean())
    assert agree >= 0.75, f"greedy/forward agreement too low: {agree}"
    want = jss.generate(jp, jc, jnp.asarray(prompt), n_new=6,
                        temperature=0.0)
    np.testing.assert_array_equal(out1.numpy(), np.asarray(want))


def test_sampling_properties():
    _, tc, _, tp = _setup("gemma2-9b", 4)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (3, 8)).astype(np.int32))
    a = tss.generate(tp, tc, prompt, n_new=10, temperature=1.0, seed=7)
    b = tss.generate(tp, tc, prompt, n_new=10, temperature=1.0, seed=7)
    c = tss.generate(tp, tc, prompt, n_new=10, temperature=1.0, seed=8)
    assert a.shape == (3, 18) and torch.equal(a[:, :8], prompt)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tc.vocab
