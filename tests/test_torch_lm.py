"""The port's transformer LMs (`repro_torch.models.transformer`, `.moe`)
against `repro.models.transformer` and `repro.models.moe`.

For each of the five LM archs, on its `reduced_config()`, params made by
`repro` and carried across by `convert`, and the reference smoke test's
tokens ([2, 32] from `default_rng(0)`), the same inputs go through both
packages. Tolerances (float32, sums in another order; the reference's
side is jitted once per arch in a module fixture):
- the configs, `params_count`, `param_shapes` and `LM_SHAPES` equal;
- logits at rtol 1e-5 / atol 1e-5, the chunked loss at rtol 1e-6;
- every gradient leaf at atol 1e-5 × the leaf's largest |value|;
- `chunked_attention` at atol 1e-6 (local windows, softcaps, decode
  offsets with rows whose early kv chunks are all masked, which the
  port skips and the reference fills with exp(0) terms it later erases);
- `moe_ffn` with drops (capacity factor 1.25, drops asserted) and
  without (16.0), outputs and gradients at atol 1e-5 × the tensor's
  largest |value|; `load_balance_loss` at rtol 1e-6; top-k ties
  to the lower expert id, as `lax.top_k`.
One case runs gemma2's reduced config in bfloat16 on both sides (params
carried across as bfloat16 bits; the reference's bfloat16 MoE archs do
not run on JAX's CPU backend, "Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32"): logits within 2^-6 of their
largest |value| (a few bfloat16 roundings, 2^-9 each, of activations
whose largest |value| is near that of the logits), the loss at rtol
2^-8, each bfloat16 gradient within 2^-5 of the leaf's largest |value|
(1.5e-2 measured: the backward pass rounds about twice as often).
The torch init is checked by its tree and statistics.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import convert as cv
from repro_torch.configs import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["gemma2-9b", "minitron-4b", "granite-8b", "deepseek-v2-lite-16b",
         "mixtral-8x22b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _configs(arch):
    return (jcommon.get_arch(arch).reduced_config(),
            tcommon.get_arch(arch).reduced_config())


def _carry(jparams):
    return cv.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _grads(params, tokens, cfg):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = tfm.chunked_loss(leaves, tokens, tokens, cfg)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """(arch, port config, port params, tokens, the reference's logits,
    loss and gradients), the reference jitted once."""
    arch = request.param
    jc, tc = _configs(arch)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 32)).astype(
        np.int32)

    @jax.jit
    def run(p, t):
        loss, g = jax.value_and_grad(
            lambda q: jtfm.chunked_loss(q, t, t, jc))(p)
        return jtfm.forward(p, t, jc), loss, g
    logits, loss, grads = run(jp, toks)
    return (arch, tc, _carry(jp), torch.from_numpy(toks), np.asarray(logits),
            float(loss), [np.asarray(g) for g in
                          jax.tree_util.tree_leaves(grads)])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    jc, tc = _configs(arch)
    for full in (False, True):
        if full:
            jc = jcommon.get_arch(arch).model_config()
            tc = tcommon.get_arch(arch).model_config()
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert DTYPES[jd.pop("dtype")] == td.pop("dtype")
        assert jd == td
        assert tc.params_count == jc.params_count
        assert tc.active_params_count == jc.active_params_count
        js, ts = jtfm.param_shapes(jc), tfm.param_shapes(tc)
        assert jax.tree_util.tree_structure(js) == \
            jax.tree_util.tree_structure(tree_map(lambda t: 0, ts))
        for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
            assert tuple(a.shape) == tuple(b.shape) and b.is_meta
            assert DTYPES[a.dtype.type] == b.dtype
    mod = tcommon.get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == (
        jcommon.get_arch(arch).ARCH_ID, "lm",
        jcommon.get_arch(arch).SHAPES)
    assert tcommon.LM_SHAPES == jcommon.LM_SHAPES


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-lite-16b",
                                  "mixtral-8x22b"])
def test_init_statistics(arch):
    """The torch init: the reference's tree, dtypes and distributions
    (every leaf of rank >= 2, stacked norms [L, d] included: mean 0, std
    1/sqrt(shape[-2]); rank 1: ones), mean and std checked on leaves of
    at least 1,000 elements."""
    _, tc = _configs(arch)
    p = tfm.init_params(tc, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    shapes = tfm.param_shapes(tc)
    for t, s in zip(tree_leaves(p), tree_leaves(shapes)):
        assert t.shape == s.shape and t.dtype == s.dtype
        if t.dim() < 2:
            assert bool((t == 1).all())
            continue
        if t.numel() < 1000:
            continue
        std = 1 / np.sqrt(t.shape[-2])
        assert abs(float(t.float().std()) / std - 1) < 0.1
        assert abs(float(t.float().mean())) < 5 * std / np.sqrt(t.numel())
    again = tfm.init_params(tc, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))


def test_forward_loss_grads_match_reference(ref):
    arch, tc, params, toks, logits, loss, grads = ref
    with torch.no_grad():
        got = tfm.forward(params, toks, tc)
    np.testing.assert_allclose(got.numpy(), logits, rtol=1e-5, atol=1e-5)
    tloss, tgrads = _grads(params, toks, tc)
    np.testing.assert_allclose(float(tloss), loss, rtol=1e-6)
    assert len(tgrads) == len(grads)
    for g, want in zip(tgrads, grads):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_forward_loss_grads_match_reference_in_bfloat16():
    jc, tc = _configs("gemma2-9b")
    jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
    tp = _carry(jp)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 32)).astype(
        np.int32)

    @jax.jit
    def run(p, t):
        loss, g = jax.value_and_grad(
            lambda q: jtfm.chunked_loss(q, t, t, jc))(p)
        return jtfm.forward(p, t, jc).astype(jnp.float32), loss, g
    want, wloss, wgrads = run(jp, toks)
    want = np.asarray(want)
    with torch.no_grad():
        got = tfm.forward(tp, torch.from_numpy(toks), tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())
    loss, grads = _grads(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=2 ** -8)
    for g, p, w in zip(grads, tree_leaves(tp),
                       jax.tree_util.tree_leaves(wgrads)):
        assert g.dtype == p.dtype   # bfloat16 but for the float32 norms
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2 ** -5 * np.abs(w).max())


ATTN_CASES = [
    # (sq, skv, q_offset, kv_len_valid, is_local, softcap, chunks, groups)
    (16, 16, 0, None, False, None, (4, 4), 2),
    (16, 16, 0, None, True, 50.0, (4, 4), 1),     # window 6 < chunk rows
    (32, 32, 0, None, True, None, (8, 4), 4),
    (2, 32, 13, 15, False, None, (2, 8), 2),      # decode, cache 32
    (3, 48, 20, 23, True, 30.0, (1, 8), 2),       # early chunks masked
    (1, 64, 40, 41, True, None, (1, 16), 1),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches_reference(case):
    sq, skv, off, valid, local, cap, (cq, ckv), g = case
    jc, tc = _configs("granite-8b")
    jc = dataclasses.replace(jc, q_chunk=cq, kv_chunk=ckv, window=6,
                             attn_softcap=cap)
    tc = dataclasses.replace(tc, q_chunk=cq, kv_chunk=ckv, window=6,
                             attn_softcap=cap)
    rng = np.random.default_rng(sq * 100 + skv)
    b, kvh, d = 2, 2, 8
    q = rng.normal(size=(b, sq, kvh * g, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, d)).astype(np.float32)
    want = jtfm.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(off), jc,
        jnp.asarray(local),
        None if valid is None else jnp.full((b,), valid, jnp.int32))
    got = tfm.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), off, tc, local, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _moe_inputs(arch, cf, t):
    jc, tc = _configs(arch)
    jc = dataclasses.replace(jc, capacity_factor=cf)
    tc = dataclasses.replace(tc, capacity_factor=cf)
    jp = jax.tree.map(lambda a: a[0], jtfm.init_params(
        jax.random.PRNGKey(4), jc)["moe_layers"])
    rng = np.random.default_rng(4)
    # A direction shared by every token skews the routing toward a few
    # experts, so the default capacity drops pairs.
    x = (rng.normal(size=(2, t // 2, jc.d_model))
         + 2.0 * rng.normal(size=jc.d_model)).astype(np.float32)
    return jc, tc, jp, x


@pytest.mark.parametrize("arch,cf", [("deepseek-v2-lite-16b", 1.25),
                                     ("deepseek-v2-lite-16b", 16.0),
                                     ("mixtral-8x22b", 1.25)])
def test_moe_matches_reference_with_and_without_drops(arch, cf):
    """1,024 tokens (two dispatch groups of 512); at the default capacity
    factor some (token, k) pairs are dropped, at 16 none."""
    jc, tc, jp, x = _moe_inputs(arch, cf, 1024)
    names = sorted(jp)

    @jax.jit
    def run(p, x):
        def f(p, x):
            return jnp.sum(jmoe.moe_ffn(p, x, jc) * jnp.cos(x))
        return jmoe.moe_ffn(p, x, jc), jax.grad(f, (0, 1))(p, x)
    want, (gp, gx) = run(jp, x)
    tp = _carry(jp)
    leaves = {k: tp[k].requires_grad_(True) for k in names}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tmoe.moe_ffn(leaves, tx, tc)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    grads = torch.autograd.grad(torch.sum(got * torch.cos(tx)),
                                [leaves[k] for k in names] + [tx],
                                allow_unused=True, materialize_grads=True)
    for g, w in zip(grads, [gp[k] for k in names] + [gx]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    # Drops, counted from the routing: a (token, k) pair past its
    # expert's capacity in its group of 512.
    _, ids = tmoe.route(tp, torch.from_numpy(x).reshape(2, 512, -1), tc)
    cap = max(int(512 * tc.top_k / tc.n_experts * cf), 4)
    load = torch.stack([torch.bincount(i.reshape(-1), minlength=tc.n_experts)
                        for i in ids])
    dropped = int((load - cap).clamp_min(0).sum())
    assert (dropped > 0) == (cf < 2), (dropped, cap)


def test_load_balance_loss_and_top_k_ties():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 6)).astype(np.float32)
    idx = rng.integers(0, 6, (3, 7, 2)).astype(np.int32)
    np.testing.assert_allclose(
        float(tmoe.load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(idx), 6)),
        float(jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                     6)), rtol=1e-6)
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.3], [0.25, 0.25, 0.25, 0.25,
                                                  0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
