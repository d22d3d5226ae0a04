"""The port's LM training (`make_lm_train_step`, `adamw_update_`,
`train_state_shapes`, `launch/train.py`) against `repro`'s.

On each LM's `reduced_config()`, params made by `repro` and carried
across by `convert`, the reference's smoke batch (tokens = targets,
[2, 32] from `default_rng(0)`), 6 train steps at lr 3e-3 on both sides
(the reference's step jitted once): every loss at rtol 1e-5 (float32;
the trajectories agree to ≈ 1e-7), falling as the reference's smoke
test asks, and the params after 6 steps at rtol 2e-4 / atol 2.5·lr, the
bound of the reference's `test_microbatch_equals_full_batch` (Adam's
normalised step moves a parameter by up to ≈ lr when a rounding flips a
near-zero gradient's sign), with at most 1e-3 of the elements further
than 1e-4 apart. The reference's microbatch test on the port (its own
tolerances), and the port's microbatched step against the reference's
(losses rtol 1e-5; first-step m and v at the reference test's atol 1e-7
and 1e-9). The reference's resume test on the port, through the port's
checkpoint manager (a nested train state), held to the uninterrupted
run at rtol 1e-6 as the reference holds it (the port's equal bit for
bit). `synth_lm_batch` and the LM layouts' `materialize` equal the
reference's bit for bit; the driver resumes from its newest checkpoint,
and `--full` refuses a config that does not fit. `adamw_update` leaves
its inputs as they were, and `adamw_update_` gives its bits in place. One
case trains minitron's reduced config in bfloat16 on both sides for 3
steps: losses at rtol 2^-7 (a few bfloat16 roundings of a loss near
6.5; 1.6e-4 measured on the first).
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
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert as cv
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["gemma2-9b", "minitron-4b", "granite-8b", "deepseek-v2-lite-16b",
         "mixtral-8x22b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.int32: torch.int32}


def _setup(arch, seed=0, **changes):
    jc = dataclasses.replace(jcommon.get_arch(arch).reduced_config(),
                             **changes)
    tc = dataclasses.replace(tcommon.get_arch(arch).reduced_config(),
                             **{k: DTYPES.get(v, v) if k == "dtype" else v
                                for k, v in changes.items()})
    return jc, tc, jtfm.init_params(jax.random.PRNGKey(seed), jc)


def _carry(jp):
    return cv.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(toks):
    return ({"tokens": toks, "targets": toks},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(toks)})


def _close_params(got, want, lr):
    flat_g = np.concatenate([t.float().numpy().ravel()
                             for t in tree_leaves(got)])
    flat_w = np.concatenate([np.asarray(a, np.float32).ravel()
                             for a in jax.tree_util.tree_leaves(want)])
    np.testing.assert_allclose(flat_g, flat_w, rtol=2e-4, atol=2.5 * lr)
    assert np.mean(np.abs(flat_g - flat_w) > 1e-4) <= 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_steps_match_reference(arch):
    """The reference's smoke test on the port (6 steps at lr 3e-3, the
    loss falls), held step by step to the reference's."""
    jc, tc, jp = _setup(arch)
    opt_j, opt_t = jopt.AdamWConfig(lr=3e-3), topt.AdamWConfig(lr=3e-3)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 32)).astype(
        np.int32)
    jb, tb = _batch(toks)
    jstep = jax.jit(jts.make_lm_train_step(jc, opt_j))
    tstep = tts.make_lm_train_step(tc, opt_t)
    js = jts.init_train_state(jp, opt_j)
    ts = tts.init_train_state(_carry(jp), opt_t)
    with torch.no_grad():
        logits = tfm.forward(ts["params"], tb["tokens"], tc)
    assert logits.shape == (2, 32, tc.vocab)
    assert bool(torch.isfinite(logits).all())
    jl, tl = [], []
    for _ in range(6):
        js, ja = jstep(js, jb)
        ts, ta = tstep(ts, tb)
        jl.append(float(ja["loss"]))
        tl.append(float(ta["loss"]))
    assert all(np.isfinite(tl))
    assert tl[-1] < tl[0], f"loss did not decrease: {tl}"
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert int(ts["opt"]["step"]) == 6
    _close_params(ts["params"], js["params"], opt_t.lr)


def test_microbatch_equals_full_batch():
    """The reference's test on the port, with its tolerances, and the
    port's microbatched step against the reference's."""
    jc, tc, jp = _setup("granite-8b")
    opt_t, opt_j = topt.AdamWConfig(lr=1e-3), jopt.AdamWConfig(lr=1e-3)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (4, 32)).astype(
        np.int32)
    jb, tb = _batch(toks)
    s_full = tts.init_train_state(_carry(jp), opt_t)
    s_micro = tts.init_train_state(_carry(jp), opt_t)
    s_full, aux_f = tts.make_lm_train_step(tc, opt_t)(s_full, tb)
    s_micro, aux_m = tts.make_lm_train_step(tc, opt_t, microbatch=2)(
        s_micro, tb)
    np.testing.assert_allclose(float(aux_f["loss"]), float(aux_m["loss"]),
                               rtol=1e-5)
    for key, atol in (("m", 1e-7), ("v", 1e-9)):
        for a, b in zip(tree_leaves(s_full["opt"][key]),
                        tree_leaves(s_micro["opt"][key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                       atol=atol)
    for a, b in zip(tree_leaves(s_full["params"]),
                    tree_leaves(s_micro["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2.5 * opt_t.lr)
    js = jax.jit(jts.make_lm_train_step(jc, opt_j, microbatch=2))(
        jts.init_train_state(jp, opt_j), jb)
    np.testing.assert_allclose(float(aux_m["loss"]), float(js[1]["loss"]),
                               rtol=1e-5)
    for key, atol in (("m", 1e-7), ("v", 1e-9)):
        for a, b in zip(tree_leaves(s_micro["opt"][key]),
                        jax.tree_util.tree_leaves(js[0]["opt"][key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                       atol=atol)
    _close_params(s_micro["params"], js[0]["params"], opt_t.lr)


def test_train_driver_resume(tmp_path):
    """Kill-and-restart determinism (the reference's test, on the port):
    3 steps, a checkpoint of the nested train state, a restore into a
    fresh state, 3 more steps equal 6 uninterrupted ones."""
    jc, tc, jp = _setup("minitron-4b")
    opt = topt.AdamWConfig(lr=1e-3)
    step_fn = tts.make_lm_train_step(tc, opt)

    def batch(step):
        return ttrain.synth_lm_batch(step, 2, 16, tc.vocab, device="cpu")

    state_a = tts.init_train_state(_carry(jp), opt)
    for step in range(6):
        state_a, aux_a = step_fn(state_a, batch(step))
    d = str(tmp_path / "ck")
    state_b = tts.init_train_state(_carry(jp), opt)
    for step in range(3):
        state_b, _ = step_fn(state_b, batch(step))
    tckpt.save(d, 3, state_b)
    del state_b
    state_b, start = tckpt.restore(
        d, tts.init_train_state(_carry(jp), opt), device="cpu")
    assert start == 3 and int(state_b["opt"]["step"]) == 3
    for step in range(start, 6):
        state_b, aux_b = step_fn(state_b, batch(step))
    np.testing.assert_allclose(float(aux_a["loss"]), float(aux_b["loss"]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(state_a), tree_leaves(state_b)):
        assert torch.equal(a, b)


def test_synth_lm_batch_bit_for_bit():
    for step in (0, 3, 11):
        want = jtrain.synth_lm_batch(step, 3, 17, 1000)
        got = ttrain.synth_lm_batch(step, 3, 17, 1000, device="cpu")
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lm_layouts_match_reference():
    """The LM layouts name the reference's shapes, dtypes and kinds, and
    `materialize` draws the reference's tokens bit for bit."""
    for name, args in (("lm_train_layout", (3, 17, 1000)),
                       ("lm_decode_layout", (5, 1000)),
                       ("lm_prefill_layout", (2, 33, 1000))):
        want = getattr(jsyn, name)(*args)
        got = getattr(tsyn, name)(*args)
        assert list(got) == list(want)
        for k, (shape, dtype, kind) in want.items():
            assert got[k] == (shape, DTYPES[dtype], kind)
        jb = jsyn.materialize(want, seed=4)
        tb = tsyn.materialize(got, seed=4, device="cpu")
        for k in want:
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_train_main_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--arch", "granite-8b", "--batch", "2", "--seq", "16",
            "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]
    ttrain.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "fresh start" in out and tckpt.latest_step(d) == 4
    ttrain.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and tckpt.latest_step(d) == 6
    assert "step     5 loss" in out and "step     0" not in out
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", "mixtral-8x22b", "--full", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "x")])
    assert e.value.code == 2
    assert "does not fit" in capsys.readouterr().out


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_train_state_shapes_match_reference(compress):
    jc = jcommon.get_arch("deepseek-v2-lite-16b").model_config()
    tc = tcommon.get_arch("deepseek-v2-lite-16b").model_config()
    want = jts.train_state_shapes(jtfm.param_shapes(jc),
                                  jopt.AdamWConfig(compress=compress))
    got = tts.train_state_shapes(tfm.param_shapes(tc),
                                 topt.AdamWConfig(compress=compress))
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(tree_map(lambda t: 0, got))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(a.shape) == tuple(b.shape) and b.is_meta
        assert DTYPES[a.dtype.type] == b.dtype


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_adamw_update_in_place_equals_functional(compress, monkeypatch):
    """`adamw_update` leaves its inputs as they were; `adamw_update_`
    writes the same bits into the state's tensors, in slices
    (`INPLACE_SLICE` cut to 7 elements here)."""
    monkeypatch.setattr(topt, "INPLACE_SLICE", 7)
    rng = np.random.default_rng(8)
    params = {"a": torch.from_numpy(rng.normal(size=(5, 6)).astype(
        np.float32)).to(torch.bfloat16),
              "b": [torch.from_numpy(rng.normal(size=(9,)).astype(
                  np.float32))]}
    grads = tree_map(lambda p: torch.from_numpy(rng.normal(
        size=tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
    cfg = topt.AdamWConfig(lr=1e-2, compress=compress)
    state = topt.init_opt_state(params, cfg)
    before = tree_map(torch.clone, [params, state])
    p1, s1 = topt.adamw_update(params, grads, state, cfg)
    p2, s2 = topt.adamw_update(p1, grads, s1, cfg)
    for a, b in zip(tree_leaves([params, state]), tree_leaves(before)):
        assert torch.equal(a, b)
    ip = tree_map(torch.clone, params)
    ist = tree_map(torch.clone, state)
    keep = tree_leaves(ip)
    for _ in range(2):
        ip, ist = topt.adamw_update_(ip, grads, ist, cfg)
    assert all(a is b for a, b in zip(tree_leaves(ip), keep))
    for a, b in zip(tree_leaves([ip, ist]), tree_leaves([p2, s2])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_lm_train_steps_match_reference_in_bfloat16():
    jc, tc, jp = _setup("minitron-4b", dtype=jnp.bfloat16)
    opt_j, opt_t = jopt.AdamWConfig(lr=3e-3), topt.AdamWConfig(lr=3e-3)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 32)).astype(
        np.int32)
    jb, tb = _batch(toks)
    jstep = jax.jit(jts.make_lm_train_step(jc, opt_j))
    tstep = tts.make_lm_train_step(tc, opt_t)
    js = jts.init_train_state(jp, opt_j)
    ts = tts.init_train_state(_carry(jp), opt_t)
    assert ts["params"]["embed"].dtype == torch.bfloat16
    for _ in range(3):
        js, ja = jstep(js, jb)
        ts, ta = tstep(ts, tb)
        np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]),
                                   rtol=2 ** -7)
    assert ts["params"]["embed"].dtype == torch.bfloat16
