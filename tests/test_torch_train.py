"""The port's optimiser and generic train step against `repro.train`.

Mirrors `tests/test_train_infra.py`'s optimiser tests on the port, then
holds `adamw_update` (with and without int8 error feedback) and the
generic train step to the reference on the same numpy inputs: params, m,
v and ef at rtol 1e-6 and atol 1e-7 (float32 arithmetic in the same
order, reductions in another), the int8 codes and the step equal.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert as cv
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import (AdamWConfig, _global_norm,
                                         adamw_update, init_opt_state)
from repro_torch.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-6, 1e-7


def _t(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    """Every leaf of the port's tree `got` against the reference's `want`
    (same structure, leaves in sorted-key order)."""
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


# --- the reference's optimiser tests, on the port ---------------------------

def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"x": _t([3.0, -2.0])}
    state = init_opt_state(params, cfg)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}
        params, state = adamw_update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.05


def test_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-6, weight_decay=0.0)
    params = {"x": torch.ones(4)}
    state = init_opt_state(params, cfg)
    huge = {"x": torch.full((4,), 1e9)}
    new_params, _ = adamw_update(params, huge, state, cfg)
    # clipped grad → first-step Adam update magnitude ≈ lr, never 1e9-scaled
    assert float((new_params["x"] - params["x"]).abs().max()) < 2.0


def test_int8_ef_compression_still_converges():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, compress="int8_ef")
    params = {"x": _t([3.0, -2.0, 1.5])}
    state = init_opt_state(params, cfg)
    assert "ef" in state
    for _ in range(300):
        grads = {"x": 2 * params["x"]}
        params, state = adamw_update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.1


def test_error_feedback_accumulates_residual():
    cfg = AdamWConfig(compress="int8_ef")
    params = {"x": torch.ones(8)}
    state = init_opt_state(params, cfg)
    # tiny + one huge component: int8 quantization of the tiny components
    # underflows, residual must be carried
    grads = {"x": _t([1e-6] * 7 + [1.0])}
    _, new_state = adamw_update(params, grads, state, cfg)
    assert float(new_state["ef"]["x"].abs().max()) > 0


# --- the port against the reference -----------------------------------------

def test_config_defaults_match_reference():
    assert dataclasses.asdict(AdamWConfig()) == \
        dataclasses.asdict(jopt.AdamWConfig())


def _nested(rng) -> dict:
    """A nested params-like tree of float32 numpy arrays."""
    return {"embed": rng.normal(size=(7, 5)).astype(np.float32),
            "block": {"w": rng.normal(size=(5, 5)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32),
                      "inner": {"s": np.float32(rng.normal())}}}


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_init_opt_state_layout(compress):
    params = cv.params_from_numpy(_nested(np.random.default_rng(0)),
                                  device="cpu")
    state = init_opt_state(params, AdamWConfig(compress=compress))
    want = jopt.init_opt_state(jax.tree.map(jnp.asarray, _nested(
        np.random.default_rng(0))), jopt.AdamWConfig(compress=compress))
    assert sorted(state) == sorted(want)
    for key in set(state) - {"step"}:
        assert jax.tree_util.tree_structure(
            tree_map(lambda t: 0, state[key])) == \
            jax.tree_util.tree_structure(jax.tree.map(lambda t: 0,
                                                      want[key]))
        for t, p in zip(tree_leaves(state[key]), tree_leaves(params)):
            assert t.dtype == torch.float32 and t.shape == p.shape
            assert not t.any()
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


def _update_case(compress, seed=0):
    """Params, grads (norm > 1, so the clip binds) and a state after 3
    steps (nonzero m, v, ef) as numpy trees."""
    rng = np.random.default_rng(seed)
    params = _nested(rng)
    grads = tree_map(lambda a: (rng.normal(size=a.shape) * 10.0 ** rng
                                .integers(-6, 1, size=a.shape))
                     .astype(np.float32), params)
    state = {"m": tree_map(lambda a: (rng.normal(size=a.shape) * 0.01)
                           .astype(np.float32), params),
             "v": tree_map(lambda a: (rng.random(size=a.shape) * 1e-4)
                           .astype(np.float32), params),
             "step": np.int32(3)}
    if compress == "int8_ef":
        state["ef"] = tree_map(lambda a: (rng.normal(size=a.shape) * 1e-3)
                               .astype(np.float32), params)
    return params, grads, state


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_adamw_update_matches_reference(compress):
    params, grads, state = _update_case(compress)
    assert float(_global_norm(cv.params_from_numpy(grads, device="cpu"))) > 1
    want_p, want_s = jopt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state),
        jopt.AdamWConfig(lr=1e-2, compress=compress))
    tp = cv.params_from_numpy(params, device="cpu")
    tg = cv.params_from_numpy(grads, device="cpu")
    ts = cv.params_from_numpy(state, device="cpu")
    before = cv.params_to_numpy({"p": tp, "g": tg, "s": ts})
    got_p, got_s = adamw_update(tp, tg, ts,
                                AdamWConfig(lr=1e-2, compress=compress))
    _close(got_p, want_p)
    for key in ("m", "v") + (("ef",) if compress else ()):
        _close(got_s[key], want_s[key])
    assert sorted(got_s) == sorted(want_s)
    assert got_s["step"].dtype == torch.int32 and int(got_s["step"]) == 4
    # The inputs are left as they were.
    after = cv.params_to_numpy({"p": tp, "g": tg, "s": ts})
    for a, b in zip(tree_leaves(before), tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


def test_int8_codes_match_reference():
    """The port's int8 codes are the reference's, element for element:
    its dequantised grads over its scale round back to them exactly."""
    params, grads, state = _update_case("int8_ef", seed=1)
    jdeq, _ = jopt._quantize_int8_ef(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, state["ef"]))
    tdeq, _ = topt._quantize_int8_ef(
        cv.params_from_numpy(grads, device="cpu"),
        cv.params_from_numpy(state["ef"], device="cpu"))
    for g, e, jd, td in zip(tree_leaves(grads), tree_leaves(state["ef"]),
                            jax.tree_util.tree_leaves(jdeq),
                            tree_leaves(tdeq)):
        gf = torch.tensor(g) + torch.tensor(e)
        q, scale = topt._int8_codes(gf)
        want = np.rint(np.asarray(jd) / scale.numpy())
        np.testing.assert_array_equal(q.numpy().astype(np.float64), want)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_global_norm_matches_reference():
    _, grads, _ = _update_case(None, seed=2)
    np.testing.assert_allclose(
        float(_global_norm(cv.params_from_numpy(grads, device="cpu"))),
        float(jopt._global_norm(jax.tree.map(jnp.asarray, grads))),
        rtol=RTOL)


def _loss_np(params, batch, xp):
    """A small nested-params regression loss; `b2` is unused, so its
    gradient is zeros."""
    h = xp.tanh(batch["x"] @ params["l1"]["w"] + params["l1"]["b"])
    return xp.mean((h @ params["l2"]["w"] - batch["y"]) ** 2)


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_generic_train_step_matches_reference(compress):
    rng = np.random.default_rng(3)
    params = {"l1": {"w": rng.normal(size=(6, 8)).astype(np.float32),
                     "b": rng.normal(size=(8,)).astype(np.float32)},
              "l2": {"w": rng.normal(size=(8, 2)).astype(np.float32),
                     "b2": rng.normal(size=(2,)).astype(np.float32)}}
    batch = {"x": rng.normal(size=(16, 6)).astype(np.float32),
             "y": rng.normal(size=(16, 2)).astype(np.float32)}
    jcfg = jopt.AdamWConfig(lr=1e-2, compress=compress)
    jstep = jax.jit(jts.make_generic_train_step(
        lambda p, b: _loss_np(p, b, jnp), jcfg))
    js = jts.init_train_state(jax.tree.map(jnp.asarray, params), jcfg)
    tcfg = AdamWConfig(lr=1e-2, compress=compress)
    tstep = tts.make_generic_train_step(
        lambda p, b: _loss_np(p, b, torch), tcfg)
    ts = cv.train_state_from_numpy(
        cv.params_to_numpy(tts.init_train_state(
            cv.params_from_numpy(params, device="cpu"), tcfg)),
        device="cpu")
    tb = cv.params_from_numpy(batch, device="cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    for _ in range(3):
        js, jaux = jstep(js, jb)
        ts, taux = tstep(ts, tb)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
    # Three steps: a few float32 roundings of the gradient apart.
    _close(ts["params"], js["params"], rtol=1e-5, atol=1e-6)
    assert not ts["opt"]["m"]["l2"]["b2"].any()
    assert int(ts["opt"]["step"]) == 3


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_train_state_round_trips_through_convert(compress):
    """A JAX train state, pulled to numpy, runs in the port and comes
    back with its layout and dtypes."""
    jcfg = jopt.AdamWConfig(compress=compress)
    js = jts.init_train_state(jax.tree.map(jnp.asarray, _nested(
        np.random.default_rng(4))), jcfg)
    js = {"params": js["params"], "opt": {**js["opt"],
                                          "step": jnp.int32(5)}}
    ts = cv.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                   device="cpu")
    assert ts["opt"]["step"].dtype == torch.int32 and \
        int(ts["opt"]["step"]) == 5
    back = cv.train_state_to_numpy(ts)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(js)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="a train state is"):
        cv.train_state_from_numpy({"params": {}, "opt": {"m": {}}},
                                  device="cpu")


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_train_step_frees_its_gradients_without_the_collector(
        compress, monkeypatch):
    """A step's gradients die with the step: no reference cycle keeps
    them (at full width each table gradient is 2.68 GB) until the
    garbage collector runs."""
    import gc
    import weakref
    cfg = AdamWConfig(compress=compress)
    seen = []
    real = topt.adamw_update

    def spy(params, grads, state, c):
        seen.append(weakref.ref(grads["a"]["w"]))
        return real(params, grads, state, c)
    monkeypatch.setattr(topt, "adamw_update", spy)
    step = tts.make_generic_train_step(
        lambda p, b: (p["a"]["w"] ** 2).sum() + p["b"].sum(), cfg)
    state = tts.init_train_state({"a": {"w": torch.ones(64, 64)},
                                  "b": torch.ones(3)}, cfg)
    gc.disable()
    try:
        for _ in range(3):
            state, _ = step(state, None)
        assert [r() is None for r in seen] == [True] * 3
    finally:
        gc.enable()
