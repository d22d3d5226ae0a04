"""The port's MIND (`repro_torch.models.mind`) against `repro.models.mind`.

On the reduced config, weights made by `repro` and carried across by
`convert`, and one batch of 32 users with 20 % of the history masked,
the same numpy inputs go through both packages. Tolerances (float32,
reductions in another order): `extract_interests`, `serve_scores` and
`retrieval_scores` at atol 1e-6; the loss at rtol 1e-5; the gradients of
the three params at atol 1e-6; the params after 8 train steps
(`make_generic_train_step`, lr 3e-3) at atol 2e-5. Also the reference's
smoke test on the port, the `jnp.take` index rule in the forward pass
and the gradient, `materialize` bit for bit, the torch init's shapes and
statistics, and `F.cross_entropy` against the literal loss.
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
from repro.models import mind as jmind
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert as cv
from repro_torch.configs import common as tcommon
from repro_torch.data import synthetic as tsyn
from repro_torch.gather import take_rows
from repro_torch.models import mind as tmind
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

B = 32
MASKED = 0.2
STEPS = 8
LR = 3e-3
KEYS = ("bilinear", "item_embed", "out_proj")


def _configs():
    return (jcommon.get_arch("mind").reduced_config(),
            tcommon.get_arch("mind").reduced_config())


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs on one set of inputs, and those inputs as
    numpy arrays."""
    jcfg, _ = _configs()
    params = jmind.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batch = {
        "hist": rng.integers(0, jcfg.n_items, (B, jcfg.hist_len))
        .astype(np.int32),
        "hist_mask": rng.random((B, jcfg.hist_len)) >= MASKED,
        "target": rng.integers(0, jcfg.n_items, B).astype(np.int32),
    }
    serve = {"hist": batch["hist"], "hist_mask": batch["hist_mask"],
             "cands": rng.integers(0, jcfg.n_items, (B, 11))
             .astype(np.int32)}
    retr = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
            "cands": rng.integers(0, jcfg.n_items, 333).astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.value_and_grad(jmind.train_loss)(params, jb, jcfg)
    opt = jopt.AdamWConfig(lr=LR)
    step = jax.jit(jts.make_generic_train_step(
        lambda p, b: jmind.train_loss(p, b, jcfg), opt))
    state = jts.init_train_state(params, opt)
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, jb)
        losses.append(float(aux["loss"]))
    out = {
        "interests": jmind.extract_interests(params, jb["hist"],
                                             jb["hist_mask"], jcfg),
        "serve": jmind.serve_scores(params, jax.tree.map(jnp.asarray, serve),
                                    jcfg),
        "retrieval": jmind.retrieval_scores(
            params, jax.tree.map(jnp.asarray, retr), jcfg),
    }
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=np_(params), batch=batch, serve=serve, retr=retr,
                loss=float(loss), grads=np_(grads), losses=losses,
                stepped=np_(state["params"]), out=np_(out))


def _port(ref):
    _, cfg = _configs()
    return (cfg, cv.params_from_numpy(ref["params"], device="cpu"),
            *(cv.params_from_numpy(ref[k], device="cpu")
              for k in ("batch", "serve", "retr")))


def test_masked_history_is_a_fifth(ref):
    frac = 1 - ref["batch"]["hist_mask"].mean()
    assert 0.1 < frac < 0.3


@pytest.mark.parametrize("what", ["interests", "serve", "retrieval"])
def test_forward_matches_reference(ref, what):
    cfg, params, batch, serve, retr = _port(ref)
    got = {"interests": lambda: tmind.extract_interests(
               params, batch["hist"], batch["hist_mask"], cfg),
           "serve": lambda: tmind.serve_scores(params, serve, cfg),
           "retrieval": lambda: tmind.retrieval_scores(params, retr, cfg),
           }[what]()
    want = ref["out"][what]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_loss_and_grads_match_reference(ref):
    cfg, params, batch, _, _ = _port(ref)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = tmind.train_loss(leaves, batch, cfg)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, [leaves[k] for k in KEYS])
    for k, g in zip(KEYS, grads):
        np.testing.assert_allclose(g.numpy(), ref["grads"][k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_train_steps_match_reference(ref):
    cfg, params, batch, _, _ = _port(ref)
    opt = topt.AdamWConfig(lr=LR)
    step = tts.make_generic_train_step(
        lambda p, b: tmind.train_loss(p, b, cfg), opt)
    state = tts.init_train_state(params, opt)
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(state["params"][k].numpy(),
                                   ref["stepped"][k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert int(state["opt"]["step"]) == STEPS


def test_cross_entropy_equals_literal_form(ref):
    """`train_loss`'s `F.cross_entropy` against the reference's literal
    mean(logsumexp − gold), value and gradients, on the same logits."""
    cfg, params, batch, _, _ = _port(ref)

    def literal(p):
        interests = tmind.extract_interests(p, batch["hist"],
                                            batch["hist_mask"], cfg)
        tgt = take_rows(p["item_embed"], batch["target"])
        user = tmind.label_aware_user_vec(interests, tgt)
        logits = tmind._contract("bd,cd->bc", user, tgt) / cfg.temperature
        gold = torch.take_along_dim(
            logits, torch.arange(B)[:, None], dim=-1)[:, 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - gold)

    out = {}
    for form, fn in ((False, lambda p: tmind.train_loss(p, batch, cfg)),
                     (True, literal)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        val = fn(p)
        out[form] = (val.detach(),
                     torch.autograd.grad(val, [p[k] for k in KEYS]))
    np.testing.assert_allclose(float(out[False][0]), float(out[True][0]),
                               rtol=1e-6)
    for k, a, b in zip(KEYS, out[False][1], out[True][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_take_rule_forward_and_gradient():
    """`jnp.take`'s rule: -N ≤ idx < 0 wraps, any other index outside
    [0, N) gives a NaN row and no gradient; the port's gather agrees in
    the forward pass and in the table's gradient."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(5, 3)).astype(np.float32)
    idx = np.array([[-5, -1, 0, 4], [5, -6, 7, 2]], np.int32)
    w = rng.normal(size=idx.shape + (3,)).astype(np.float32)
    want = np.asarray(jnp.take(jnp.asarray(table), idx, axis=0))
    got = take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[1, :3]).all() and not np.isnan(want[0]).any()
    jg = jax.grad(lambda t: jnp.nansum(jnp.take(t, idx, axis=0) * w))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.nansum(
        take_rows(t, torch.from_numpy(idx)) * torch.from_numpy(w)), [t])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    # The NaN entries' clamped rows (4, 0, 4) get only the in-range
    # entries' gradient: rows 0 and 4 from the wrapped and direct indices
    # of the first bag, row 2 from the last entry.
    want_g = np.zeros_like(table)
    want_g[0] = w[0, 0] + w[0, 2]
    want_g[4] = w[0, 1] + w[0, 3]
    want_g[2] = w[1, 3]
    np.testing.assert_allclose(tg.numpy(), want_g, rtol=1e-6, atol=1e-7)


def test_out_of_range_candidate_scores_nan_as_the_reference(ref):
    cfg, params, _, serve, _ = _port(ref)
    jcfg, _ = _configs()
    cands = ref["serve"]["cands"].copy()
    cands[3, 4] = cfg.n_items + 2
    cands[5, 0] = -1
    want = np.asarray(jmind.serve_scores(
        jax.tree.map(jnp.asarray, ref["params"]),
        jax.tree.map(jnp.asarray, {**ref["serve"], "cands": cands}), jcfg))
    got = tmind.serve_scores(params, {**serve,
                                      "cands": torch.from_numpy(cands)}, cfg)
    assert np.isnan(want[3, 4]) and np.isnan(want).sum() == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


#: One layout with every kind `materialize` knows, in both packages' dtypes.
EVERY_KIND = [("tok", (3, 5), "int32", "tokens:97"),
              ("ids", (4,), "int32", "ids:1000"),
              ("mask", (2, 3), "bool", "bool"),
              ("pos", (6, 3), "float32", "pos"),
              ("ang", (5,), "float32", "angle"),
              ("z", (2, 2), "float32", "zeros"),
              ("x", (3, 4), "float32", "float")]


def _layouts(layout):
    if layout == "every_kind":
        return ({k: (shape, getattr(jnp, dt), kind)
                 for k, shape, dt, kind in EVERY_KIND},
                {k: (shape, getattr(torch, dt), kind)
                 for k, shape, dt, kind in EVERY_KIND})
    args = {"train": (64, 50, 10_485_760), "serve": (16, 50, 10_485_760, 7),
            "retrieval": (50, 10_485_760, 1000)}[layout]
    fn = f"mind_{layout}_layout"
    return getattr(jsyn, fn)(*args), getattr(tsyn, fn)(*args)


@pytest.mark.parametrize("layout", ["train", "serve", "retrieval",
                                    "every_kind"])
def test_materialize_matches_reference(layout):
    jlay, tlay = _layouts(layout)
    assert list(jlay) == list(tlay)
    for k in jlay:
        assert jlay[k][0] == tlay[k][0] and jlay[k][2] == tlay[k][2]
    want = jsyn.materialize(jlay, seed=11)
    got = tsyn.materialize(tlay, seed=11, device="cpu")
    for k in jlay:
        w = np.asarray(want[k])
        assert got[k].dtype == tlay[k][1] and got[k].numpy().dtype == w.dtype
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_config_and_shapes_match_reference():
    for fn in ("model_config", "reduced_config"):
        j = dataclasses.asdict(getattr(jcommon.get_arch("mind"), fn)())
        t = dataclasses.asdict(getattr(tcommon.get_arch("mind"), fn)())
        assert j.pop("dtype") == jnp.float32 and \
            t.pop("dtype") == torch.float32 and j == t
        jshapes = jmind.param_shapes(getattr(jcommon.get_arch("mind"), fn)())
        tshapes = tmind.param_shapes(getattr(tcommon.get_arch("mind"), fn)())
        assert {k: v.shape for k, v in jshapes.items()} == \
            {k: v[0] for k, v in tshapes.items()}
    jmod, tmod = jcommon.get_arch("mind"), tcommon.get_arch("mind")
    for attr in ("ARCH_ID", "FAMILY", "SHAPES"):
        assert getattr(jmod, attr) == getattr(tmod, attr)
    assert tcommon.MIND_SHAPES == jcommon.MIND_SHAPES


def test_init_shapes_and_statistics():
    """The torch init (the reference's PRNG stream cannot be copied):
    shapes and dtypes of `param_shapes`, the table N(0, 0.1²) within 1 %,
    the square matrices' std 1/√d within 5 %, the same generator seed
    the same params."""
    cfg = tmind.MindConfig(name="stats", n_items=20_000, embed_dim=64)
    params = tmind.init_params(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    for k, (shape, dtype) in tmind.param_shapes(cfg).items():
        assert params[k].shape == shape and params[k].dtype == dtype
    emb = params["item_embed"].double()
    assert abs(float(emb.mean())) < 0.001
    assert abs(float(emb.std()) - 0.1) < 0.001
    for k in ("bilinear", "out_proj"):
        assert abs(float(params[k].double().std()) - 1 / 8) < 0.05 / 8
    again = tmind.init_params(cfg, generator=torch.Generator()
                              .manual_seed(0), device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_mind_smoke_train_and_serve():
    """`tests/test_models_smoke.py::test_mind_smoke_train_and_serve` on
    the port, with the port's own init."""
    _, cfg = _configs()
    params = tmind.init_params(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "hist": torch.from_numpy(rng.integers(0, cfg.n_items,
                                              (32, cfg.hist_len))
                                 .astype(np.int32)),
        "hist_mask": torch.ones((32, cfg.hist_len), dtype=torch.bool),
        "target": torch.from_numpy(rng.integers(0, cfg.n_items, 32)
                                   .astype(np.int32)),
    }
    opt = topt.AdamWConfig(lr=3e-3)
    step = tts.make_generic_train_step(
        lambda p, b: tmind.train_loss(p, b, cfg), opt)
    state = tts.init_train_state(params, opt)
    losses = []
    for _ in range(8):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0]

    interests = tmind.extract_interests(state["params"], batch["hist"],
                                        batch["hist_mask"], cfg)
    assert interests.shape == (32, cfg.n_interests, cfg.embed_dim)
    sb = {"hist": batch["hist"], "hist_mask": batch["hist_mask"],
          "cands": torch.from_numpy(rng.integers(0, cfg.n_items, (32, 11))
                                    .astype(np.int32))}
    assert tmind.serve_scores(state["params"], sb, cfg).shape == (32, 11)
    rb = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
          "cands": torch.from_numpy(rng.integers(0, cfg.n_items, 333)
                                    .astype(np.int32))}
    assert tmind.retrieval_scores(state["params"], rb, cfg).shape == \
        (1, 333)
