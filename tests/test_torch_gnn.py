"""The port's GNN family (`repro_torch.models.gnn`) against `repro.models.gnn`.

For each arch, on its `reduced_config()`, params made by `repro` and
carried across by `convert`, and the reference smoke test's batch
(`coherent_gnn_batch(arch, n_nodes=60, avg_deg=4, n_graphs=4)`, no graphs
for GraphCast) as numpy, the same inputs go through both packages.
Tolerances (float32, sums in another order):
- forward at rtol 1e-5 / atol 1e-5; the loss at rtol 1e-5;
- every gradient leaf at atol 1e-5 × the leaf's largest |value| (the
  leaves span six orders of magnitude; `mix0` of MACE is unused and its
  gradient is 0 in both);
- 8 generic train steps at lr 1e-3: losses at rtol 1e-5, params at
  atol 2e-5.
Also the reference smoke test and MACE's rotation check (rtol = atol =
1e-4, the reference's) on the port's own init; the torch init against the
reference's tree, leaf for leaf in JAX's order, and its statistics;
GraphCast's `dec` a copy of `enc`, not the same tensors; the configs and
`GNN_SHAPES`; `materialize(gnn_layout(...))` and `coherent_gnn_batch` bit
for bit; the `x[idx]` rule of `index_rows` and the drop rule of the
segment ops against JAX, gradients included; a GraphCast train state
with 16 `proc` layers through `tree` and `convert`, with one
`adamw_update` on its list params held to the reference (rtol 1e-6,
atol 1e-7, as `tests/test_torch_train.py`); and GraphCast's full config
on a cut of `minibatch_lg`'s layout, whose loss rises at lr 1e-3 in both
packages (first loss at rtol 1e-5, the 8 losses at rtol 1e-2).
A float64 config computes in float64: on each arch's reduced config it
is held to the reference's float32 at the same forward and gradient
tolerances; on GraphCast's full config at that cut its float32 gradients
lie more than 1e-5 and at most 1e-3 of a leaf's largest |value| from the
float64 recomputation (9.9e-5 measured on the CPU): the 16 layers amplify
float32 rounding, the reason chip_smoke holds GraphCast's gradients at
1e-3.
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
from repro.graphs import segment as jseg
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert as cv
from repro_torch.configs import common as tcommon
from repro_torch.data import synthetic as tsyn
from repro_torch.gather import index_rows
from repro_torch.graphs import segment as tseg
from repro_torch.models import gnn as tgnn
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = ["schnet", "dimenet", "mace", "graphcast"]
N_NODES = 60
STEPS = 8
LR = 1e-3
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5          # × the leaf's largest |value|
PARAM_ATOL = 2e-5


def _configs(arch):
    return (jcommon.get_arch(arch).reduced_config(),
            tcommon.get_arch(arch).reduced_config())


def _n_graphs(arch):
    return 4 if arch != "graphcast" else None


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The reference's outputs for one arch, and its inputs as numpy."""
    arch = request.param
    jcfg, _ = _configs(arch)
    batch = jsyn.coherent_gnn_batch(arch, n_nodes=N_NODES, avg_deg=4,
                                    d_feat=jcfg.d_in, d_out=jcfg.d_out,
                                    n_graphs=_n_graphs(arch))
    params = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    out = jgnn.forward(params, batch, jcfg)
    loss, grads = jax.value_and_grad(jgnn.loss_fn)(params, batch, jcfg)
    opt = jopt.AdamWConfig(lr=LR)
    step = jax.jit(jts.make_generic_train_step(
        lambda p, b: jgnn.loss_fn(p, b, jcfg), opt))
    state = jts.init_train_state(params, opt)
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    return dict(arch=arch, params=_np(params), batch=_np(batch),
                out=np.asarray(out), loss=float(loss), grads=_np(grads),
                losses=losses, stepped=_np(state["params"]))


def _port(ref):
    _, cfg = _configs(ref["arch"])
    return (cfg, cv.params_from_numpy(ref["params"], device="cpu"),
            cv.params_from_numpy(ref["batch"], device="cpu"))


# --- parity with the reference ----------------------------------------------

def test_forward_and_loss_match_reference(ref):
    cfg, params, batch = _port(ref)
    out = tgnn.forward(params, batch, cfg)
    assert out.dtype == torch.float32 and out.shape == ref["out"].shape
    np.testing.assert_allclose(out.numpy(), ref["out"], **FWD_TOL)
    loss = tgnn.loss_fn(params, batch, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


def test_grads_match_reference(ref):
    cfg, params, batch = _port(ref)
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss = tgnn.loss_fn(leaves, batch, cfg)
    got = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                              materialize_grads=True)
    want = jax.tree_util.tree_leaves(ref["grads"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=str(i))


def _loss_grads(params, batch, cfg):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = tgnn.loss_fn(leaves, batch, cfg)
    return loss.detach(), torch.autograd.grad(
        loss, tree_leaves(leaves), allow_unused=True, materialize_grads=True)


def _float64(cfg, params, batch):
    return (dataclasses.replace(cfg, dtype=torch.float64),
            tree_map(torch.Tensor.double, params),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()})


def test_float64_recomputation_matches_reference(ref):
    cfg, params, batch = _float64(*_port(ref))
    out = tgnn.forward(params, batch, cfg)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref["out"], **FWD_TOL)
    loss, got = _loss_grads(params, batch, cfg)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    want = jax.tree_util.tree_leaves(ref["grads"])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=str(i))


def test_train_steps_match_reference(ref):
    cfg, params, batch = _port(ref)
    opt = topt.AdamWConfig(lr=LR)
    step = tts.make_generic_train_step(
        lambda p, b: tgnn.loss_fn(p, b, cfg), opt)
    state = tts.init_train_state(params, opt)
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = tree_leaves(state["params"])
    want = jax.tree_util.tree_leaves(ref["stepped"])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(i))
    assert int(state["opt"]["step"]) == STEPS


# --- the reference's smoke tests, on the port's own init ---------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_smoke_train(arch):
    _, cfg = _configs(arch)
    batch = tsyn.coherent_gnn_batch(
        cfg.arch, n_nodes=N_NODES, avg_deg=4, d_feat=cfg.d_in,
        d_out=cfg.d_out, n_graphs=_n_graphs(arch), device="cpu")
    params = tgnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    out = tgnn.forward(params, batch, cfg)
    assert out.shape[0] == N_NODES and out.shape[-1] == cfg.d_out
    assert bool(torch.all(torch.isfinite(out)))

    opt = topt.AdamWConfig(lr=LR)
    step = tts.make_generic_train_step(
        lambda p, b: tgnn.loss_fn(p, b, cfg), opt)
    state = tts.init_train_state(params, opt)
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"{arch} loss did not decrease: {losses}"


def test_mace_rotation_equivariance():
    """Scalar outputs are invariant to a global rotation of positions."""
    _, cfg = _configs("mace")
    batch = tsyn.coherent_gnn_batch("mace", n_nodes=40, avg_deg=4,
                                    d_feat=cfg.d_in, d_out=cfg.d_out,
                                    n_graphs=4, device="cpu")
    params = tgnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    out1 = tgnn.forward(params, batch, cfg)
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    batch2 = dict(batch)
    batch2["positions"] = batch["positions"] @ torch.from_numpy(
        q.astype(np.float32))
    out2 = tgnn.forward(params, batch2, cfg)
    np.testing.assert_allclose(out1.detach().numpy(), out2.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


# --- the torch init ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_and_statistics(arch):
    """The full config's tree, leaf for leaf in JAX's order; weights
    N(0, 1/fan_in), biases 0."""
    jcfg = jcommon.get_arch(arch).model_config()
    cfg = tcommon.get_arch(arch).model_config()
    want = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: jgnn.init_params(jax.random.PRNGKey(0), jcfg)))
    params = tgnn.init_params(cfg, generator=torch.Generator().manual_seed(1),
                              device="cpu")
    got = tree_leaves(params)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    assert jax.tree_util.tree_structure(cv.params_to_numpy(params)) == \
        jax.tree_util.tree_structure(jax.eval_shape(
            lambda: jgnn.init_params(jax.random.PRNGKey(0), jcfg)))
    z = []
    for g in got:
        if g.dim() == 1:
            assert not g.any()                   # biases
        else:
            fan_in = g.shape[-1] if g.dim() == 3 else g.shape[0]
            z.append(g.flatten() * fan_in ** 0.5)
    z = torch.cat(z)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01


def test_graphcast_dec_starts_as_a_copy_of_enc():
    cfg = tcommon.get_arch("graphcast").reduced_config()
    params = tgnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    enc, dec = tree_leaves(params["enc"]), tree_leaves(params["dec"])
    assert len(enc) == len(dec) == 8
    for a, b in zip(enc, dec):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    batch = tsyn.coherent_gnn_batch("graphcast", N_NODES, 4, cfg.d_in,
                                    cfg.d_out, device="cpu")
    opt = topt.AdamWConfig(lr=LR)
    step = tts.make_generic_train_step(
        lambda p, b: tgnn.loss_fn(p, b, cfg), opt)
    state, _ = step(tts.init_train_state(params, opt), batch)
    new = state["params"]
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new["enc"]), tree_leaves(new["dec"])))


# --- configs, shapes and data ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    jmod, tmod = jcommon.get_arch(arch), tcommon.get_arch(arch)
    assert (tmod.ARCH_ID, tmod.FAMILY, tmod.SHAPES) == \
        (jmod.ARCH_ID, jmod.FAMILY, jmod.SHAPES)
    for fn in ("model_config", "reduced_config"):
        got = dataclasses.asdict(getattr(tmod, fn)())
        want = dataclasses.asdict(getattr(jmod, fn)())
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want


def test_gnn_shapes_match_reference():
    assert tcommon.GNN_SHAPES == jcommon.GNN_SHAPES


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("graphs", [None, 3])
def test_gnn_layout_and_materialize_bit_for_bit(arch, graphs):
    args = (arch, 64, 200, 7, 2)
    kw = dict(n_graphs=graphs, tri_cap=300 if arch == "dimenet" else None)
    want = jsyn.gnn_layout(*args, **kw)
    got = tsyn.gnn_layout(*args, **kw)
    assert list(got) == list(want)
    for k in want:
        (ws, wd, wk), (gs, gd, gk) = want[k], got[k]
        assert (gs, gk) == (ws, wk) and gd == _TORCH_DTYPE[np.dtype(wd)], k
    jb = jsyn.materialize(want, seed=5)
    tb = tsyn.materialize(got, seed=5, device="cpu")
    assert list(tb) == list(jb)
    for k in jb:
        assert tb[k].dtype == _TORCH_DTYPE[np.asarray(jb[k]).dtype], k
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("graphs", [None, 4])
def test_coherent_gnn_batch_bit_for_bit(arch, graphs):
    for n_nodes, deg, seed in ((N_NODES, 4, 0), (37, 3, 7), (3, 1, 2)):
        jb = jsyn.coherent_gnn_batch(arch, n_nodes, deg, 5, 2, seed=seed,
                                     n_graphs=graphs)
        tb = tsyn.coherent_gnn_batch(arch, n_nodes, deg, 5, 2, seed=seed,
                                     n_graphs=graphs, device="cpu")
        assert list(tb) == list(jb)
        for k in jb:
            w = np.asarray(jb[k])
            assert tb[k].dtype == _TORCH_DTYPE[w.dtype], k
            np.testing.assert_array_equal(tb[k].numpy(), w, err_msg=k)


# --- the index and segment rules ---------------------------------------------

IDS = np.array([-1, -6, 5, 7, 2, 0, -5, 4, 4, -9], np.int32)


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_index_rows_follows_jax_indexing(trailing):
    """Forward: wrap -N ≤ i < 0, clamp the rest. Backward: only ids in
    range after the wrap scatter."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5,) + trailing).astype(np.float32)
    cot = rng.normal(size=IDS.shape + trailing).astype(np.float32)
    want = np.asarray(jnp.asarray(x)[IDS])
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(a[IDS] * cot))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = index_rows(xt, torch.from_numpy(IDS))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)
    ids2 = torch.from_numpy(IDS.reshape(2, 5).astype(np.int64))
    assert index_rows(xt, ids2).shape == (2, 5) + trailing


@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops_drop_out_of_range_ids_as_jax(masked):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(IDS.shape[0], 2)).astype(np.float32)
    mask = rng.random(IDS.shape[0]) < 0.7 if masked else \
        np.ones(IDS.shape[0], bool)
    cot = rng.normal(size=(4, 2)).astype(np.float32)
    jm = jnp.asarray(mask)
    want = np.asarray(jseg.masked_segment_sum(jnp.asarray(data), IDS, 4, jm))
    want_g = np.asarray(jax.grad(lambda d: jnp.sum(
        jseg.masked_segment_sum(d, IDS, 4, jm) * cot))(jnp.asarray(data)))
    dt = torch.from_numpy(data).requires_grad_(True)
    ids, tm = torch.from_numpy(IDS), torch.from_numpy(mask)
    got = tseg.masked_segment_sum(dt, ids, 4, tm)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), dt)
    np.testing.assert_array_equal(g.numpy(), want_g)
    mean = tseg.masked_segment_mean(dt, ids, 4, tm)
    np.testing.assert_allclose(
        mean.detach().numpy(),
        np.asarray(jseg.masked_segment_mean(jnp.asarray(data), IDS, 4, jm)),
        rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad((mean * torch.from_numpy(cot)).sum(), dt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(
        lambda d: jnp.sum(jseg.masked_segment_mean(d, IDS, 4, jm) * cot))(
        jnp.asarray(data))), rtol=1e-6, atol=1e-7)
    for col in range(2):
        np.testing.assert_array_equal(
            tseg.masked_segment_max(dt[:, col].detach(), ids, 4, tm,
                                    -3.0).numpy(),
            np.asarray(jseg.masked_segment_max(
                jnp.asarray(data[:, col]), IDS, 4, jm, jnp.float32(-3.0))))
    assert tseg.masked_segment_sum(dt, ids, 4, None).shape == (4, 2)


def test_edge_relax_sweep_matches_reference():
    rng = np.random.default_rng(2)
    n, e = 9, 30
    keys = rng.integers(0, 50, (3, n)).astype(np.int32)
    keys[:, 0] = 1 << 20
    src = rng.integers(-n, n + 3, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    inf = 1 << 20
    want = np.stack([np.asarray(jseg.edge_relax_sweep(
        jnp.asarray(k), src, dst, jnp.asarray(mask), 2, n, jnp.int32(inf)))
        for k in keys])
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask), 2, n, inf)
    np.testing.assert_array_equal(
        tseg.edge_relax_sweep(torch.from_numpy(keys), *args).numpy(), want)
    np.testing.assert_array_equal(
        tseg.edge_relax_sweep(torch.from_numpy(keys[1]), *args).numpy(),
        want[1])


# --- list params through tree, convert and the optimiser ---------------------

def test_tree_keeps_tuples_as_leaves_and_lists_in_index_order():
    tree = {"b": [torch.tensor(float(i)) for i in range(12)],
            "a": {"x": torch.tensor(-1.0)}}
    assert [float(x) for x in tree_leaves(tree)] == [-1.0] + list(range(12))
    pairs = tree_map(lambda t: (t, t + 1), tree)
    assert isinstance(pairs["b"][3], tuple)
    firsts = tree_map(lambda t: t[0], pairs)
    assert [float(x) for x in tree_leaves(firsts)] == \
        [float(x) for x in tree_leaves(tree)]
    back = tree_unflatten(tree, tree_leaves(tree))
    assert back["b"][10] is tree["b"][10]


def test_graphcast_train_state_round_trips_and_adamw_matches_reference():
    """16 `proc` layers (so "10" would sort before "2" if lists were keyed
    by strings): JAX's leaf order, the round trip, and one AdamW update
    on the list params against the reference's."""
    jcfg, _ = _configs("graphcast")
    jcfg = dataclasses.replace(jcfg, n_process_layers=16)
    params = jgnn.init_params(jax.random.PRNGKey(3), jcfg)
    grads = jax.tree.map(lambda p: jnp.sin(p * 7.0 + 1.0), params)
    opt = jopt.AdamWConfig(lr=LR)
    state = jts.init_train_state(params, opt)
    new_p, new_opt = jopt.adamw_update(params, grads, state["opt"], opt)
    jstate = _np({"params": params, "opt": state["opt"]})

    port = cv.train_state_from_numpy(jstate, device="cpu")
    assert isinstance(port["params"]["proc"], list)
    assert len(port["params"]["proc"]) == 16
    got = [x.numpy() for x in tree_leaves(port)]
    want = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = cv.train_state_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jstate)

    tg = cv.params_from_numpy(_np(grads), device="cpu")
    t_p, t_opt = topt.adamw_update(port["params"], tg, port["opt"],
                                   topt.AdamWConfig(lr=LR))
    for got_t, want_t in ((t_p, new_p), (t_opt["m"], new_opt["m"]),
                          (t_opt["v"], new_opt["v"])):
        gl, wl = tree_leaves(got_t), jax.tree_util.tree_leaves(want_t)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert int(t_opt["step"]) == int(new_opt["step"]) == 1


def test_graphcast_full_width_diverges_as_reference():
    """GraphCast's full config (16 layers of width 512) on a cut of
    `minibatch_lg`'s random layout (1,200 nodes, 2,000 edges, d_in 12):
    outputs of ≈ 1e6 at init, and 8 AdamW steps at lr 1e-3 drive the loss
    up, in the reference as in the port (first loss at rtol 1e-5, the
    rest at 1e-2: the growth amplifies rounding)."""
    jcfg = dataclasses.replace(
        jcommon.get_arch("graphcast").model_config(), d_in=12)
    cfg = dataclasses.replace(
        tcommon.get_arch("graphcast").model_config(), d_in=12)
    layout = jsyn.gnn_layout("graphcast", 1200, 2000, 12, jcfg.d_out)
    batch = jsyn.materialize(layout, seed=0)
    params = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jopt.AdamWConfig(lr=LR)
    step = jax.jit(jts.make_generic_train_step(
        lambda p, b: jgnn.loss_fn(p, b, jcfg), opt))
    state, want = jts.init_train_state(params, opt), []
    for _ in range(STEPS):
        state, aux = step(state, batch)
        want.append(float(aux["loss"]))
    tstep = tts.make_generic_train_step(
        lambda p, b: tgnn.loss_fn(p, b, cfg), topt.AdamWConfig(lr=LR))
    tstate = tts.init_train_state(
        cv.params_from_numpy(_np(params), device="cpu"),
        topt.AdamWConfig(lr=LR))
    tbatch = cv.params_from_numpy(_np(batch), device="cpu")
    got = []
    for _ in range(STEPS):
        tstate, aux = tstep(tstate, tbatch)
        got.append(float(aux["loss"]))
    assert want[0] > 1e12 and want[-1] > 1e6 * want[0]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_graphcast_full_width_float32_rounding():
    """GraphCast's full config on the cut of the test above: its float32
    gradients lie more than 1e-5 (the reduced configs' limit) and at most
    1e-3 of a leaf's largest |value| from the float64 recomputation; the
    loss agrees at rtol 1e-5."""
    cfg = dataclasses.replace(
        tcommon.get_arch("graphcast").model_config(), d_in=12)
    batch = tsyn.materialize(
        tsyn.gnn_layout("graphcast", 1200, 2000, 12, cfg.d_out), seed=0,
        device="cpu")
    params = tgnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    loss32, g32 = _loss_grads(params, batch, cfg)
    c64, p64, b64 = _float64(cfg, params, batch)
    loss64, g64 = _loss_grads(p64, b64, c64)
    np.testing.assert_allclose(float(loss32), float(loss64), rtol=1e-5)
    gap = max(float((a.double() - w).abs().max() / w.abs().max())
              for a, w in zip(g32, g64) if w.abs().max() > 0)
    assert 1e-5 < gap <= 1e-3, gap
