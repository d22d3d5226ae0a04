"""The port's launch and config tail against `repro`: the cell registry,
placement specs, the production mesh and the dry run.

The counterpart of `tests/test_launch_infra.py` (its tests mirrored by
name), and the port held to the reference:
- `param_specs` / `cache_specs` of the five LMs (both schemes, both
  meshes) and MIND's `param_specs` equal the reference's, each
  `PartitionSpec` read as a tuple (JAX reads a one-name tuple as the
  name, and so does `launch.mesh.P`);
- every cell of the 10 archs + batchhl, on both meshes, equals the
  reference's `build_cell` in `kind`, `flops_note`, the shape and dtype
  of every argument leaf, and `in_specs` / `out_specs` (the reference
  builds cells without devices);
- `as_specs` equals the reference's on every layout, and
  `make_production_mesh` has the reference's axes and sizes (the
  reference's needs 512 host devices, so it runs in a subprocess with
  `XLA_FLAGS`; `repro.launch.dryrun` sets `XLA_FLAGS` at import, so it is
  never imported here);
- the dry run's per-device argument bytes of `batchhl/update_1k` on the
  single mesh, and the FLOPs of MIND's reduced serve step, equal counts
  worked out by hand;
- the five BatchHL cell steps, with both packages' `model_config`
  patched to `reduced_config` (V = 256, edge cap 1024, R = 4), equal the
  reference's (jitted once, in a module fixture) bit for bit on the same
  numpy inputs.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import copy
import importlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import batchhl as jbhl
from repro.configs import common as jcommon
from repro.data import synthetic as jsynth
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro.models import mind as jmind
from repro.models import transformer as jtfm
from repro.core import construct as jcon
from repro_torch.configs import batchhl as tbhl
from repro_torch.configs import common as tcommon
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import P, make_production_mesh
from repro_torch.models import mind as tmind
from repro_torch.models import transformer as ttfm

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ("gemma2-9b", "minitron-4b", "granite-8b",
            "deepseek-v2-lite-16b", "mixtral-8x22b")
CELLS = [(a, s) for a in tcommon.ALL_ARCHS + ("batchhl",)
         for s in tcommon.arch_shapes(a)]


def _canon(x):
    """A tree of either package as plain Python: dicts, lists (for lists
    and tuples), ("P", entries) for a spec, (shape, dtype) for a leaf."""
    if isinstance(x, (P, JP)):
        return ("P", tuple(x))
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if isinstance(x, jax.ShapeDtypeStruct):
        return (tuple(x.shape), jnp.dtype(x.dtype).name)
    raise TypeError(type(x))


# --- the reference's launch tests, mirrored ----------------------------------

HLO = """
  %ag = bf16[2,128]{1,0} all-gather(%x), replica_groups={}
  %ar = f32[64]{0} all-reduce(%y), to_apply=%sum
  %rs = f32[8,8]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = s32[16]{0} all-to-all(%w)
  %cp = pred[32]{0} collective-permute(%v)
  %plain = f32[100]{0} add(%a, %b)
"""


def test_parse_collective_bytes():
    out = dryrun.parse_collective_bytes(HLO)
    assert out["per_type_bytes"]["all-gather"] == 2 * 128 * 2
    assert out["per_type_bytes"]["all-reduce"] == 64 * 4
    assert out["per_type_bytes"]["reduce-scatter"] == 64 * 4
    assert out["per_type_bytes"]["all-to-all"] == 16 * 4
    assert out["per_type_bytes"]["collective-permute"] == 32
    assert out["total_bytes"] == sum(out["per_type_bytes"].values())
    assert out["counts"]["all-gather"] == 1


def test_shape_bytes_scalars_and_dtypes():
    assert dryrun._shape_bytes("f32", "") == 4          # scalar
    assert dryrun._shape_bytes("bf16", "4,4") == 32
    assert dryrun._shape_bytes("pred", "8") == 8
    assert dryrun._shape_bytes("s8", "3,3") == 9


def test_registry_covers_all_assigned_archs():
    assert tcommon.ALL_ARCHS == jcommon.ALL_ARCHS
    assert len(tcommon.ALL_ARCHS) == 10
    for arch in tcommon.ALL_ARCHS + ("batchhl",):
        mod = tcommon.get_arch(arch)
        assert mod.ARCH_ID == arch
        assert mod.SHAPES == jcommon.get_arch(arch).SHAPES
        assert len(mod.SHAPES) == (5 if arch == "batchhl" else 4)
        assert mod.model_config() is not None
        assert mod.reduced_config() is not None


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_match_param_shapes(arch):
    """Both schemes' spec trees have the params tree's structure, and no
    spec has more entries than its leaf has dims."""
    cfg = tcommon.get_arch(arch).model_config()
    shapes = ttfm.param_shapes(cfg)
    for scheme in ("v1", "v2"):
        specs = ttfm.param_specs(cfg, pod=False, scheme=scheme)
        assert specs.keys() == shapes.keys()
        for k, sh in shapes.items():
            sp = specs[k]
            pairs = ([(sh, sp)] if isinstance(sp, P)
                     else [(sh[j], sp[j]) for j in sh])
            assert isinstance(sp, P) or sp.keys() == sh.keys()
            for leaf, spec in pairs:
                assert len(spec) <= leaf.dim(), (arch, scheme, k, spec)


# --- specs and cells against the reference -----------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_and_cache_specs_match_reference(arch):
    tcfg = tcommon.get_arch(arch).model_config()
    jcfg = jcommon.get_arch(arch).model_config()
    for pod in (False, True):
        for scheme in ("v1", "v2"):
            assert _canon(ttfm.param_specs(tcfg, pod, scheme)) == \
                _canon(jtfm.param_specs(jcfg, pod, scheme))
        assert _canon(ttfm.cache_specs(tcfg, pod)) == \
            _canon(jtfm.cache_specs(jcfg, pod))


def test_mind_param_specs_match_reference():
    tcfg = tcommon.get_arch("mind").model_config()
    jcfg = jcommon.get_arch("mind").model_config()
    for pod in (False, True):
        assert _canon(tmind.param_specs(tcfg, pod)) == \
            _canon(jmind.param_specs(jcfg, pod))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_matches_reference(arch, shape):
    for pod in (False, True):
        got = tcommon.build_cell(arch, shape, pod)
        want = jcommon.build_cell(arch, shape, pod)
        assert (got.arch_id, got.shape_name, got.kind) == \
            (want.arch_id, want.shape_name, want.kind)
        assert got.flops_note == want.flops_note
        assert _canon(got.arg_specs) == _canon(want.arg_specs)
        assert _canon(got.in_specs) == _canon(want.in_specs)
        assert _canon(got.out_specs) == _canon(want.out_specs)


def _layouts(pkg):
    out = {"lm_train": pkg.lm_train_layout(4, 16, 100),
           "lm_decode": pkg.lm_decode_layout(4, 100),
           "lm_prefill": pkg.lm_prefill_layout(2, 32, 100),
           "mind_train": pkg.mind_train_layout(8, 10, 1000),
           "mind_serve": pkg.mind_serve_layout(8, 10, 1000, 5),
           "mind_retrieval": pkg.mind_retrieval_layout(10, 1000, 300)}
    for arch in ("schnet", "dimenet", "mace", "graphcast"):
        out[arch] = pkg.gnn_layout(arch, 64, 256, 16, 1)
        out[arch + "_graphs"] = pkg.gnn_layout(arch, 64, 256, 16, 3,
                                               n_graphs=4, tri_cap=512)
    return out


def test_as_specs_matches_reference():
    got, want = _layouts(tsynth), _layouts(jsynth)
    assert got.keys() == want.keys()
    for name in got:
        specs = tsynth.as_specs(got[name])
        assert all(t.device.type == "meta" for t in specs.values())
        assert _canon(specs) == _canon(jsynth.as_specs(want[name])), name


def test_spec_reads_as_partition_spec():
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P(("pod", "data")).axes(0) == ("pod", "data")
    assert P("model").axes(0) == ("model",) and P("model").axes(1) == ()
    assert P() == () and P(None).axes(0) == ()
    spec = P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(copy.deepcopy(spec)) is P
    with pytest.raises(ValueError):
        P(("data", 3))


def test_production_mesh_matches_reference():
    code = (
        "import os, json\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=512'\n"
        "from repro.launch.mesh import make_production_mesh\n"
        "from repro.launch.dryrun import parse_collective_bytes\n"
        "out = {}\n"
        "for mp in (False, True):\n"
        "    m = make_production_mesh(multi_pod=mp)\n"
        "    out[str(mp)] = [list(m.axis_names), dict(m.shape), m.size]\n"
        f"out['hlo'] = parse_collective_bytes({HLO!r})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        assert [list(m.axis_names), m.shape, m.size] == want[str(mp)]
    assert dryrun.parse_collective_bytes(HLO) == want["hlo"]


# --- the dry run -------------------------------------------------------------

def test_dryrun_bytes_of_update_1k_by_hand():
    """Per device on (data=16, model=16): the graph's 13 bytes a slot over
    2^24 slots / 16; dist int32 [32, 2^20] over (model, data); hub bool;
    highway [32, 32] and the landmarks replicated; the 1024-row batch
    (15 bytes a row) replicated."""
    rec = dryrun.run_cell("batchhl", "update_1k", False, flops=False)
    graph = 13 * (1 << 24) // 16
    dist = 32 // 16 * (1 << 20) // 16 * 4
    hub = dist // 4
    want = graph + dist + hub + 32 * 32 * 4 + 32 * 4 + 15 * 1024
    assert want == 14_306_432
    assert rec["memory"]["argument_bytes"] == want
    # out: the graph and labelling as placed, and the int32 count.
    assert rec["memory"]["output_bytes"] == want - 15 * 1024 + 4
    assert (rec["mesh"], rec["devices"]) == ("16x16", 256)
    for k in ("temp_bytes", "peak_bytes", "generated_code_bytes"):
        assert rec["memory"][k] is None and rec["null_reasons"][k]
    assert rec["collectives"] is None and rec["cost"]["flops"] is None
    multi = dryrun.run_cell("batchhl", "update_1k", True, flops=False)
    assert multi["memory"]["argument_bytes"] == \
        13 * (1 << 24) // 32 + dist // 2 + hub // 2 + 4096 + 128 + 15360


def test_dryrun_flops_of_mind_serve_by_hand():
    """MIND's reduced config on serve_p99's shapes: the bilinear map, 3
    routing products and 2 logit updates, the output projection and the
    candidate scores, 2·m·n·k each."""
    cfg = tcommon.get_arch("mind").reduced_config()
    sh = tcommon.MIND_SHAPES["serve_p99"]
    b, c = sh["batch"], sh["n_cands"]
    l, d, k = cfg.hist_len, cfg.embed_dim, cfg.n_interests
    want = (2 * b * l * d * d + 3 * 2 * b * k * l * d + 2 * 2 * b * k * d * l
            + 2 * b * k * d * d + 2 * b * k * c * d)
    cell = tcommon.mind_cell(cfg, "serve_p99", False)
    assert dryrun.step_flops(cell) == want


def test_dryrun_record_and_cli(tmp_path, monkeypatch, capsys):
    """`main` writes one record per cell with the reference's keys; the
    BatchHL steps give null FLOPs with the reason; importing the module
    sets no environment variable."""
    env = dict(os.environ)
    importlib.reload(dryrun)
    assert dict(os.environ) == env
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "batchhl", "--shape", "query_1k", "--mesh",
        "both", "--out", str(tmp_path)])
    dryrun.main()
    assert "dry-run complete: 2 ok, 0 failed" in capsys.readouterr().out
    for tag in ("single", "multi"):
        rec = json.loads((tmp_path / f"batchhl__query_1k__{tag}.json")
                         .read_text())
        assert {"arch", "shape", "mesh", "devices", "memory", "cost",
                "collectives", "flops_note"} <= rec.keys()
        assert rec["cost"]["flops"] is None
        assert "host" in rec["null_reasons"]["flops"]
        # The answers split over the data axes (data, or pod × data).
        assert rec["memory"]["output_bytes"] == \
            1024 * 4 // (rec["devices"] // 16)


# --- the five BatchHL cells on the CPU, bit for bit -------------------------

N_INS, N_DEL = 100, 100


@pytest.fixture(scope="module")
def bhl():
    """Both packages' cells at the reduced config, the numpy inputs, and
    the reference's outputs (each step jitted once)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbhl, "model_config", jbhl.reduced_config)
        mp.setattr(tbhl, "model_config", tbhl.reduced_config)
        cfg = tbhl.reduced_config()
        edges = jgen.barabasi_albert(cfg.n_vertices, 3, seed=5)
        gj = jcoo.from_edges(cfg.n_vertices, edges, cfg.edge_cap)
        assert cfg.edge_cap - len(edges) >= N_INS   # inserts fit free slots
        lm = jcon.select_landmarks_by_degree(gj, cfg.n_landmarks)
        lab = jcon.build_labelling(gj, lm)
        ups = jgen.random_batch_updates(edges, cfg.n_vertices, n_ins=N_INS,
                                        n_del=N_DEL, seed=6)
        rng = np.random.default_rng(7)
        g = {f: np.asarray(getattr(gj, f)) for f in ("src", "dst", "valid",
                                                     "w")}
        lab = {f: np.asarray(getattr(lab, f)) for f in (
            "landmarks", "dist", "hub", "highway")}
        q = {k: rng.integers(0, cfg.n_vertices, 1024).astype(np.int32)
             for k in ("s", "t")}
        inputs = {"construct": (g, np.asarray(lm)), "query_1k": (g, lab, q),
                  "query_1k_repl": (g, lab, q)}
        for name, pad in (("update_1k", 1024), ("update_10k", 10240)):
            b = jcoo.make_batch(ups, pad_to=pad)
            inputs[name] = (g, {f: np.asarray(getattr(b, f)) for f in (
                "src", "dst", "is_del", "valid", "w", "is_rew")}, lab)
        cells, want = {}, {}
        for name in jbhl.SHAPES:
            jc = jcommon.build_cell("batchhl", name, False)
            cells[name] = tcommon.build_cell("batchhl", name, False)
            assert _canon(cells[name].arg_specs) == _canon(jc.arg_specs)
            args = jax.tree.map(jnp.asarray, inputs[name])
            want[name] = jax.tree.map(np.asarray, jax.jit(jc.step_fn)(*args))
    return cells, inputs, want


@pytest.mark.parametrize("shape", jbhl.SHAPES)
def test_batchhl_cell_matches_reference(bhl, shape):
    cells, inputs, want = bhl
    args = jax.tree.map(lambda a: torch.from_numpy(a.copy()), inputs[shape],
                        is_leaf=lambda x: isinstance(x, np.ndarray))
    got = cells[shape].step_fn(*args)
    got = jax.tree.map(lambda t: t.numpy(), got,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert jax.tree.structure(got) == jax.tree.structure(want[shape])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want[shape])):
        np.testing.assert_array_equal(g, w)
    if shape.startswith("update"):
        assert int(got[2]) > 0    # the batch affected some labels
