"""The port stands alone: no JAX, no `repro`, no silent CPU fallback."""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_sweep_cases.py",
    ROOT / "tests" / "_torch_threads.py"]


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch.api, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.core.snapshot, "
            "repro_torch.core.growth, repro_torch.checkpoint.manager, "
            "repro_torch.core.autotune, repro_torch.core.directed, "
            "repro_torch.launch.replica, repro_torch.core.shard, "
            "repro_torch.launch.mesh, repro_torch.models.mind, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.configs.common, repro_torch.configs.mind, "
            "repro_torch.data.synthetic, repro_torch.models.gnn, "
            "repro_torch.graphs.sampler, repro_torch.graphs.segment, "
            "repro_torch.gather, repro_torch.configs.schnet, "
            "repro_torch.configs.dimenet, repro_torch.configs.mace, "
            "repro_torch.configs.graphcast, repro_torch.models.transformer, "
            "repro_torch.models.moe, repro_torch.train.serve_step, "
            "repro_torch.launch.train, repro_torch.configs.gemma2_9b, "
            "repro_torch.configs.minitron_4b, repro_torch.configs.granite_8b, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.mixtral_8x22b, repro_torch.configs.batchhl, "
            "repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.') or m == 'ml_dtypes']; print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(import ml_dtypes|from ml_dtypes)", text,
                         re.M)
    assert not re.search(r"^\s*(from repro[ .]|import repro\b(?!_))", text,
                         re.M)


def test_build_without_device_raises_without_cuda():
    from repro_torch import api
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build(4, np.array([[0, 1], [1, 2]]), num_landmarks=1)


def test_serve_loop_without_device_raises_without_cuda():
    from repro_torch.launch.serve import ServeConfig, ServeLoop
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(ServeConfig(n=50, batches=1, quiet=True))


def test_mesh_without_device_raises_without_cuda():
    """A host mesh is of the GPU's devices unless it is given the CPU's,
    so the sharded entry points and a mesh loop raise without CUDA."""
    from repro_torch.core.shard import shard_build_labelling
    from repro_torch.graphs.coo import from_edges
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import ServeConfig, ServeLoop
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    g = from_edges(3, np.array([[0, 1], [1, 2]]), 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_build_labelling(make_host_mesh(), g,
                              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(ServeConfig(n=50, batches=1, mesh="host", quiet=True))
    assert make_host_mesh(device="cpu").devices == [torch.device("cpu")]


def test_mind_init_and_materialize_without_device_raise_without_cuda():
    """MIND's params and batches are made on the GPU unless they are
    given the CPU."""
    from repro_torch.configs import common
    from repro_torch.data import synthetic
    from repro_torch.models import mind
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    cfg = common.get_arch("mind").reduced_config()
    layout = synthetic.mind_train_layout(4, cfg.hist_len, cfg.n_items)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mind.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.materialize(layout)
    assert mind.init_params(cfg, device="cpu")["item_embed"].device == \
        synthetic.materialize(layout, device="cpu")["hist"].device == \
        torch.device("cpu")


def test_gnn_and_sampler_without_device_raise_without_cuda():
    """The GNN params and batches, the CSR and the sampler's host seeds
    are put on the GPU unless they are given the CPU."""
    from repro_torch.configs import common
    from repro_torch.data import synthetic
    from repro_torch.graphs import sampler
    from repro_torch.models import gnn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    cfg = common.get_arch("schnet").reduced_config()
    edges = np.array([[0, 1], [1, 2]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.coherent_gnn_batch("schnet", 8, 2, cfg.d_in, cfg.d_out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.build_csr(3, edges)
    csr = sampler.build_csr(3, edges, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.sample_neighbors(csr, np.array([0, 1]), 2, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.sample_subgraph(csr, [0, 1], (2,), None)
    nbrs, _ = sampler.sample_neighbors(csr, torch.tensor([0, 1]), 2, None)
    assert nbrs.device == gnn.init_params(cfg, device="cpu")[
        "embed"][0]["w"].device == torch.device("cpu")


def test_checkpoint_restore_without_device_raises_without_cuda(tmp_path):
    from repro_torch.checkpoint import manager as tckpt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    tckpt.save(str(tmp_path), 0, {"x": np.arange(3, dtype=np.int64)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(3, dtype=torch.int64)})


def test_prepare_without_device_raises_without_cuda():
    """The four `prepare*` of the edge-relax ops tile onto the GPU
    unless they are given the CPU."""
    from repro_torch.kernels.edge_relax import ops
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    keep = np.ones(4, bool)
    for prepare in (ops.prepare, ops.prepare_topology, ops.prepare_sorted,
                    ops.prepare_frontier):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prepare(src, dst, keep, 3)
        assert prepare(src, dst, keep, 3, device="cpu") is not None


def test_from_arcs_without_device_raises_without_cuda():
    from repro_torch.core.directed import from_arcs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_arcs(3, np.array([[0, 1], [1, 2]]), 4)


def test_autotune_cli_without_device_raises_without_cuda(tmp_path):
    """`python -m repro_torch.core.autotune` tunes on the GPU unless given
    `--device`; with `--device cpu` it writes its table."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    table = str(tmp_path / "t.json")
    cmd = [sys.executable, "-m", "repro_torch.core.autotune", "--n", "60",
           "--table", table]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not os.path.exists(table)
    from repro_torch.core import autotune
    autotune.main(cmd[3:] + ["--device", "cpu"])
    assert autotune.TuneTable(table).get("n=60,cap=1220,s=2") == \
        autotune.TuneConfig("sorted", 256, None, 2)


def _replica_spec(path):
    from repro_torch.launch.config import GraphSpec, ServeSpec, StreamSpec
    spec = ServeSpec(graph=GraphSpec(n=60, deg=2, landmarks=2),
                     stream=StreamSpec(batches=1, batch_size=4, queries=0,
                                       quiet=True))
    spec.save_json(str(path))
    return spec


def test_replica_reader_without_device_raises_without_cuda(tmp_path):
    """A reader role resolves the GPU unless it is given `--device`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    cfg = tmp_path / "config.json"
    _replica_spec(cfg)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replica", "--role",
         "reader", "--config", str(cfg), "--publish-dir", str(tmp_path),
         "--port", "0"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_replica_topology_start_raises_when_roles_die(tmp_path):
    """Without a GPU and without a device every role but the router
    dies at once, and `start()` says so instead of waiting out its
    timeout."""
    from repro_torch.launch import replica
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    topo = replica.ReplicaTopology(_replica_spec(tmp_path / "spec.json"),
                                   str(tmp_path))
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="exited rc=1 during startup"):
            topo.start(timeout_s=180.0)
    finally:
        topo.stop()
    assert time.monotonic() - t0 < 60.0
    assert all(p.poll() is not None
               for p in [topo.updater, topo.router, *topo.readers])


def test_resolve_device_turns_off_bf16_reduced_precision_reduction():
    """Every entry point's device goes through `resolve_device`, which
    makes cuBLAS add the split-K partial sums of bfloat16 GEMMs in
    float32 (the reference's `preferred_element_type=float32`)."""
    from repro_torch.device import resolve_device
    flags = torch.backends.cuda.matmul
    was = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert flags.allow_bf16_reduced_precision_reduction is False
    finally:
        flags.allow_bf16_reduced_precision_reduction = was


_TILES_IN_KERNEL = ("kernel A gathers the mask, the weights and the hub "
                    "flags through perm_t itself, and the device picks the "
                    "backend")
_NO_BACKEND = "the port has no backend switch: the tensor's device is it"
_PRNG = ("the port cannot reproduce jax's PRNG: it draws from a "
         "torch.Generator, and the reference's parameters are carried "
         "across as numpy")

#: Public names of `src/repro` that the port has no counterpart of, by
#: design, each with its reason. A key is a module path under the
#: package (every name of that module), `path:NAME`, or "*" and a
#: suffix (a name with that ending in any module). `path:Class.member`
#: excuses a missing class member. `path:qual(param)` drops a parameter
#: from the signature walk on both sides, `path:qual(ref→port)` a
#: parameter of the reference and the port's parameter in its place, and
#: `path:qual(positional order)` the order of the positional parameters.
NAME_ALLOWLIST = {
    # The Pallas launchers and their block constants: the port launches
    # hand-written CUDA kernels through ctypes wrappers instead
    # (`kernel.minplus`, `kernel.edge_relax`, `kernel.relax_sweep`,
    # `kernel.embed_bag`), with their own launch geometry.
    "*_pallas": "Pallas launcher; the ctypes wrapper replaces it",
    "kernels/minplus/kernel.py:DEFAULT_BB": "Pallas block of query rows",
    "kernels/minplus/kernel.py:LANES": "Pallas lane width",
    "kernels/embed_bag/kernel.py:DEFAULT_BB": "Pallas block of bags",
    # The jnp oracles: their plain twins live beside each kernel, in the
    # kernel's own module, as the port's rule for kernels asks.
    "kernels/minplus/ref.py": "plain twin is kernel.minplus_plain "
                              "(INF32 is kernel.INF32)",
    "kernels/embed_bag/ref.py": "plain twin is kernel.embed_bag_plain",
    # The port has no backend switch: a tensor's device picks the kernel
    # (CUDA) or its plain twin (CPU), and `RelaxPlan.impl` the autotuned
    # impl; the COO path is `relax_sweep(None, ...)`, a plan of None.
    "core/engine.py:BACKENDS": "the device picks kernel or plain twin",
    "core/engine.py:JNP_PLAN": "the port's COO path is plan=None",
    # Class members.
    "core/engine.py:RelaxPlan.backend": _TILES_IN_KERNEL,
    "kernels/edge_relax/ops.py:BlockedGraph.tile_mask": _TILES_IN_KERNEL,
    "kernels/edge_relax/ops.py:BlockedGraph.tile_w": _TILES_IN_KERNEL,
    "kernels/edge_relax/ops.py:BlockedGraph.tile_plane": _TILES_IN_KERNEL,
    "kernels/edge_relax/ops.py:BlockedGraph.tile_plane_rows":
        _TILES_IN_KERNEL,
    # Signatures.
    "core/engine.py:RelaxPlan.__init__(backend)": _NO_BACKEND,
    "core/engine.py:RelaxPlan.__init__(positional order)":
        "the reference's second field is `backend`, which the port has "
        "not, so none of its positional calls carries over",
    "core/engine.py:RelaxEngine.__init__(backend)": _NO_BACKEND,
    "core/engine.py:RelaxEngine.__init__(positional order)":
        "the reference's callers all pass its knobs by keyword; the port "
        "takes block_v and block_e by position and the rest by keyword",
    "core/batch.py:frontier_wave(kind)":
        "its leading `kind` (and its third return value) feed the wave "
        "counters",
    "kernels/edge_relax/ops.py:edge_relax(use_pallas)": _NO_BACKEND,
    "kernels/embed_bag/ops.py:embed_bag(use_pallas)": _NO_BACKEND,
    "kernels/minplus/ops.py:minplus_bound(use_pallas)": _NO_BACKEND,
    "graphs/sampler.py:sample_neighbors(key→generator)": _PRNG,
    "graphs/sampler.py:sample_subgraph(key→generator)": _PRNG,
    "models/gnn.py:init_params(key)": _PRNG,
    "models/gnn.py:schnet_init(key→init)": _PRNG,
    "models/gnn.py:dimenet_init(key→init)": _PRNG,
    "models/gnn.py:mace_init(key→init)": _PRNG,
    "models/gnn.py:graphcast_init(key→init)": _PRNG,
    "models/mind.py:init_params(key)": _PRNG,
    "models/transformer.py:init_params(key)": _PRNG,
}


def _top_level_names(path: Path, with_imports: bool) -> set:
    """Public names bound at the top level of `path`, parsed with `ast`:
    defs, classes and assignments, and imports where `with_imports`."""
    import ast
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _allowed(rel: str, name: str) -> bool:
    return (rel in NAME_ALLOWLIST or f"{rel}:{name}" in NAME_ALLOWLIST
            or any(k.startswith("*") and name.endswith(k[1:])
                   for k in NAME_ALLOWLIST))


def test_every_public_reference_name_has_a_counterpart():
    """Each public top-level name of a `src/repro` module is bound at the
    top level of its counterpart in `src/repro_torch` (same path), unless
    `NAME_ALLOWLIST` says why not. Both packages are parsed, not
    imported."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        twin = port / rel
        have = (_top_level_names(twin, with_imports=True) if twin.is_file()
                else set())
        missing += [f"{rel}:{name}" for name in
                    sorted(_top_level_names(path, with_imports=False) - have)
                    if not _allowed(rel, name)]
    assert not missing, f"no counterpart in the port: {missing}"
    stale = [k for k in NAME_ALLOWLIST if not k.startswith("*") and not (
        ref / k.split(":")[0]).is_file()]
    assert not stale, f"allowlist names no reference module: {stale}"
    assert all(isinstance(v, str) and v.strip()
               for v in NAME_ALLOWLIST.values()), "an entry has no reason"


def _classes(tree) -> dict:
    import ast
    return {node.name: node for node in tree.body
            if isinstance(node, ast.ClassDef)}


def _is_dataclass(cls) -> bool:
    import ast
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _fields(cls) -> list:
    """A class's annotated fields (ClassVars left out), in order."""
    import ast
    return [node for node in cls.body if isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and "ClassVar" not in ast.unparse(node.annotation)]


def _members(cls) -> set:
    """Public members defined in a class body: methods, properties,
    annotated fields and class attributes."""
    import ast
    out = {node.target.id for node in _fields(cls)}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


def _class_pairs():
    """(module path, class name, reference ClassDef, port ClassDef) of
    every class defined at the top level of a module in both packages."""
    import ast
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if not (port / rel).is_file():
            continue
        rc = _classes(ast.parse(path.read_text()))
        pc = _classes(ast.parse((port / rel).read_text()))
        for name in sorted(set(rc) & set(pc)):
            yield rel, name, rc[name], pc[name]


def test_every_public_reference_member_has_a_counterpart():
    """Each public member of a class defined in both packages (methods,
    properties, annotated fields, class attributes) is defined in the
    port's class too, unless `NAME_ALLOWLIST` says why not; and each
    member entry there excuses a member that is missing."""
    missing, used = [], set()
    for rel, name, rcls, pcls in _class_pairs():
        for member in sorted(_members(rcls) - _members(pcls)):
            key = f"{rel}:{name}.{member}"
            if key in NAME_ALLOWLIST:
                used.add(key)
            else:
                missing.append(key)
    assert not missing, f"no counterpart in the port: {missing}"
    member_keys = {k for k in NAME_ALLOWLIST
                   if "(" not in k and "." in k.partition(":")[2]}
    assert member_keys == used, \
        f"allowlist entries that excuse nothing: {sorted(member_keys - used)}"


def _signature(fn) -> dict:
    """name → (kind, has default) of a def's parameters, kind "pos"
    (positional or keyword), "posonly", "kw", "*" or "**", in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    first_default = len(pos) - len(a.defaults)
    sig = {x.arg: ("posonly" if i < len(a.posonlyargs) else "pos",
                   i >= first_default) for i, x in enumerate(pos)}
    if a.vararg is not None:
        sig[a.vararg.arg] = ("*", True)
    sig.update({x.arg: ("kw", d is not None)
                for x, d in zip(a.kwonlyargs, a.kw_defaults)})
    if a.kwarg is not None:
        sig[a.kwarg.arg] = ("**", True)
    return sig


def _signatures(tree) -> dict:
    """Qualified name → signature of a module's public functions (and
    names bound to them, `alias = function`), and of the public methods
    and `__init__` of its classes; a dataclass without its own
    `__init__` gets the one its fields make."""
    import ast
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _signature(node)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Name):
            if node.value.id in out:
                out.update((t.id, out[node.value.id]) for t in node.targets
                           if isinstance(t, ast.Name))
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (m.name == "__init__"
                             or not m.name.startswith("_")):
                    out[f"{node.name}.{m.name}"] = _signature(m)
            if _is_dataclass(node) and f"{node.name}.__init__" not in out:
                out[f"{node.name}.__init__"] = {"self": ("pos", False)} | {
                    f.target.id: ("pos", f.value is not None)
                    for f in _fields(node)}
    return {k: v for k, v in out.items()
            if not k.split(".")[0].startswith("_")}


def _signature_faults(ref_sig: dict, port_sig: dict, drop_ref: set,
                      drop_port: set, keep_order: bool) -> list:
    """How a call written for the reference's signature can fail on the
    port's: positional names that are not a prefix of the port's, a
    parameter the port requires that the reference does not, and a
    reference parameter the port does not take by name."""
    r = {k: v for k, v in ref_sig.items() if k not in drop_ref}
    p = {k: v for k, v in port_sig.items() if k not in drop_port}
    faults = []
    r_pos = [k for k, (kind, _) in r.items() if kind in ("pos", "posonly")]
    p_pos = [k for k, (kind, _) in p.items() if kind in ("pos", "posonly")]
    if keep_order and p_pos[:len(r_pos)] != r_pos:
        faults.append(f"positional {r_pos} against {p_pos}")
    faults += [f"requires {k}" for k, (kind, default) in p.items()
               if not default and (k not in r or r[k][1])]
    by_name = any(kind == "**" for kind, _ in p.values())
    faults += [f"no {k}" for k, (kind, _) in r.items()
               if kind in ("pos", "kw") and not by_name
               and p.get(k, ("posonly",))[0] not in ("pos", "kw")]
    if any(kind == "*" for kind, _ in r.values()) and not any(
            kind == "*" for kind, _ in p.values()):
        faults.append("no *args")
    return faults


def test_every_reference_signature_binds_in_the_port():
    """Each public function and method (`__init__` included) defined in
    both packages takes a call written for the reference's signature:
    the reference's positional names are a prefix of the port's, the
    port requires no parameter the reference does not, and it takes
    every reference parameter by name. Keyword-only extras with defaults
    (`device`, `engine`, ...) are the port's own. `NAME_ALLOWLIST`
    excuses parameters and orders, each with its reason; each such entry
    must excuse something."""
    import ast
    drops: dict = {}
    for key in NAME_ALLOWLIST:
        if "(" in key:
            base, _, inner = key[:-1].partition("(")
            drops.setdefault(base, []).append((key, inner))
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    faults, used = [], set()
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if not (port / rel).is_file():
            continue
        rs = _signatures(ast.parse(path.read_text()))
        ps = _signatures(ast.parse((port / rel).read_text()))
        for qual in sorted(set(rs) & set(ps)):
            drop_ref, drop_port, keep_order = set(), set(), True
            for key, inner in drops.get(f"{rel}:{qual}", ()):
                if inner == "positional order":
                    keep_order = False
                    if _signature_faults(rs[qual], ps[qual], set(), set(),
                                         True):
                        used.add(key)
                    continue
                left, _, right = inner.partition("→")
                drop_ref.add(left)
                drop_port.add(right or left)
                if (left in rs[qual] and right in ps[qual]) if right \
                        else left in rs[qual] | ps[qual]:
                    used.add(key)
            faults += [f"{rel}:{qual}: {f}" for f in _signature_faults(
                rs[qual], ps[qual], drop_ref, drop_port, keep_order)]
    assert not faults, f"reference calls that fail on the port: {faults}"
    sig_keys = {k for k in NAME_ALLOWLIST if "(" in k}
    assert sig_keys == used, \
        f"allowlist entries that excuse nothing: {sorted(sig_keys - used)}"
