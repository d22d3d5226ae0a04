"""The port stands alone: no JAX, no `repro`, no silent CPU fallback."""
from __future__ import annotations

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
    ROOT / "chip_smoke.py", ROOT / "tests" / "_sweep_cases.py"]


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch.api, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.core.snapshot, "
            "repro_torch.core.growth, repro_torch.checkpoint.manager, "
            "repro_torch.core.autotune, repro_torch.core.directed, "
            "repro_torch.launch.replica; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
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


def test_checkpoint_restore_without_device_raises_without_cuda(tmp_path):
    from repro_torch.checkpoint import manager as tckpt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the GPU")
    tckpt.save(str(tmp_path), 0, {"x": np.arange(3, dtype=np.int64)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(3, dtype=torch.int64)})


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
