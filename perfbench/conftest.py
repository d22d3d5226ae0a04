"""Small cells of the benchmark for its CPU tests.

The harness runs here on the CPU, where the program's kernels run their
plain PyTorch versions: every cell of `BENCHMARK.json` at a size that a
test holds (2^10 vertices, 8 landmarks, microbatches of 8, batches of
32), with its configuration's and its mix's own keys otherwise.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

SMALL_CONFIG = {"n": 1024, "scale": 10, "edge_capacity": 16384,
                "landmarks": 8, "block_v": 64, "block_e": 256}
SMALL_MIX = {"query": {"microbatch": 8, "pool": 4096, "check_sample": 256,
                       "trace_ops": 4},
             "update": {"deletes": 32, "trace_ops": 3}}


def small_cell(workload: str, spec: dict | None = None, root: Path = ROOT):
    """The cell `workload` of the benchmark (or of `spec`, with its files
    under `root`), cut to a test's size."""
    from perfbench import harness
    spec = harness.load_spec() if spec is None else spec
    cell = harness.resolve(spec, workload, root)
    cell.config.update({k: v for k, v in SMALL_CONFIG.items()
                        if k in cell.config})
    cell.mix.update(SMALL_MIX[cell.mix["kind"]])
    if cell.mix["kind"] == "update" and cell.mix["inserts"]:
        cell.mix.update(inserts=16, deletes=16, insert_pool=4096)
    return cell


def workloads() -> list[str]:
    import json
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
