"""Whole runs of every cell at a small size on the CPU: correct, with
the contract's keys; and the entry point's refusals."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.conftest import ROOT, small_cell, workloads

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_runs_correct_with_the_contracts_keys(workload, trace,
                                                         cpu):
    cell = small_cell(workload)
    result, run = harness.run_cell(cell, 2**31 + 11, 0.4, trace, cpu)
    keys = list(result)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(LINE_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == run.items > 0
    for c in result["checks"].values():
        assert not isinstance(c, dict) or c["value"] <= c["limit"]
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    else:
        # On the CPU the device metrics find nothing to read; the
        # program's counters and the host clock do.
        counted = {m["name"] for m in want if m["source"] in
                   ("program_counter", "host_clock")}
        assert set(result["metrics"]) == counted
        assert {"busy_s", "window_s"} <= set(result["device"])
    if run.kind == "update" and trace:
        assert result["metrics"]["retiles.update"]["value"] == 0.0
    json.dumps(result)


def test_main_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main("ba20.query", 1, 1.0, False, 0.0, 0.0) == 2
    assert capsys.readouterr().out == ""


def test_run_py_refuses_in_a_copy_of_the_benchmark_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/: no
    program, so no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "ba20.query",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_a_mix_with_insertions_runs_as_data_alone(cpu):
    """A mixed batch (the serve loop's `mixed`: deletions and insertions)
    needs no code: each batch retiles (but the first, whose tiling the
    warm-up's same batch left in the engine's cache), and the check
    holds."""
    cell = small_cell("ba20.update_del")
    cell.mix.update(deletes=16, inserts=16, insert_pool=4096)
    result, run = harness.run_cell(cell, 2**31 + 12, 0.4, True, cpu)
    assert result["correct"] is True and run.ops > 0
    assert run.retiles == run.ops - 1


def test_set_up_is_split_into_its_parts(cpu):
    """`setup_s` spans the run's start (imports, the CUDA context, the
    program's modules) and each step of building the cell, each recorded
    on its own in the run's record."""
    t0 = harness.time.perf_counter()
    _, run = harness.run_cell(small_cell("ba20.query"), 2**31 + 13, 0.2,
                              False, cpu, t0=t0,
                              parts={"import_s": 0.0, "cuda_s": 0.0})
    parts = run.setup_parts
    steps = ("program_s", "generate_s", "load_s", "prepare_s",
             "construct_s", "stream_s", "warm_s")
    assert {"import_s", "cuda_s", "start_s", *steps} <= set(parts)
    assert parts["start_s"] >= parts["program_s"] >= 0
    assert sum(parts[k] for k in steps[1:]) + parts["start_s"] \
        <= run.setup_s + 1e-6
