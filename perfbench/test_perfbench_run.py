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


def check_small_run(cell, seed: int, trace: bool, cpu):
    """A small run of `cell`: correct, with the contract's keys and the
    cell's metrics. (result, run)"""
    result, run = harness.run_cell(cell, seed, 0.4, trace, cpu)
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
    if trace and "retiles.update" in names:
        # Each batch with insertions retiles, the first too: the warm-up
        # ran the same batch on a copy of the engine.
        retiles = result["metrics"]["retiles.update"]["value"]
        assert retiles == (1.0 if cell.mix["inserts"] else 0.0)
    json.dumps(result)
    return result, run


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_runs_correct_with_the_contracts_keys(workload, trace,
                                                         cpu):
    check_small_run(small_cell(workload), 2**31 + 11, trace, cpu)


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
    needs no code: each batch retiles, and the check holds."""
    cell = small_cell("ba20.update_del")
    cell.mix.update(deletes=16, inserts=16, insert_pool=4096)
    result, run = harness.run_cell(cell, 2**31 + 12, 0.4, True, cpu)
    assert result["correct"] is True and run.ops > 0
    assert run.retiles == run.ops


@pytest.mark.parametrize("inserts", [0, 16])
def test_the_warm_up_leaves_the_engine_as_the_build_left_it(inserts, cpu):
    """The warm-up runs the window's batch 0, twice where traced, on a
    copy of the engine: the window's engine holds only the build's
    tiling, so that a deployment's first batch, never seen before, is
    not served from a cache the warm-up filled."""
    cell = small_cell("ba20.update_del")
    cell.mix.update(deletes=16, inserts=inserts, insert_pool=4096)
    run = harness.Run(cell.name, "update", cell.config, cell.mix)
    st, _ = harness.setup_cell(harness.Program(), cell, 2**31 + 14, cpu,
                               run, harness.Tracer(True, cpu))
    assert st.engine.retile_count == 1
    assert st.engine.plan_cache_hits == st.engine.stale_cache_retiles == 0


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


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace_ops", [1, 2, 10**6])
def test_the_traced_stretches_hold_the_ops_they_traced(workload, trace_ops,
                                                       cpu):
    """The first stretch holds the window's first `trace_ops` ops, the
    second the next `trace_ops`; a window that ends inside a stretch
    keeps the ops it traced so far (with 10**6 the first stretch is all
    the window, and there is no second; a window that ends as the first
    stretch does leaves the second with no ops)."""
    cell = small_cell(workload)
    cell.mix["trace_ops"] = trace_ops
    _, run = harness.run_cell(cell, 2**31 + 14, 0.4, True, cpu)
    first = min(run.ops, trace_ops)
    second = min(run.ops - first, trace_ops)
    waves = (lambda r: r["bibfs"]) if run.kind == "query" \
        else harness.update_waves
    assert run.traced["ops"] == first
    assert run.traced["waves"] == sum(map(waves, run.per_op[:first]))
    assert run.traced["bytes"] > 0
    assert run.traced["summary"] is not None
    if run.spans is None:
        # The second stretch starts once the first has all its ops.
        assert run.ops < trace_ops
    else:
        assert run.spans["ops"] == second
        assert run.spans["waves"] == sum(map(
            waves, run.per_op[first:first + second]))
        assert (run.spans["reduced"]["window_s"] > 0) == (second > 0)
    # Every op of the window counted its host reads.
    assert len(run.per_op) == run.ops
    assert all(r["reads"] > 0 for r in run.per_op)


def test_a_window_shorter_than_the_traced_stretch_keeps_it(cpu):
    cell = small_cell("ba20.update_del")
    cell.mix["trace_ops"] = 10**6
    result, run = harness.run_cell(cell, 2**31 + 15, 0.4, True, cpu)
    assert result["correct"] is True
    assert 0 < run.traced["ops"] == run.ops < cell.mix["trace_ops"]
    assert run.traced["bytes"] > 0 and "summary" in run.traced
    assert run.spans is None


def test_an_untraced_run_counts_no_reads(cpu):
    """The untraced window (every end-to-end metric's) reads no counter
    and profiles nothing."""
    _, run = harness.run_cell(small_cell("ba20.query"), 2**31 + 16, 0.2,
                              False, cpu)
    assert run.traced is None and run.spans is None
    assert all("reads" not in r for r in run.per_op)
