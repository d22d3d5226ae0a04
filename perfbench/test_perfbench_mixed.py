"""A cell with insertions in every batch, added as data alone: the cell
a later change would add as `ba20.update_mixed` (half deletions, half
insertions, every batch retiling), in a spec built here with its mix
written beside copies of the benchmark's files, held to every check the
benchmark's own cells are held to."""
from __future__ import annotations

import copy
import json
import shutil

import pytest

from perfbench import control, harness
from perfbench.conftest import ROOT, small_cell
from perfbench.test_perfbench_run import check_small_run
from perfbench.test_perfbench_spec import check_spec

CELL = {"name": "ba20.update_mixed", "config": "ba20",
        "traffic": "update_mixed", "chips": 1,
        "why": "closed loop of batches of 512 deletions and 512 new edges: "
               "insertion placement, a BHL+ search seeded by the inserted "
               "edges, a host retile every batch"}
MIX = {"about": "Closed-loop batches of 512 deletions and 512 insertions "
                "of new pairs, back to back: the paper's fully dynamic "
                "setting.",
       "kind": "update", "deletes": 512, "inserts": 512,
       "insert_pool": 1 << 20, "trace_ops": 4}
# The cell whose metrics the mixed cell reports too.
LIKE = "ba20.update_del"


@pytest.fixture
def mixed(tmp_path):
    """(spec, root): the benchmark's spec with the mixed cell appended to
    its cells and to the lists of the update cells' metrics, and a root
    that holds its configurations and mixes."""
    spec = copy.deepcopy(harness.load_spec())
    spec["workloads"].append(dict(CELL))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(CELL["name"])
    for sub in ("configs", "traffic"):
        shutil.copytree(ROOT / "perfbench" / sub, tmp_path / "perfbench" / sub)
    (tmp_path / "perfbench" / "traffic" / "update_mixed.json").write_text(
        json.dumps(MIX))
    return spec, tmp_path


def test_the_mixed_cell_meets_the_spec_contract(mixed):
    spec, root = mixed
    check_spec(spec, root)
    cell = harness.resolve(spec, CELL["name"], root)
    assert cell.mix == MIX
    like = harness.resolve(spec, LIKE, root)
    assert [m["name"] for m in cell.end_to_end] == \
        [m["name"] for m in like.end_to_end]
    assert [m["name"] for m in cell.per_layer] == \
        [m["name"] for m in like.per_layer]


@pytest.mark.parametrize("trace", [False, True])
def test_the_mixed_cell_runs_correct(mixed, trace, cpu):
    cell = small_cell(CELL["name"], *mixed)
    assert cell.mix["inserts"] > 0
    _, run = check_small_run(cell, 2**31 + 17, trace, cpu)
    assert run.retiles == run.ops


def test_the_mixed_cells_control_fails_and_the_program_passes(mixed, cpu):
    sides = dict(control.readings(small_cell(CELL["name"], *mixed),
                                  2**31 + 98, 0.4, cpu))
    numbers = [k for k, v in sides["program"].items()
               if isinstance(v, tuple)]
    assert all(sides["program"][k][0] <= sides["program"][k][1]
               for k in numbers)
    assert any(sides["control"][k][0] > sides["control"][k][1]
               for k in numbers)
