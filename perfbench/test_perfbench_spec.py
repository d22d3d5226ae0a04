"""`BENCHMARK.json` against the benchmark's contract, and every name in
it resolved to its file: cells, configurations, mixes, graph families and
metric readers. Each check is a function of the spec, so that a spec
with a cell a later change would add can be held to the same."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.conftest import ROOT, workloads

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KINDS = ("query", "update")


def check_top_level(spec: dict) -> None:
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # A full check of 24 cells fits the check's time.
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert spec["paths"] == ["perfbench"]
    assert spec["command"][1:] == ["perfbench/run.py"]
    assert (ROOT / spec["command"][1]).is_file()


def test_top_level_keys_and_window():
    check_top_level(SPEC)


def check_entries(spec: dict) -> None:
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    names = []
    for group, want in keys.items():
        assert 1 <= len(spec[group])
        for entry in spec[group]:
            assert set(entry) - {"workloads"} == want, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" \
                        and group != "per_layer":
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))


def test_entries_have_the_contract_keys_and_names():
    check_entries(SPEC)


def check_metrics(spec: dict) -> None:
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    # Every cell reports set-up, another end-to-end and a per-layer metric.
    for cell in cells:
        mine = [m for m in spec["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(cell in m["workloads"] for m in spec["per_layer"])


def test_metrics_follow_the_contract():
    check_metrics(SPEC)


def check_cell_resolves(spec: dict, workload: str, root=ROOT) -> None:
    from perfbench import harness
    cell = harness.resolve(spec, workload, root)
    entry = next(w for w in spec["workloads"] if w["name"] == workload)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert cell.mix["kind"] in KINDS
    family = harness.HERE / "graphs" / f"{cell.config['family']}.py"
    assert callable(harness.load_module(family).generate)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module(
            harness.metric_path(m["name"])).read)


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_resolves_by_name(workload):
    check_cell_resolves(SPEC, workload)


def check_configuration(spec: dict, conf: str, root=ROOT) -> None:
    entry = next(c for c in spec["configs"] if c["name"] == conf)
    assert entry["file"].startswith("perfbench/configs/")
    body = json.loads((root / entry["file"]).read_text())
    assert body["name"] == conf and body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(body["assumed"])
    for key in ("n", "graph_seed", "edge_capacity", "landmarks", "variant",
                "block_v", "guarantees"):
        assert key in body


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_every_configuration_file_states_itself(conf):
    check_configuration(SPEC, conf)


def check_spec(spec: dict, root=ROOT) -> None:
    """Every check above, on `spec` with its files under `root`."""
    check_top_level(spec)
    check_entries(spec)
    check_metrics(spec)
    for w in spec["workloads"]:
        check_cell_resolves(spec, w["name"], root)
    for c in spec["configs"]:
        check_configuration(spec, c["name"], root)
