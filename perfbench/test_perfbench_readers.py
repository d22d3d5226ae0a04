"""The readers of the program's spans and host reads (`metrics/`), on
runs whose second traced stretch is a synthetic reduction (events built
as `test_perfbench_spans.py` builds them): each value, and nothing read
where the stretch holds no device record."""
from __future__ import annotations

import pytest

from perfbench import harness, spans
from perfbench.test_perfbench_spans import GATHER, KERNEL, Event, \
    update_trace

MINPLUS = "void (anonymous namespace)::minplus_kernel<32>(int const*)"


def reader(name: str):
    return harness.load_module(harness.metric_path(name)).read


def query_trace() -> list:
    """One microbatch: `batched_query` [0, 10] holding `query.bound`
    [1, 2] and `query.bibfs` [2, 9], which holds a wave [3, 6] and a read
    [6, 7]; `sync` [10, 11]. Kernel B launched under the bound (device
    1.3-1.8); the plane's seeding under `query.bibfs` (2.6-3.0); kernel A
    (3.6-5.0) and a plane op (5.0-5.5) under the wave."""
    return [Event("span", "batched_query", 0.0, 10.0),
            Event("span", "query.bound", 1.0, 2.0),
            Event("span", "query.bibfs", 2.0, 9.0),
            Event("span", "query.bibfs.wave", 3.0, 6.0),
            Event("span", "read.query.bibfs", 6.0, 7.0),
            Event("span", "sync", 10.0, 11.0),
            Event("launch", "cudaLaunchKernel", 1.2, 1.25, corr=21),
            Event("launch", "cudaLaunchKernel", 2.5, 2.55, corr=24),
            Event("launch", "cudaLaunchKernel", 3.5, 3.55, corr=22),
            Event("launch", "cudaLaunchKernel", 4.0, 4.05, corr=23),
            Event("kernel", MINPLUS, 1.3, 1.8, corr=21),
            Event("kernel", GATHER, 2.6, 3.0, corr=24),
            Event("kernel", KERNEL, 3.6, 5.0, corr=22),
            Event("kernel", GATHER, 5.0, 5.5, corr=23)]


def masks_trace() -> list:
    """`update_trace` with `bhl.edge_masks` [3.5, 4.5] in the batch,
    whose one launch (3.6) runs 3.7-4.2 beside the search's record."""
    return update_trace(True) + [
        Event("span", "bhl.edge_masks", 3.5, 4.5),
        Event("launch", "cudaLaunchKernel", 3.6, 3.65, corr=15),
        Event("kernel", GATHER, 3.7, 4.2, corr=15)]


def run_of(kind: str, events: list, ops: int, waves: int,
           reads=None) -> harness.Run:
    run = harness.Run("cell", kind, {}, {})
    run.spans = {"ops": ops, "waves": waves, "reduced": spans.reduce(events)}
    run.ops = len(reads or [])
    run.per_op = [{"reads": r} for r in reads or []]
    return run


def no_device(events: list) -> list:
    return [e for e in events if e._kind not in ("kernel", "gpu_span")]


def test_bound_ms_is_the_device_time_launched_under_the_bound():
    # Kernel B's 0.5 s, over two microbatches.
    run = run_of("query", query_trace(), ops=2, waves=3)
    assert reader("bound_ms.query")(run) == pytest.approx(250.0)


def test_plane_ms_is_the_bibfs_device_time_less_kernel_a():
    # The seeding's 0.4 s and the wave's plane op 0.5 s; kernel A's 1.4 s
    # under the same wave not counted.
    run = run_of("query", query_trace(), ops=2, waves=3)
    assert reader("plane_ms.query")(run) == pytest.approx(450.0)


def test_wave_idle_us_query_is_the_idle_under_the_waves_and_reads():
    """With the read's copy launched at 6.9 (device 6.95-7.0): gaps
    3.0-3.6 (ended by the launch at 3.5: middle 3.2, in the wave) and
    5.5-6.95 (middle 6.175, in the read), 2.05 s a wave's. Not the
    BiBFS's own gaps 1.8-2.6 (its seeding: middle 2.1) and 7.0-11
    (its end: middle 9.0), nor 0-1.3 (`batched_query`'s)."""
    events = query_trace() + [
        Event("launch", "cudaMemcpyAsync", 6.9, 6.92, corr=25),
        Event("kernel", "Memcpy DtoH (Device -> Pinned)", 6.95, 7.0,
              corr=25)]
    run = run_of("query", events, ops=2, waves=3)
    assert reader("wave_idle_us.query")(run) == pytest.approx(2.05e6 / 3)


def test_edge_masks_ms_is_the_device_time_launched_under_the_masks():
    run = run_of("update", masks_trace(), ops=2, waves=5)
    assert reader("edge_masks_ms.update")(run) == pytest.approx(250.0)


@pytest.mark.parametrize("span, idle_s", [("bhl.seed_weights", 1.25),
                                          ("bhl.repair_base", 2.95)])
def test_wave_idle_us_update_is_the_idle_under_the_waves(span, idle_s):
    """The read's gap 8.0-9.25 lies in `wave.repair`; the masks' record
    falls inside busy time and moves no gap. The gap 0-1.7 (ended by the
    launch at 1.5: middle 0.65) lies in `span` [0.5, 1.0]: the boundary
    sweep is a wave, the seed weights are not."""
    events = masks_trace() + [Event("span", span, 0.5, 1.0)]
    run = run_of("update", events, ops=2, waves=5)
    assert reader("wave_idle_us.update")(run) == pytest.approx(idle_s * 1e6
                                                               / 5)


@pytest.mark.parametrize("name, kind, events", [
    ("bound_ms.query", "query", query_trace()),
    ("plane_ms.query", "query", query_trace()),
    ("wave_idle_us.query", "query", query_trace()),
    ("edge_masks_ms.update", "update", masks_trace()),
    ("wave_idle_us.update", "update", masks_trace())])
def test_a_span_reader_reads_nothing_without_device_records(name, kind,
                                                            events):
    """On the CPU, or where the profiler lost the device: no records;
    nor where the run has no second stretch, or it ran no op."""
    assert reader(name)(run_of(kind, events, 2, 3)) is not None
    assert reader(name)(run_of(kind, no_device(events), 2, 3)) is None
    assert reader(name)(run_of(kind, events, 0, 0)) is None
    empty = run_of(kind, events, 2, 3)
    empty.spans = None
    assert reader(name)(empty) is None


def test_a_span_reader_reads_nothing_where_its_span_did_not_run():
    events = [e for e in query_trace() if e.name() != "query.bound"]
    assert reader("bound_ms.query")(run_of("query", events, 2, 3)) is None
    run = run_of("update", update_trace(True), 2, 5)
    assert reader("edge_masks_ms.update")(run) is None


@pytest.mark.parametrize("name, kind", [("host_syncs.query", "query"),
                                        ("host_syncs.update", "update")])
def test_host_syncs_is_the_mean_of_the_ops_reads(name, kind):
    """A program counter: it reads on the CPU too, and not where the
    ops carry no count (an untraced window)."""
    run = run_of(kind, no_device(query_trace()), 2, 3, reads=[7, 6, 7, 7])
    assert reader(name)(run) == pytest.approx(6.75)
    run.per_op = [{"ms": 1.0}] * 4
    assert reader(name)(run) is None
    run.per_op = []
    assert reader(name)(run) is None
