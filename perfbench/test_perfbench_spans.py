"""The reduction of a traced span by the program's spans (`spans.py`), on
synthetic Kineto-like event lists: a device record goes to the span
around its correlated launch, idle to the innermost span, and the
harness's own reduction (`tracing.summarize`) reads the same with and
without the program's spans."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import spans, tracing

KERNEL = "void (anonymous namespace)::relax_sweep_kernel<false>(int const*)"
GATHER = "void at::native::index_elementwise_kernel<128, 4>(int)"


class Event:
    """One Kineto event: a host span (`kind` "span"), a runtime launch
    ("launch"), a device record ("kernel") or a span's device side
    ("gpu_span")."""

    def __init__(self, kind, name, start_s, end_s, corr=0):
        self._kind, self._dev = kind, kind in ("kernel", "gpu_span")
        self._name, self._s, self._e, self._c = name, start_s, end_s, corr

    def name(self):
        return self._name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._kind in ("span", "gpu_span")

    def start_ns(self):
        return int(round(self._s * 1e9))

    def duration_ns(self):
        return int(round((self._e - self._s) * 1e9))

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def prof_of(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def update_trace(program_spans: bool, skew: float = 0.0) -> list:
    """One batch: the harness's `batchhl_update` [0, 10] and `sync`
    [10, 12]; with the program's spans, `bhl.search` [1, 3] and
    `bhl.repair` [5, 9] holding `wave.repair` [5, 9] and its
    `read.fixpoint` [8, 9]. Two kernels launched under the search, the
    second queued behind the first until the host is in the repair; one
    launched in the repair's wave, which the read waits for; and one
    launched after the read. The device's clock reads `skew` s ahead."""
    ev = [Event("span", "batchhl_update", 0.0, 10.0),
          Event("span", "sync", 10.0, 12.0),
          Event("launch", "cudaLaunchKernel", 1.5, 1.6, corr=11),
          Event("launch", "cudaLaunchKernel", 2.5, 2.6, corr=12),
          Event("launch", "cudaLaunchKernel", 5.5, 5.6, corr=13),
          # A torch op whose correlation id, of another series, is 13 too.
          Event("op", "aten::index", 5.4, 5.7, corr=13),
          Event("launch", "cudaLaunchKernel", 9.2, 9.3, corr=14)]
    dev = [Event("kernel", GATHER, 1.7, 5.0, corr=11),
           Event("kernel", GATHER, 5.0, 7.0, corr=12),
           Event("kernel", KERNEL, 7.0, 8.0, corr=13),
           Event("kernel", GATHER, 9.25, 9.75, corr=14),
           Event("gpu_span", "batchhl_update", 1.7, 9.75)]
    if program_spans:
        ev += [Event("span", "bhl.search", 1.0, 3.0),
               Event("span", "bhl.repair", 5.0, 9.0),
               Event("span", "wave.repair", 5.0, 9.0),
               Event("span", "read.fixpoint", 8.0, 9.0)]
        dev += [Event("gpu_span", "bhl.search", 1.7, 7.0),
                Event("gpu_span", "bhl.repair", 7.0, 8.0)]
    return ev + [Event(e._kind, e._name, e._s + skew, e._e + skew, e._c)
                 for e in dev]


def test_a_record_goes_to_the_span_of_its_launch_not_of_its_time():
    s = spans.reduce(update_trace(True))
    st = s["stacks"]
    # Launched under bhl.search (at 2.5), run while the host is in
    # bhl.repair (5-7): the search's.
    assert st["batchhl_update/bhl.search"]["device"] \
        == {GATHER: pytest.approx(3.3 + 2.0)}
    assert st["batchhl_update/bhl.repair/wave.repair"]["device"] \
        == {KERNEL: pytest.approx(1.0)}
    assert st["batchhl_update"]["device"] == {GATHER: pytest.approx(0.5)}
    assert not st["batchhl_update/bhl.repair"]["device"]
    assert s["spans"]["bhl.search"]["device_s"] == pytest.approx(5.3)
    assert s["unattributed"] == 0 and s["unattributed_s"] == 0.0
    device, _ = spans.under(s, lambda name: name.startswith("bhl."))
    assert device == {GATHER: pytest.approx(5.3), KERNEL: pytest.approx(1.0)}


@pytest.mark.parametrize("skew", [0.0, 0.9, -0.6])
def test_idle_goes_to_the_innermost_program_span(skew):
    """Busy 1.7-8.0 and 9.25-9.75 in the window 0-12. Gaps: 0-1.7, ended
    by the kernel launched at 1.5 (middle 0.65: batchhl_update alone);
    8.0-9.25, ended by the kernel launched at 9.2 (middle 8.575: the
    read); 9.75-12 (middle 10.875: sync). The same on a device clock
    that reads ahead or behind."""
    s = spans.reduce(update_trace(True, skew))
    st = s["stacks"]
    assert st["batchhl_update"]["idle_s"] == pytest.approx(1.7 + skew)
    read = st["batchhl_update/bhl.repair/wave.repair/read.fixpoint"]
    assert read["idle_s"] == pytest.approx(1.25)
    assert s["spans"]["read.fixpoint"]["idle_s"] == pytest.approx(1.25)
    assert st["sync"]["idle_s"] == pytest.approx(12 - 9.75 - skew)
    _, idle = spans.under(s, lambda name: name.startswith("bhl."))
    assert idle == pytest.approx(1.25)


def test_self_time_is_the_span_less_its_children():
    s = spans.reduce(update_trace(True))["spans"]
    assert s["batchhl_update"]["self_s"] == pytest.approx(10 - 2 - 4)
    assert s["bhl.repair"]["self_s"] == pytest.approx(0.0)
    assert s["wave.repair"]["self_s"] == pytest.approx(3.0)
    assert s["read.fixpoint"] == {"count": 1, "self_s": pytest.approx(1.0),
                                  "device_s": 0.0,
                                  "idle_s": pytest.approx(1.25)}


def test_the_harness_reduction_reads_the_same_with_program_spans():
    """`summarize`'s window, busy time and kernels do not move when the
    program's spans (and their device side) join the trace; `reduce`
    reads the same window and busy time."""
    off = tracing.summarize(prof_of(update_trace(False)))
    on = tracing.summarize(prof_of(update_trace(True)))
    for key in ("window_s", "busy_s", "kernels"):
        assert on[key] == off[key]
    assert set(on["kernels"]) == {KERNEL, GATHER}
    s = spans.reduce(update_trace(True))
    assert s["window_s"] == pytest.approx(on["window_s"])
    assert s["busy_s"] == pytest.approx(on["busy_s"])


def test_a_record_whose_launch_was_lost_is_unattributed():
    # The launch lost; the torch op of correlation id 13 is no launch.
    ev = [e for e in update_trace(True) if e.correlation_id() != 13
          or e.name() != "cudaLaunchKernel"]
    s = spans.reduce(ev)
    assert s["unattributed"] == 1
    assert s["unattributed_s"] == pytest.approx(1.0)
    assert KERNEL not in str(s["stacks"])
    # Busy time still counts it.
    assert s["busy_s"] == pytest.approx(6.3 + 0.5)


@pytest.mark.parametrize("skew, in_order", [(0.0, 1), (spans.CLOCK_SLACK_S
                                                       / 2, 1), (1.5, 0)])
def test_reads_end_after_the_device_work_before_them(skew, in_order):
    """read.fixpoint [8, 9] waits for the kernel launched last before 8
    (at 5.5), here ending at 9.0 + `skew` on the device's clock: in order
    unless that is more than the slack past the read's end."""
    ev = [e for e in update_trace(True) if e.name() != KERNEL]
    ev.append(Event("kernel", KERNEL, 7.0, 9.0 + skew, corr=13))
    assert spans.reduce(ev)["reads"] == {"spans": 1, "in_order": in_order}


def test_a_trace_without_the_harness_spans_reads_nothing():
    ev = [e for e in update_trace(True)
          if e.name() not in tracing.SPANS]
    s = spans.reduce(ev)
    assert s["window_s"] == 0.0 and s["stacks"] == {}
