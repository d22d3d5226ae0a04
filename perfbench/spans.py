"""The traced span of a run by the program's own spans: what each stage
of the program launched on the device, and where the device idled.

`tracing.summarize` reduces a trace by kernel name and charges idle gaps
to the harness's spans (`tracing.SPANS`). With the program's spans on
(`repro_torch.trace.enable(True)`) the same Kineto trace holds them too,
nested inside the harness's, on the clock of the runtime's launches.
`reduce` ties each device record to its runtime launch by the Kineto
correlation id (never by time overlap) and charges it to the innermost
span, harness or program, open on the host when it was launched:

* `stacks`: per chain of nested span names (outermost first, joined by
  "/"; "loop" outside every span) the spans' count and host self time
  (each span's duration less its children's), the device seconds of the
  records launched innermost under it, by kernel name, and the idle gaps
  charged to it (each gap to the innermost span at its middle);
* `spans`: the same per span name (a chain's last name), device seconds
  summed over kernels;
* `unattributed_s` / `unattributed`: records whose launch the profiler
  lost, which no span can claim;
* `reads`: how many `read.*` spans end no earlier than `CLOCK_SLACK_S`
  before the end of the last device record launched before they began:
  a host read waits for the device, so on a shared clock (nearly) all do.

A gap's middle is taken on the host's clock: the gap ends when the
record after it was launched (an idle device starts a record within
microseconds of its launch), and its middle lies half its length before
that launch. On an H100 with torch 2.11 and CUDA 12.8 the device records'
clock drifted from the host's in some traced runs (by up to 76 ms over
a 2 s window; a host read then "ended" before the copy it waited for),
while
a record's duration and the launches' times on the host's clock held;
so neither a record's span nor a gap's is read off the device's clock.
`reads` shows how far the two clocks agreed.

`window_s` is bounded as `summarize` bounds it, by the harness's spans
alone, and `busy_s` is the union of the device records in it; the device
side of a span, the harness's or the program's, is not work.
"""
from __future__ import annotations

import bisect
import re

import torch

from perfbench.tracing import SPANS, _union

#: The name of a CUDA API call on the host (`cuda*`, `cu*`: a launch, a
#: copy, a fill), whose correlation id its device record shares. Torch's
#: ops carry correlation ids of another series, so the name tells them
#: apart (torch 2.11's Kineto events give no activity type).
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
#: How early a read span may end before the device work it waits for:
#: the clocks' skew, and the host's wake-up after the device's last write.
CLOCK_SLACK_S = 5e-6


def is_annotation(e) -> bool:
    return getattr(e, "is_user_annotation", lambda: False)()


def _split(events):
    """(host spans, launch start by correlation id, device records) of a
    trace: spans as (start s, end s, name), records as (name, start s,
    end s, correlation id). A device record and the runtime call that
    launched it share a correlation id (CUPTI's)."""
    spans, launches, records = [], {}, []
    host = torch.autograd.DeviceType.CPU
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == host:
            if is_annotation(e):
                spans.append((start, end, e.name()))
            elif LAUNCH.match(e.name()):
                launches[e.correlation_id()] = start
        elif not is_annotation(e):
            records.append((e.name(), start, end, e.correlation_id()))
    # The device side of a span, whether or not it reads as an annotation.
    names = {name for _, _, name in spans}
    records = [r for r in records if r[0] not in names]
    return spans, launches, records


class _Tree:
    """Host spans nested by their intervals (one host thread's spans
    nest): each span's parent, chain of names and self time, and the
    innermost span at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent: list[int] = []
        self.chain: list[str] = []
        self.self_s: list[float] = []
        stack: list[int] = []
        for i, (a, b, name) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < b:
                stack.pop()
            up = stack[-1] if stack else -1
            self.parent.append(up)
            self.chain.append(name if up < 0 else
                              self.chain[up] + "/" + name)
            self.self_s.append(b - a)
            if up >= 0:
                self.self_s[up] -= b - a
            stack.append(i)

    def at(self, t: float) -> str:
        """The chain of the innermost span open at time t, or "loop"."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.chain[i] if i >= 0 else "loop"


def _stack(stacks: dict, chain: str) -> dict:
    return stacks.setdefault(chain, {"count": 0, "self_s": 0.0,
                                     "idle_s": 0.0, "device": {}})


def reduce(events) -> dict:
    """The traced span of Kineto `events` by span (module docstring)."""
    spans, launches, records = _split(events)
    outer = [s for s in spans if s[2] in SPANS]
    if not outer:
        return {"window_s": 0.0, "busy_s": 0.0, "stacks": {}, "spans": {},
                "unattributed_s": 0.0, "unattributed": 0,
                "reads": {"spans": 0, "in_order": 0}}
    w0 = min(a for a, _, _ in outer)
    w1 = max(b for _, b, _ in outer)
    tree = _Tree(spans)
    stacks: dict[str, dict] = {}
    for i, chain in enumerate(tree.chain):
        st = _stack(stacks, chain)
        st["count"] += 1
        st["self_s"] += tree.self_s[i]
    clipped, launched = [], []
    woke: dict[float, float] = {}    # record start -> its launch
    lost_s, lost = 0.0, 0
    for name, a, b, corr in records:
        at = launches.get(corr)
        if at is not None:
            launched.append((at, b))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        if at is not None:
            woke.setdefault(a, at)
        if at is None:
            lost_s += b - a
            lost += 1
            continue
        dev = _stack(stacks, tree.at(at))["device"]
        dev[name] = dev.get(name, 0.0) + (b - a)
    busy = _union(clipped)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            # The record that ends a gap ran as soon as it was launched:
            # on the host's clock the gap ends at that launch.
            mid = woke.get(a, a) - (a - edge) / 2
            _stack(stacks, tree.at(mid))["idle_s"] += a - edge
        edge = max(edge, b)
    by_name: dict[str, dict] = {}
    for chain, st in stacks.items():
        row = by_name.setdefault(chain.rsplit("/", 1)[-1], {
            "count": 0, "self_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
        row["count"] += st["count"]
        row["self_s"] += st["self_s"]
        row["idle_s"] += st["idle_s"]
        row["device_s"] += sum(st["device"].values())
    return {"window_s": w1 - w0, "busy_s": sum(b - a for a, b in busy),
            "stacks": stacks, "spans": by_name, "unattributed_s": lost_s,
            "unattributed": lost, "reads": _reads_in_order(spans, launched)}


def _reads_in_order(spans, launched) -> dict:
    """Of the `read.*` spans, how many end no earlier than CLOCK_SLACK_S
    before the end of the device record launched last before they
    began (reads with no launch before them are not counted)."""
    launched.sort()
    at = [t for t, _ in launched]
    n = ok = 0
    for a, b, name in spans:
        if not name.startswith("read."):
            continue
        i = bisect.bisect_left(at, a) - 1
        if i < 0:
            continue
        n += 1
        ok += b >= launched[i][1] - CLOCK_SLACK_S
    return {"spans": n, "in_order": ok}


def under(summary: dict, pick) -> tuple[dict, float]:
    """(device seconds by kernel name, idle seconds) charged to the
    chains that hold a span name for which `pick(name)` is true, each
    chain once."""
    device: dict[str, float] = {}
    idle = 0.0
    for chain, st in summary.get("stacks", {}).items():
        if any(pick(name) for name in chain.split("/")):
            idle += st["idle_s"]
            for k, s in st["device"].items():
                device[k] = device.get(k, 0.0) + s
    return device, idle


def ran(summary: dict, pick) -> bool:
    """Whether the reduction holds device records and a span for which
    `pick(name)` is true: else a reader of it has nothing to read."""
    return summary.get("busy_s", 0) > 0 and any(
        pick(name) for name in summary.get("spans", {}))


def device_ms_per_op(summary: dict, ops: int, pick,
                     keep=lambda kernel: True):
    """Device ms an op launched under the spans `pick` takes (`under`),
    of the kernels for which `keep(name)` is true; None where nothing
    of it ran."""
    if not ops or not ran(summary, pick):
        return None
    device, _ = under(summary, pick)
    return 1e3 * sum(s for k, s in device.items() if keep(k)) / ops


def idle_us_per_wave(summary: dict, waves: int, pick):
    """Idle µs a wave charged to the spans `pick` takes (`under`); None
    where nothing of it ran."""
    if not waves or not ran(summary, pick):
        return None
    return 1e6 * under(summary, pick)[1] / waves
