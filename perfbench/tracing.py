"""The traced stretches of a run: `torch.profiler` over the first ops of
the window, and over as many more with the program's own spans on,
reduced to what the per-layer metrics and the breakdown read.

The harness wraps each call into a layer of the program in a span of its
own (`SPANS`, `torch.profiler.record_function`); the device's kernels,
copies and fills come from the profiler's device records. From them:

* `window_s`: from the start of the first traced span to the end of the
  last, on the profiler's clock;
* `busy_s`: the union of the device records' intervals in that window;
* `kernels`: device seconds and records by name, in the window;
* `idle`: each gap in the device's work, charged to the innermost span
  the host was in at the gap's middle ("loop" outside every span).

The second stretch, with the program's spans on, is reduced by
`spans.reduce` alone: the first stays as it was read before the program
had spans, since the spans cost the device some idle time.
"""
from __future__ import annotations

import contextlib

import torch

#: The harness's spans, one around each call into a layer of the program.
SPANS = ("make_batch", "apply_batch", "prepare", "batchhl_update",
         "batched_query", "sync")


def _events(prof) -> list[tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every record, from the
    profiler's raw results (building its event tree takes minutes here)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        on_dev = e.device_type() != torch.autograd.DeviceType.CPU
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if on_dev and (annotation or e.name() in SPANS):
            continue   # the device side of a span, not work
        out.append((e.name(), on_dev, start, start + e.duration_ns() * 1e-9))
    return out


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof) -> dict:
    """The traced span's window, busy time, kernels and idle gaps."""
    events = _events(prof)
    spans = [(a, b, name) for name, dev, a, b in events
             if not dev and name in SPANS]
    if not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "idle": {}}
    w0 = min(a for a, _, _ in spans)
    w1 = max(b for _, b, _ in spans)
    kernels: dict[str, list] = {}
    clipped = []
    for name, dev, a, b in events:
        if not dev:
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += b - a
        row[1] += 1
    busy = _union(clipped)
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inside = [(e - s, name) for s, e, name in spans if s <= mid <= e]
        name = min(inside)[1] if inside else "loop"
        idle[name] = idle.get(name, 0.0) + (b - a)
    return {"window_s": w1 - w0, "busy_s": sum(b - a for a, b in busy),
            "kernels": kernels, "idle": idle}


class Tracer:
    """Spans always when tracing; the profiler only over the traced
    stretches.

    `warm()` runs the profiler once in set-up, so that its start-up is
    not in the window; `start()`/`stop()` bracket the first stretch's
    ops, `start_spans(trace)`/`stop()` the second's, with the program's
    trace module `trace` turned on inside the profiler.
    """

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self._done = None
        self._spans = None        # the second stretch's profiler, stopped
        self._trace = None        # the program's trace module, while on
        self.summary: dict | None = None
        self.reduced: dict | None = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, fn) -> None:
        if not self.enabled:
            return
        with self._profiler():
            fn()
            self._sync()

    def start(self) -> None:
        if self.enabled and self.prof is None and self._done is None:
            self._sync()
            self.prof = self._profiler()
            self.prof.__enter__()

    def start_spans(self, trace) -> None:
        """The second stretch: the profiler again, and inside it the
        program's spans (`trace.enable(True)`)."""
        if self.enabled and self.prof is None and self._spans is None:
            self._sync()
            self.prof = self._profiler()
            self.prof.__enter__()
            self._trace = trace
            trace.enable(True)

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> None:
        if self.prof is None:
            return
        if self._trace is not None:
            self._trace.enable(False)
        self._sync()
        prof, self.prof = self.prof, None
        if self._trace is not None:
            self._trace, self._spans = None, prof
        else:
            self._done = prof
        prof.__exit__(None, None, None)

    def finish(self) -> dict | None:
        """The first stretch's summary; the second's reduction by span
        goes to `reduced` (each reduced once the window is over)."""
        if self._spans is not None:
            from perfbench.spans import reduce
            self.reduced = reduce(self._spans.profiler.kineto_results
                                  .events())
            self._spans = None
        if self.summary is None and self._done is not None:
            self.summary = summarize(self._done)
            self._done = None
        return self.summary
