"""Spans and host-read counts inside the port, on the profiler's clock.

`span(name)` marks a stage of the query and update paths (the bound, the
BiBFS and each of its waves, the batch search, the repair's stages, each
fixpoint wave, the engine's prepare) and `host_read(site, x)` each read of
a device value on the host. Both are for an operator, or a benchmark,
that traces the program with its own `torch.profiler` window:

    from repro_torch import trace
    trace.enable(True)
    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        ...                  # calls into the program
    trace.enable(False)

While tracing is on, a span is `torch.profiler.record_function(name)`, so
it lands in the profiler's Kineto trace beside the device's records, on
one clock: every device record can be tied, by its correlation id, to the
launch under a span, and every idle gap placed under what the host was
doing. While it is off (the default) `span` returns one shared null
context and enters nothing: `record_function` goes through the
dispatcher and costs microseconds even with no profiler running.

`HOST_READS` counts every read by site, on or off, as `engine.WAVES`
counts waves: the caller clears it, runs, and reads it. A read stays where
it was, and returns what `.tolist()` returns; while tracing is on it runs
under the span `read.<site>`, in which the host waits for the device.

This module imports nothing of the port, so `graphs/coo.py` can use it.
"""
from __future__ import annotations

import collections
import contextlib

import torch

#: The sites of the host reads on the query and update paths.
SITES = ("query.bibfs", "fixpoint", "prepare.observe", "prepare.retile",
         "frontier", "batch_requirements")

#: Host reads per site since the last `HOST_READS.clear()`.
HOST_READS: collections.Counter = collections.Counter()

_READ_SPANS = {site: "read." + site for site in SITES}
_WAVE_SPANS: dict[str, str] = {}
_OFF = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Turn the spans on or off (off at import)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A profiler span named `name` while tracing is on, else the shared
    null context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


def wave_span(kind: str) -> str:
    """The span name of one wave of fixpoint `kind`: "wave.<kind>", made
    once per kind."""
    name = _WAVE_SPANS.get(kind)
    if name is None:
        name = _WAVE_SPANS[kind] = "wave." + kind
    return name


def _read(site: str, pull, x: torch.Tensor):
    name = _READ_SPANS[site]      # a site of SITES, on or off
    HOST_READS[site] += 1
    if not _on:
        return pull(x)
    with torch.profiler.record_function(name):
        return pull(x)


def host_read(site: str, x: torch.Tensor):
    """`x.tolist()` (a Python number for a 0-d `x`), counted at `site`."""
    return _read(site, torch.Tensor.tolist, x)


def host_array(site: str, x: torch.Tensor):
    """`x.cpu().numpy()`, counted at `site`."""
    return _read(site, _numpy, x)


def _numpy(x: torch.Tensor):
    return x.cpu().numpy()
