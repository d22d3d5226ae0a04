#!/usr/bin/env python3
"""The port's spans and host reads on the benchmark's cells, on one GPU.

    python3 tools/probe_spans.py [--cells ba20.query,kron20.update_del]
        [--seconds 20] [--onoff 3] [--traced-on 2] [--traced-off 1]
        [--seed 2147483659] [--device cpu]

For each cell of `BENCHMARK.json` it calls `perfbench.harness.run_cell`
in this one process, each run with a seed of its own:

  onoff   untraced runs, the program's spans (`repro_torch.trace`) off
          and on with no profiler, in turns off, on, on, off, ...: what
          the spans cost by the cell's rates;
  traced  runs with the harness's profiler window (`--trace 1`), the
          spans on and off in turns on, off, on, ...: how far
          `idle_share` moves, and with the spans on the window reduced
          by span (`perfbench/spans.py`).

From a traced run with the spans on it prints the device ms a traced op
launched under `query.bound`, under `query.bibfs` less kernel A's
kernels, and under `bhl.edge_masks`; the idle µs a traced wave charged
to spans under `query.bibfs` (resp. a `bhl.*` span); the chains of spans
with the most device time and the most idle; the share of device time
launched outside every span or whose launch the profiler lost; and how
many `read.*` spans end no earlier than 5 µs before the end of the
device record launched last before they began, with quantiles of how
the device's, the runtime's and the spans' clocks line up
(`clock_study`). Every run gives its
host reads an op over the window (`trace.HOST_READS`, counted around
the harness's op). Each run prints one `probe:` JSON line and appends it
to `chiprun_out/spans/probe.jsonl`, after a first line with the card's
name and power limit. Without a CUDA device it exits 2; `--device cpu`
runs the cells at the CPU tests' size instead (to rehearse; its numbers
are not device numbers).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

OUT = ROOT / "chiprun_out" / "spans"


def census(events, spans_mod) -> dict:
    """The host calls taken as launches, by name, and whether a span's
    device side reads as a user annotation."""
    import torch
    host = torch.autograd.DeviceType.CPU
    events = list(events)
    names = {e.name() for e in events
             if e.device_type() == host and spans_mod.is_annotation(e)}
    launches = collections.Counter(
        e.name() for e in events
        if e.device_type() == host and spans_mod.LAUNCH.match(e.name()))
    return {"launch_names": dict(launches.most_common(8)),
            "gpu_span_is_user_annotation": sorted({
                bool(spans_mod.is_annotation(e)) for e in events
                if e.device_type() != host and e.name() in names})}


def clock_study(events, spans_mod) -> dict:
    """Quantiles (µs) of how the three clocks of a trace line up: a
    device record's start less its launch's (`lead`, never below 0 on
    one clock); for each `read.*` span and the device-to-host copy it
    issued, the copy's launch less the span's start (`in_start`) and the
    span's end less the launch's end (`in_end`, both never below 0 if
    the runtime's host events and the spans share a clock) and the
    span's end less the copy's end (`after_copy`, never below 0 if the
    device's records and the spans do); and the check of
    `spans.reduce`'s `reads`, the end of the record launched last
    before a read span began less the span's end (`lag`). Each over the
    whole window, and over its first and last quarter."""
    import torch
    host = torch.autograd.DeviceType.CPU
    spans, launches, records = [], {}, []
    for e in events:
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        if e.device_type() == host:
            if spans_mod.is_annotation(e):
                spans.append((a, b, e.name()))
            elif spans_mod.LAUNCH.match(e.name()):
                launches[e.correlation_id()] = (a, b)
        elif not spans_mod.is_annotation(e):
            records.append((e.name(), a, b, e.correlation_id()))
    tied = [(launches[c], a, b, n) for n, a, b, c in records
            if c in launches]
    lead = [(la, a - la) for (la, _), a, _, _ in tied]
    copies = sorted((la, lb, b) for (la, lb), _, b, n in tied
                    if "DtoH" in n)
    by_launch = sorted((la, b) for (la, _), _, b, _ in tied)
    c_at = [c[0] for c in copies]
    l_at = [x[0] for x in by_launch]
    in_start, in_end, after, lag = [], [], [], []
    for a, b, name in spans:
        if not name.startswith("read."):
            continue
        i = bisect.bisect_left(c_at, a - 200) if c_at else 0
        near = [c for c in copies[i:i + 8] if c[0] <= b + 200]
        if near:
            la, lb, end = min(near, key=lambda c: abs(c[0] - (a + b) / 2))
            in_start.append((a, la - a))
            in_end.append((a, b - lb))
            after.append((a, b - end))
        j = bisect.bisect_left(l_at, a) - 1
        if j >= 0:
            lag.append((a, by_launch[j][1] - b))
    if not spans:
        return {}
    t0 = min(a for a, _, _ in spans)
    t1 = max(b for _, b, _ in spans)

    def q(pairs):
        out = {}
        for part, lo, hi in (("all", t0, t1),
                             ("first", t0, t0 + (t1 - t0) / 4),
                             ("last", t1 - (t1 - t0) / 4, t1)):
            v = sorted(x for t, x in pairs if lo <= t <= hi)
            if v:
                out[part] = [round(v[0], 2), round(v[len(v) // 100], 2),
                             round(v[len(v) // 2], 2),
                             round(v[-1 - len(v) // 100], 2),
                             round(v[-1], 2), len(v)]
        return out
    return {"lead": q(lead), "in_start": q(in_start), "in_end": q(in_end),
            "after_copy": q(after), "lag": q(lag)}


def stage_numbers(red: dict, run, kernel_of, spans_mod) -> dict:
    """The per-stage numbers of one traced run with the spans on."""
    ops = run.traced["ops"]
    waves = run.traced["waves"]

    def device(pick, keep=lambda name: True):
        dev, _ = spans_mod.under(red, pick)
        return sum(s for k, s in dev.items() if keep(k))

    def idle(pick):
        return spans_mod.under(red, pick)[1]

    total = red["unattributed_s"] + sum(
        sum(st["device"].values()) for st in red["stacks"].values())
    outside = sum(red["stacks"].get("loop", {}).get("device", {}).values())
    out = {"traced_ops": ops, "traced_waves": waves,
           "device_s": total, "unattributed_s": red["unattributed_s"],
           "unattributed": red["unattributed"], "outside_spans_s": outside,
           "attributed_share": (1 - (red["unattributed_s"] + outside) / total
                                if total else None),
           "reads_in_order": red["reads"]}
    if run.kind == "query":
        out["bound_ms"] = 1e3 * device(lambda n: n == "query.bound") / ops
        out["plane_ms"] = 1e3 * device(lambda n: n == "query.bibfs",
                                       lambda k: not kernel_of(k)) / ops
        out["bibfs_kernel_a_ms"] = 1e3 * device(
            lambda n: n == "query.bibfs", kernel_of) / ops
        out["wave_idle_us"] = 1e6 * idle(lambda n: n == "query.bibfs") \
            / waves
    else:
        out["edge_masks_ms"] = 1e3 * device(
            lambda n: n == "bhl.edge_masks") / ops
        out["wave_idle_us"] = 1e6 * idle(lambda n: n.startswith("bhl.")) \
            / waves
    rows = red["stacks"].items()
    out["top_device_ms_per_op"] = [
        [c, 1e3 * sum(st["device"].values()) / ops] for c, st in sorted(
            rows, key=lambda kv: -sum(kv[1]["device"].values()))[:12]]
    out["top_kernels_ms_per_op"] = {
        c: [[k[:72], 1e3 * v / ops] for k, v in sorted(
            st["device"].items(), key=lambda kv: -kv[1])[:3]]
        for c, st in sorted(rows, key=lambda kv: -sum(
            kv[1]["device"].values()))[:6]}
    out["top_idle_ms_per_op"] = [
        [c, 1e3 * st["idle_s"] / ops] for c, st in sorted(
            rows, key=lambda kv: -kv[1]["idle_s"])[:12]]
    out["spans"] = red["spans"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--onoff", type=int, default=3,
                    help="untraced runs per side")
    ap.add_argument("--traced-on", type=int, default=2)
    ap.add_argument("--traced-off", type=int, default=1)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench import spans as spans_mod
    from perfbench.conftest import small_cell
    from repro_torch import trace

    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    kernel_of = harness.load_module(
        harness.metric_path("relax_roofline")).kernel_of

    class SpanTracer(harness.Tracer):
        """The harness's tracer, which also reduces its window by span."""
        last = None

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.by_span = self.census = None
            SpanTracer.last = self

        def finish(self):
            if self.summary is None and self._done is not None:
                events = self._done.profiler.kineto_results.events()
                self.by_span = spans_mod.reduce(events)
                self.census = census(events, spans_mod)
                self.census["clock"] = clock_study(events, spans_mod)
            return super().finish()

    reads_log: list[collections.Counter] = []

    def counted(fn):
        def op(*a, **k):
            before = collections.Counter(trace.HOST_READS)
            out = fn(*a, **k)
            reads_log.append(trace.HOST_READS - before)
            return out
        return op

    harness.Tracer = SpanTracer
    harness.query_op = counted(harness.query_op)
    harness.update_op = counted(harness.update_op)

    spec = harness.load_spec()
    cells = args.cells.split(",") if args.cells else [
        w["name"] for w in spec["workloads"]]
    OUT.mkdir(parents=True, exist_ok=True)
    card = (harness.card_power_limit() if device.type == "cuda"
            else "cpu (rehearsal)")
    head = {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    print("probe: " + json.dumps(head), flush=True)
    with open(OUT / "probe.jsonl", "a") as f:
        f.write(json.dumps(head) + "\n")

    seed = args.seed
    for name in cells:
        if device.type == "cuda":
            cell = harness.resolve(spec, name)
        else:
            cell = small_cell(name)
        plan = [("onoff", on) for i in range(args.onoff)
                for on in ((False, True) if i % 2 == 0 else (True, False))]
        plan += [("traced", i % 2 == 0) for i in range(
            args.traced_on + args.traced_off)][:args.traced_on
                                                + args.traced_off]
        for part, on in plan:
            traced = part == "traced"
            trace.enable(on)
            trace.HOST_READS.clear()
            reads_log.clear()
            SpanTracer.last = None
            result, run = harness.run_cell(cell, seed, args.seconds, traced,
                                           device)
            trace.enable(False)
            window = reads_log[-run.ops:] if run.ops else []
            total = sum((sum(c.values()) for c in window))
            sites = sum(window, collections.Counter())
            rec = {"cell": name, "part": part, "spans_on": on, "seed": seed,
                   "correct": result["correct"], "ops": run.ops,
                   "metrics": {k: v["value"] for k, v in
                               result["metrics"].items()},
                   "reads_per_op": total / run.ops if run.ops else None,
                   "reads_by_site_per_op": {k: v / run.ops for k, v in
                                            sites.items()},
                   "device": result["device"]}
            if traced:
                rec["metrics"].update({
                    k: v["value"] for k, v in harness.read_metrics(
                        cell.end_to_end, run).items()})
                tr = SpanTracer.last
                if tr is not None and tr.by_span is not None and \
                        run.traced is not None:
                    rec["census"] = tr.census
                    rec["summarize_busy_s"] = run.traced["summary"]["busy_s"]
                    rec["reduce_busy_s"] = tr.by_span["busy_s"]
                    if on:
                        rec["stages"] = stage_numbers(tr.by_span, run,
                                                      kernel_of, spans_mod)
                    rec["breakdown"] = result.get("breakdown")
            line = json.dumps(rec)
            print("probe: " + line, flush=True)
            with open(OUT / "probe.jsonl", "a") as f:
                f.write(line + "\n")
            seed += 1
        summary_line(name, OUT / "probe.jsonl")
    return 0


def summary_line(cell: str, path: Path) -> None:
    """Medians of the cell's rates by part and spans on/off, so far."""
    rows = [json.loads(x) for x in path.read_text().splitlines()[1:]]
    rows = [r for r in rows if r.get("cell") == cell]
    out = {}
    for part in ("onoff", "traced"):
        for on in (False, True):
            sel = [r["metrics"] for r in rows
                   if r["part"] == part and r["spans_on"] == on]
            for key in ("query_rate", "update_rate", "idle_share.query",
                        "idle_share.update"):
                vals = [m[key] for m in sel if key in m]
                if vals:
                    out[f"{part}.{'on' if on else 'off'}.{key}"] = \
                        [statistics.median(vals), vals]
    print("probe summary " + cell + ": " + json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
