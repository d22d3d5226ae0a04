"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is comes from data that the harness finds by name:
the cell in `BENCHMARK.json`, its configuration (`configs/<name>.json`,
whose `family` names `graphs/<family>.py`), its traffic mix
(`traffic/<name>.json`, whose `kind` picks the window's loop below) and
each metric it reports (`metrics/<name>.py`, or for a metric split by cell
kind, `metrics/<name up to its first dot>.py`).

The window drives the program exactly as its serve loop does
(`repro_torch.launch.serve`): queries as `ServeLoop._answer`
(`batched_query` on the snapshot's plan, answers read back with
`.cpu()`), updates as a tick of `ServeLoop.run` with `_update_sync`
(`make_batch`, `apply_batch`, `RelaxEngine.prepare(g', topology_changed=
<batch has inserts>)`, BHL⁺ `batchhl_update` with that plan, then a
device synchronise). One caller, back to back (a closed loop).

A traced run (`--trace 1`) profiles two stretches of its window: the
first `trace_ops` ops with the program's spans off (the device's busy
time, kernels and idle gaps by the harness's spans), and the next
`trace_ops` with them on (`repro_torch.trace`; the same reduced by the
program's spans, `spans.py`). It also counts the program's host reads
(`trace.HOST_READS`) around each op. An untraced run does neither.

What it checks, after the window and with the program's state freed,
is held against the plain reference (`reference.py`): the sampled
answers of a query cell, and the live edge set and the whole labelling
after the last batch of an update cell. Every comparison is exact.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import reference as ref
from perfbench import roofline, traffic
from perfbench.tracing import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The waves of a BHL⁺ update, by the program's wave counter's kinds.
UPDATE_WAVES = ("search_improved", "repair_base", "repair")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


_modules: dict[Path, object] = {}


def load_module(path: Path):
    """The module in file `path` (a graph family or a metric reader)."""
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{path.parent.name}_{path.stem.replace('.', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_path(name: str) -> Path:
    """The reader of metric `name`: its own file, else the file of the
    quantity it splits (`relax_roofline.query` → `relax_roofline.py`)."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / (
        name.split(".")[0] + ".py")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of the benchmark, with its files read from
    the checkout at `root`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    if config["variant"] != "BHL+":
        raise ValueError(f"{conf['file']}: the benchmark runs BHL+ (the "
                         f"improved batch search) only, not "
                         f"{config['variant']!r}")
    mix = json.loads((root / HERE.name / "traffic" / f"{w['traffic']}.json"
                      ).read_text())

    def mine(entries):
        return [m for m in entries if workload in m.get("workloads",
                                                        [workload])]
    return Cell(workload, int(w["chips"]), config, mix,
                mine(spec["end_to_end"]), mine(spec["per_layer"]))


class Program:
    """The calls of the program under test that a run makes. A check of
    the harness itself may break one of them underneath a run."""

    def __init__(self):
        from repro_torch import trace
        from repro_torch.core import engine
        from repro_torch.core.batch import batchhl_update
        from repro_torch.core.construct import (build_labelling,
                                                select_landmarks_by_degree)
        from repro_torch.core.query import batched_query
        from repro_torch.graphs.coo import apply_batch, from_edges, make_batch
        from repro_torch.kernels.edge_relax import kernel as relax_kernel
        self.waves = engine.WAVES
        self.RelaxEngine = engine.RelaxEngine
        self.batchhl_update = batchhl_update
        self.build_labelling = build_labelling
        self.select_landmarks_by_degree = select_landmarks_by_degree
        self.batched_query = batched_query
        self.apply_batch = apply_batch
        self.from_edges = from_edges
        self.make_batch = make_batch
        self._relax_kernel = relax_kernel
        self.trace = trace

    def launches(self) -> int:
        """Kernel A's launches so far (its wrapper's count)."""
        return self._relax_kernel.launches

    def host_reads(self) -> int:
        """The program's host reads so far, over every site."""
        return sum(self.trace.HOST_READS.values())


@dataclasses.dataclass
class Run:
    """What one run measured and counted; the metric readers read it."""
    workload: str
    kind: str
    config: dict
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    ops: int = 0
    items: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    waves: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    retiles: int = 0
    prepare_s: list = dataclasses.field(default_factory=list)
    traced: dict | None = None
    # The second traced stretch: its ops, waves and reduction by span.
    spans: dict | None = None
    per_op: list = dataclasses.field(default_factory=list)
    setup_parts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class State:
    n: int
    edges: torch.Tensor     # int64 [E, 2] the built graph's edges, u < v
    g: object
    lab: object
    engine: object
    plan: object
    # The same edges in the configuration's own order (its generator's),
    # under the run's names; held until the update stream is drawn.
    graph_order: torch.Tensor | None = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(prog: Program, cfg: dict, seed: int, device: torch.device,
          parts: dict) -> State:
    """The configuration's graph with its ids drawn from the seed, its
    snapshot, tiling and labelling."""
    t = time.perf_counter()
    n = int(cfg["n"])
    family = load_module(HERE / "graphs" / f"{cfg['family']}.py")
    generated = family.generate(cfg, traffic.generator(
        int(cfg["graph_seed"]), "graph", device))
    edges = traffic.relabel(generated, n,
                            traffic.generator(seed, "labels", device))
    graph_order = traffic.relabel(generated, n, traffic.generator(
        seed, "labels", device), keep_order=True)
    del generated
    sync(device)
    parts["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    g = prog.from_edges(n, edges.to(torch.int32).cpu().numpy(),
                        int(cfg["edge_capacity"]), device=device)
    landmarks = prog.select_landmarks_by_degree(g, int(cfg["landmarks"]))
    sync(device)
    parts["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = prog.RelaxEngine(block_v=int(cfg["block_v"]),
                              block_e=cfg["block_e"], device=device)
    plan = engine.prepare(g)
    parts["prepare_s"] = time.perf_counter() - t
    t = time.perf_counter()
    lab = prog.build_labelling(g, landmarks, plan=plan)
    sync(device)
    parts["construct_s"] = time.perf_counter() - t
    parts["edges"] = int(edges.shape[0])
    return State(n, edges, g, lab, engine, plan, graph_order)


# --- the query window ---

def query_op(prog, st: State, mix: dict, qs: np.ndarray, qt: np.ndarray,
             tracer: Tracer, device) -> np.ndarray:
    """One microbatch, as the serve loop answers it."""
    with tracer.span("batched_query"):
        s = torch.from_numpy(qs).to(device)
        t = torch.from_numpy(qt).to(device)
        d = prog.batched_query(st.g, st.lab, s, t,
                               max_steps=int(mix["max_steps"]), plan=st.plan)
    with tracer.span("sync"):
        return d.cpu().numpy()


def counts_reads(prog, tracer: Tracer) -> bool:
    """Whether the window counts the program's host reads: traced runs
    only. The count starts with the window."""
    if not tracer.enabled:
        return False
    prog.trace.HOST_READS.clear()
    return True


def end_stretch(prog, tracer: Tracer, run: Run, k: int, trace_ops: int,
                launches0: int, waves) -> None:
    """End the traced stretch under way after the window's op k: the
    first (`run.traced`), which is followed by the second where it ran
    its `trace_ops` ops, or the second (`run.spans`). Either holds the
    ops it traced, which are fewer where the window ended inside it;
    `waves(rec)` is an op's waves by its record."""
    tracer.stop()
    if run.traced is None:
        run.traced = {"ops": k, "launches": prog.launches() - launches0,
                      "waves": sum(waves(r) for r in run.per_op[:k])}
        if k == trace_ops:
            tracer.start_spans(prog.trace)
    else:
        ops = run.per_op[trace_ops:k]
        run.spans = {"ops": len(ops), "waves": sum(waves(r) for r in ops)}


def drive_queries(prog, st: State, mix: dict, stream, seconds: float,
                  tracer: Tracer, run: Run, device):
    """The window of a query mix, full microbatches back to back:
    (sources, targets, answers) of every query answered, in order."""
    trace_ops = int(mix["trace_ops"]) if tracer.enabled else 0
    reads = counts_reads(prog, tracer)
    mb = stream.microbatch
    answers = []
    launches0 = prog.launches()
    if trace_ops:
        tracer.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while time.perf_counter() < deadline:
        before = prog.waves["bibfs"]
        reads0 = prog.host_reads() if reads else 0
        t0 = time.perf_counter()
        answers.append(query_op(prog, st, mix, *stream.batch(k), tracer,
                                device))
        t1 = time.perf_counter()
        run.latencies_s.append(t1 - t0)
        waves = prog.waves["bibfs"] - before
        run.waves["bibfs"] += waves
        run.per_op.append({"ms": (t1 - t0) * 1e3, "bibfs": waves})
        if reads:
            run.per_op[-1]["reads"] = prog.host_reads() - reads0
        k += 1
        if tracer.active and k in (trace_ops, 2 * trace_ops):
            end_stretch(prog, tracer, run, k, trace_ops, launches0,
                        lambda r: r["bibfs"])
    run.window_s = time.perf_counter() - t_start
    if tracer.active:
        end_stretch(prog, tracer, run, k, trace_ops, launches0,
                    lambda r: r["bibfs"])
    run.ops, run.items = k, k * mb
    if run.traced is not None:
        live = int(st.g.valid.sum())
        run.traced["bytes"] = run.traced["waves"] * roofline.wave_bytes(
            mb, st.n, live, hub=False)
    qs, qt = stream.take(np.arange(k * mb))
    return qs, qt, np.concatenate(answers)


# --- the update window ---

def update_op(prog, st: State, stream, k: int, tracer: Tracer, device,
              run: Run):
    """Batch k as one tick of the serve loop's synchronous update:
    (G', labelling', affected, plan, seconds from dispatch to commit)."""
    rows = stream.rows(k)
    has_ins = stream.n_ins > 0
    t0 = time.perf_counter()
    with tracer.span("make_batch"):
        batch = prog.make_batch(rows, pad_to=stream.batch_size,
                                device=device)
    with tracer.span("apply_batch"):
        g_next = prog.apply_batch(st.g, batch)
    with tracer.span("prepare"):
        tp = time.perf_counter()
        plan = st.engine.prepare(g_next, topology_changed=has_ins)
        run.prepare_s.append(time.perf_counter() - tp)
    with tracer.span("batchhl_update"):
        g2, lab2, aff = prog.batchhl_update(
            st.g, batch, st.lab, improved=True, plan=plan, g_new=g_next)
    with tracer.span("sync"):
        sync(device)
    return g2, lab2, aff, plan, time.perf_counter() - t0


def update_waves(rec: dict) -> int:
    """A batch's search and repair waves, by its record."""
    return sum(rec.get(w, 0) for w in UPDATE_WAVES)


def drive_updates(prog, st: State, mix: dict, stream, seconds: float,
                  tracer: Tracer, run: Run, device) -> None:
    trace_ops = int(mix["trace_ops"]) if tracer.enabled else 0
    reads = counts_reads(prog, tracer)
    kept = []              # (valid, src, dst, aff) of each batch of the
                           # first traced stretch
    affected = []          # device counts, read after the window
    launches0 = prog.launches()
    retiles0 = st.engine.retile_count
    if trace_ops:
        tracer.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while time.perf_counter() < deadline:
        before = {w: prog.waves[w] for w in UPDATE_WAVES}
        r0 = st.engine.retile_count
        reads0 = prog.host_reads() if reads else 0
        g2, lab2, aff, plan, secs = update_op(prog, st, stream, k, tracer,
                                              device, run)
        st.g, st.lab, st.plan = g2, lab2, plan
        waves = {w: prog.waves[w] - before[w] for w in UPDATE_WAVES}
        run.latencies_s.append(secs)
        run.waves.update(waves)
        run.per_op.append({"ms": secs * 1e3, "retiles":
                           st.engine.retile_count - r0,
                           **{w: v for w, v in waves.items() if v}})
        if reads:
            run.per_op[-1]["reads"] = prog.host_reads() - reads0
        if tracer.enabled:
            affected.append(aff.sum())
        k += 1
        if tracer.active and run.traced is None:
            kept.append((g2.valid, g2.src if stream.n_ins else None,
                         g2.dst if stream.n_ins else None, aff))
        if tracer.active and k in (trace_ops, 2 * trace_ops):
            end_stretch(prog, tracer, run, k, trace_ops, launches0,
                        update_waves)
    run.window_s = time.perf_counter() - t_start
    if tracer.active:
        end_stretch(prog, tracer, run, k, trace_ops, launches0,
                    update_waves)
    run.ops, run.items = k, k * stream.batch_size
    run.retiles = st.engine.retile_count - retiles0
    if affected:
        for rec, a in zip(run.per_op, torch.stack(affected).tolist()):
            rec["affected"] = a
    if run.traced is not None:
        run.traced["bytes"] = update_bytes(st, run, kept)


def update_bytes(st: State, run: Run, kept: list) -> int:
    """The bytes the first stretch's batches' waves need (`roofline.py`)."""
    planes = int(run.config["landmarks"])
    total = 0
    for rec, (valid, src, dst, aff) in zip(run.per_op, kept):
        src = st.g.src if src is None else src
        dst = st.g.dst if dst is None else dst
        live = int(valid.sum())
        bou, inner = roofline.repair_masks_used(valid, src, dst, aff)
        total += (rec.get("search_improved", 0) * roofline.wave_bytes(
                      planes, st.n, live, hub=True)
                  + rec.get("repair_base", 0) * roofline.wave_bytes(
                      planes, st.n, live, hub=True, mask_planes=planes,
                      used=bou)
                  + rec.get("repair", 0) * roofline.wave_bytes(
                      planes, st.n, live, hub=True, mask_planes=planes,
                      used=inner))
    return total


# --- the check ---

def check_queries(cfg: dict, mix: dict, seed: int, edges: torch.Tensor,
                  qs: np.ndarray, qt: np.ndarray, got: np.ndarray) -> dict:
    """A sample, drawn from the seed, of the window's answers `got` to
    the queries (qs, qt) against BFS: {name: (value, limit)}."""
    rng = np.random.default_rng([seed % (1 << 64), 0x636B])
    take = np.sort(rng.choice(got.shape[0], min(int(mix["check_sample"]),
                                                got.shape[0]),
                              replace=False))
    dev = edges.device
    want = ref.pair_distances(
        ref.adjacency(edges, int(cfg["n"])),
        torch.from_numpy(qs[take].astype(np.int64)).to(dev),
        torch.from_numpy(qt[take].astype(np.int64)).to(dev)).cpu().numpy()
    wrong = int((got[take].astype(np.int64) != want).sum())
    return {"answer_mismatches": (wrong, 0), "answers_checked": take.size}


def check_updates(cfg: dict, n: int, edges0: torch.Tensor, stream,
                  batches: int, out: dict) -> dict:
    """The program's live edges and labelling after `batches` batches
    against the reference's, worked out from the edge list alone: the
    arcs that do not pair off, and the entries of the landmarks, dist,
    hub and highway that differ."""
    final = stream.edges_after(edges0, n, batches)
    landmarks = ref.top_degree(edges0, n, int(cfg["landmarks"]))
    dist, hub, highway = ref.labelling(final, n, landmarks)
    label = (int((out["landmarks"].to(torch.int64) != landmarks).sum())
             + int((out["dist"] != dist).sum())
             + int((out["hub"] != hub).sum())
             + int((out["highway"] != highway).sum()))
    return {"edge_mismatches": (ref.multiset_difference(
                out["arcs"], ref.arc_keys(final, n)), 0),
            "label_mismatches": (label, 0)}


def program_state(st: State) -> dict:
    """What the check reads of the program's final snapshot: its live
    arcs (sorted keys src·n + dst) and its labelling."""
    g, lab = st.g, st.lab
    arcs = torch.sort(g.src[g.valid].to(torch.int64) * st.n
                      + g.dst[g.valid].to(torch.int64)).values
    return {"arcs": arcs, "landmarks": lab.landmarks, "dist": lab.dist,
            "hub": lab.hub, "highway": lab.highway}


# --- the run ---

def spare(engine):
    """A copy of `engine` whose caches are its own: a shallow copy with
    each dict and list attribute copied, so that what the copy prepares
    leaves `engine` as it was."""
    twin = copy.copy(engine)
    for name, value in vars(engine).items():
        if isinstance(value, (dict, list)):
            setattr(twin, name, copy.copy(value))
    return twin


def setup_cell(prog, cell: Cell, seed: int, device, run: Run,
               tracer: Tracer):
    """Build the cell's state and stream, and warm its one shape."""
    st = build(prog, cell.config, seed, device, run.setup_parts)
    t = time.perf_counter()
    if run.kind == "query":
        comp = ref.largest_component(st.edges, st.n)
        stream = traffic.query_stream(cell.mix, seed, comp)
        run.setup_parts["component"] = int(comp.shape[0])
        del comp

        def warm():
            query_op(prog, st, cell.mix, *stream.batch(0), tracer, device)
    else:
        stream = traffic.update_stream(
            cell.mix, seed, st.graph_order, st.n,
            deletion_seed=int(cell.config["graph_seed"]))

        def warm():
            # Batch 0 from the built snapshot, thrown away: the window
            # starts from the built snapshot again. It runs on a copy of
            # the engine, so that the tiling it prepares is not in the
            # window's engine's cache: there batch 0 of a mix with
            # insertions retiles as every later batch does.
            update_op(prog, dataclasses.replace(st, engine=spare(
                st.engine)), stream, 0, tracer, device, Run(
                run.workload, run.kind, run.config, run.mix))
    st.graph_order = None
    run.setup_parts["stream_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm()
    tracer.warm(warm)
    sync(device)
    run.setup_parts["warm_s"] = time.perf_counter() - t
    return st, stream


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, prog: Program | None = None,
             t0: float | None = None, parts: dict | None = None
             ) -> tuple[dict, Run]:
    """One run: (the result line as a dict, the run's record). `t0` is
    when the run's program started, `parts` what its start took."""
    t0 = time.perf_counter() if t0 is None else t0
    kind = cell.mix["kind"]
    if kind not in ("query", "update"):
        raise ValueError(f"unknown traffic kind {kind!r}")
    run = Run(cell.name, kind, cell.config, cell.mix)
    run.setup_parts.update(parts or {})
    t = time.perf_counter()
    prog = Program() if prog is None else prog
    run.setup_parts["program_s"] = time.perf_counter() - t
    run.setup_parts["start_s"] = time.perf_counter() - t0
    tracer = Tracer(trace, device)
    st, stream = setup_cell(prog, cell, seed, device, run, tracer)
    run.setup_s = time.perf_counter() - t0
    log(f"{cell.name} seed {seed}: set-up {run.setup_s:.3f} s "
        f"{run.setup_parts}")

    if kind == "query":
        queries = drive_queries(prog, st, cell.mix, stream, seconds, tracer,
                                run, device)
    else:
        drive_updates(prog, st, cell.mix, stream, seconds, tracer, run,
                      device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if run.traced is not None:
        run.traced["summary"] = tracer.finish()
    if run.spans is not None:
        run.spans["reduced"] = tracer.reduced
    log(f"{cell.name}: {run.ops} ops, {run.items} items in "
        f"{run.window_s:.3f} s; waves {dict(run.waves)}")

    # The check, once the program's state is freed.
    t = time.perf_counter()
    n, edges0 = st.n, st.edges
    out = program_state(st) if kind == "update" else None
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kind == "query":
        checks = check_queries(cell.config, cell.mix, seed, edges0,
                               *queries)
        failed = checks["answer_mismatches"][0]
    else:
        checks = check_updates(cell.config, n, edges0, stream, run.ops, out)
        failed = 0 if all(v <= lim for v, lim in checks.values()) \
            else run.items    # every batch led to a wrong state
    del out
    check_s = time.perf_counter() - t
    correct = all(v[0] <= v[1] for v in checks.values()
                  if isinstance(v, tuple))

    result = {"correct": correct, "attempted": run.items, "failed": failed,
              "metrics": read_metrics(cell.per_layer if trace
                                      else cell.end_to_end, run),
              "device": device_info(device, peak, run, trace)}
    if trace and run.traced is not None:
        result["breakdown"] = breakdown(run)
    result["checks"] = {k: {"value": v[0], "limit": v[1]} if
                        isinstance(v, tuple) else v
                        for k, v in checks.items()}
    run.setup_parts["check_s"] = check_s
    return result, run


def read_metrics(entries: list[dict], run: Run) -> dict:
    out = {}
    for m in entries:
        value = load_module(metric_path(m["name"])).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device, peak: int, run: Run, trace: bool) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace:
        s = (run.traced or {}).get("summary") or {}
        info["busy_s"] = s.get("busy_s", 0.0)
        info["window_s"] = s.get("window_s", 0.0)
    return info


def breakdown(run: Run) -> dict:
    s = run.traced["summary"]
    ops = sorted(s["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(s["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], v[0]] for name, v in ops],
            "idle_gaps": [[name, v] for name, v in gaps]}


def card_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0]


def write_record(cell: Cell, seed: int, trace: bool, result: dict,
                 run: Run, card: str | None = None) -> None:
    """The run's record under `perfbench/out/` (git-ignored): every op's
    time and waves (and, traced, its affected count), so drift shows."""
    out_dir = HERE / "out"
    out_dir.mkdir(exist_ok=True)
    traced = dict(run.traced or {})
    summary = traced.pop("summary", None)
    rec = {"workload": cell.name, "seed": seed, "trace": trace,
           "card": card, "result": result, "setup_s": run.setup_s,
           "setup_parts": run.setup_parts, "window_s": run.window_s,
           "traced": traced, "trace_kernels": summary and summary["kernels"],
           "trace_idle": summary and summary["idle"],
           "trace_spans": run.spans, "per_op": run.per_op}
    path = out_dir / f"{cell.name}.{seed}.trace{int(trace)}.json"
    path.write_text(json.dumps(rec))


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(workload: str, seed: int, seconds: float, trace: bool,
         t0: float, imported: float) -> int:
    """A run from the command line; `t0` is when its program started
    and `imported` when the harness (and torch) had been imported."""
    cell = resolve(load_spec(), workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    device = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.empty(1, device=device)     # the CUDA context
    sync(device)
    parts = {"import_s": imported - t0, "cuda_s": time.perf_counter() - t}
    result, run = run_cell(cell, seed, seconds, trace, device, t0=t0,
                           parts=parts)
    card = card_power_limit() if trace else None
    write_record(cell, seed, trace, result, run, card)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may load neither JAX "
            f"nor the JAX package")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})"
            if isinstance(c, dict) else f"check {name}: {c}")
    print(json.dumps(result), flush=True)
    return 0
