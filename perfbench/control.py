"""The control of a cell's check, and the program's readings beside it.

    python3 perfbench/control.py --workload ba20.query --seeds 11,12,13 \
        --seconds 3

For each seed it sets the cell up as a run does, drives the program for
a short window at the cell's own load, and reads the check's numbers for
the program (the lower readings); then it puts the reference in the
program's place, broken in one guarantee that the configuration states,
and reads the same numbers for it (the upper readings). BatchHL states
exact distances and a labelling that is exact after every committed
batch, so the control breaks exactness where a later change would be
tempted to:

* query cells: each answer is the landmark bound alone, min over the
  landmarks r of d(r, s) + d(r, t), with no search of the sparse part;
* update cells: the edge set and labelling lag one batch behind (the
  last committed batch not applied).

The benchmark's own runs do not run this. One JSON line per seed and side
goes to standard output and to `perfbench/out/control.<workload>.jsonl`.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_answers(cfg: dict, edges, qs, qt):
    """The landmark bound for the window's pairs: numpy int64."""
    import numpy as np
    import torch

    from perfbench import reference as ref
    n = int(cfg["n"])
    lms = ref.top_degree(edges, n, int(cfg["landmarks"]))
    dist, _ = ref.bfs(ref.adjacency(edges, n), lms)
    s = torch.from_numpy(qs.astype(np.int64)).to(edges.device)
    t = torch.from_numpy(qt.astype(np.int64)).to(edges.device)
    d = dist.to(torch.int64)
    est = torch.full_like(s, ref.INF)
    for r in range(d.shape[0]):
        est = torch.minimum(est, d[r, s] + d[r, t])
    return est.clamp_max(ref.INF).cpu().numpy()


def control_state(cfg: dict, n: int, edges, stream, batches: int) -> dict:
    """The reference's edge set and labelling one batch behind."""
    import torch

    from perfbench import reference as ref
    stale = stream.edges_after(edges, n, max(batches - 1, 0))
    lms = ref.top_degree(edges, n, int(cfg["landmarks"]))
    dist, hub, highway = ref.labelling(stale, n, lms)
    return {"arcs": ref.arc_keys(stale, n), "landmarks": lms.to(torch.int32),
            "dist": dist, "hub": hub, "highway": highway}


def readings(cell, seed: int, seconds: float, device, prog=None) -> list:
    """[(side, checks)] for the program and the control on one seed."""
    import torch

    from perfbench import harness
    prog = harness.Program() if prog is None else prog
    run = harness.Run(cell.name, cell.mix["kind"], cell.config, cell.mix)
    tracer = harness.Tracer(False, device)
    st, stream = harness.setup_cell(prog, cell, seed, device, run, tracer)
    if run.kind == "query":
        qs, qt, got = harness.drive_queries(prog, st, cell.mix, stream,
                                            seconds, tracer, run, device)
    else:
        harness.drive_updates(prog, st, cell.mix, stream, seconds, tracer,
                              run, device)
    n, edges = st.n, st.edges
    out = harness.program_state(st) if run.kind == "update" else None
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if run.kind == "query":
        sides = [("program", got),
                 ("control", control_answers(cell.config, edges, qs, qt))]
        return [(side, harness.check_queries(cell.config, cell.mix, seed,
                                             edges, qs, qt, answers))
                for side, answers in sides]
    sides = [("program", out),
             ("control", control_state(cell.config, n, edges, stream,
                                       run.ops))]
    return [(side, harness.check_updates(cell.config, n, edges, stream,
                                         run.ops, got))
            for side, got in sides]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    cell = harness.resolve(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        harness.log("the control runs on a CUDA device; none found")
        return 2
    device = torch.device("cuda", 0)
    out_dir = harness.HERE / "out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"control.{cell.name}.jsonl", "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            for side, checks in readings(cell, seed, args.seconds, device):
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "side": side, "checks": {
                                       k: v[0] if isinstance(v, tuple) else v
                                       for k, v in checks.items()},
                                   "s": time.perf_counter() - t})
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
