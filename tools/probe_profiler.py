#!/usr/bin/env python3
"""How often `torch.profiler` loses kernel A's device records, on one GPU.

    python3 tools/probe_profiler.py [--passes 400]

`chip_smoke.py` phase 5 splits kernel A's device time by its kernels (key
transpose, mask pack, `inf` fill, sweep) from one profiler pass over three
calls of `relax_sweep`. Now and then such a pass records fewer sweep
launches than calls. This probe runs many such passes at the main path's
shapes (2^20 vertices, about 4.19 M random undirected edges at capacity
2^23, 32 planes of 2-hop keys, a per-plane mask; block_v 512, block_e
4096) in several ways of profiling, and counts the passes that lost
records:

  as chip_smoke     CPU and CUDA activities, three calls, one sync
  after timing      the same, right after the timing chip_smoke does
                    before each split (10 kernel calls, the plain version)
  CUDA only         CUDA activity alone
  sync each call    a sync after each of the three calls
  lead-in kernel    a one-element fill and a sync inside the pass first
  trailing kernel   a one-element fill and a sync inside the pass last
  warm-up cycle     schedule(wait=0, warmup=1, active=1): three calls in
                    a discarded cycle, then the three counted

Each call runs under `record_function("call<i>")`. For the first short
passes of each way it prints the device kernels the pass kept, by part,
and the kernel launches the CPU side kept inside each call's range. Prints
the card's name and power limit first and one JSON line per way. Exits
nonzero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 20
EDGES = 4 * N
CAPACITY = 1 << 23
PLANES = 32
CALLS = 3
PARTS = ("transpose_kernel", "pack_mask_kernel", "fill_chunked_kernel",
         "relax_sweep_kernel")


def one_pass(torch, call, mode: str) -> dict:
    """One profiler pass over CALLS calls; what it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    acts = [ProfilerActivity.CUDA] if mode == "CUDA only" else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    kw = {}
    if mode == "warm-up cycle":
        kw["schedule"] = schedule(wait=0, warmup=1, active=1)

    def calls():
        for i in range(CALLS):
            with record_function(f"call{i}"):
                call()
            if mode == "sync each call":
                torch.cuda.synchronize()

    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=acts, **kw) as prof:
        if mode == "warm-up cycle":
            calls()
            torch.cuda.synchronize()
            prof.step()
        if mode == "lead-in kernel":
            one.fill_(1)
            torch.cuda.synchronize()
        calls()
        torch.cuda.synchronize()
        if mode == "trailing kernel":
            one.fill_(2)
            torch.cuda.synchronize()
    per: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for part in PARTS:
                if part in e.name:
                    per[part] = per.get(part, 0) + 1
    out = {"sweeps": per.get("relax_sweep_kernel", 0)}
    if out["sweeps"] == CALLS:
        return out
    # What else the short pass kept: its device kernels by part, and the
    # kernel launches (CPU side) inside each call's range.
    raw = prof.profiler.kineto_results.events()
    names = {f"call{i}" for i in range(CALLS)}
    ranges = sorted((e.name(), e.start_ns(), e.end_ns()) for e in raw
                    if e.name() in names)
    out["kernels"] = per
    out["cpu_launches_per_call"] = [
        sum(1 for e in raw if "LaunchKernel" in e.name()
            and s <= e.start_ns() <= t) for _, s, t in ranges]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_profiler: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=400)
    passes = ap.parse_args().passes

    from repro_torch import api
    from repro_torch.core import engine as teng
    from repro_torch.core.labelling import INF_KEY2, per_plane_hub_mask
    from repro_torch.kernels.edge_relax import kernel as rk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    edges = rng.integers(0, N, (EDGES, 2))
    edges = np.unique(np.sort(edges[edges[:, 0] != edges[:, 1]], 1), axis=0)
    g, lab = api.build(N, edges, num_landmarks=PLANES, capacity=CAPACITY,
                       device=dev)
    bg = teng.RelaxEngine(block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                          device=dev).prepare(g).tiles
    mask = g.valid & torch.from_numpy(
        rng.random((PLANES, g.src.shape[0])) < 0.5).to(dev)
    hub = per_plane_hub_mask(lab.landmarks, lab.landmarks, N)
    args = (lab.key2().contiguous(), hub, bg.src_t, bg.dstloc_t, bg.perm_t,
            bg.slot_t, bg.rowblk_t, mask, g.w, 2, INF_KEY2, 1, N,
            bg.block_v, bg.nb)

    def call():
        rk.relax_sweep(*args)

    def timing():
        for _ in range(10):
            call()
        rk.relax_sweep_plain(*args)
        torch.cuda.synchronize()

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    modes = ("as chip_smoke", "after timing", "CUDA only", "sync each call",
             "lead-in kernel", "trailing kernel", "warm-up cycle")
    for mode in modes:
        t0 = time.perf_counter()
        bad, swept, seen = 0, [], []
        for _ in range(passes):
            if mode == "after timing":
                timing()
            r = one_pass(torch, call, "as chip_smoke"
                         if mode == "after timing" else mode)
            if r["sweeps"] != CALLS:
                bad += 1
                swept.append(r["sweeps"])
                if len(seen) < 5:
                    seen.append(r)
        print(json.dumps({"way": mode, "passes": passes, "short_passes": bad,
                          "sweeps_in_short": swept, "first_short": seen,
                          "s": round(time.perf_counter() - t0, 3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
