#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit), torch and CUDA versions, and
   builds every CUDA kernel in `build.SOURCES` (relax sweep, min-plus,
   legacy edge relax, embedding bag) from `src/repro_torch/csrc/` with
   nvcc, one process each, all at once.
2. Holds each kernel to its plain PyTorch version on the card: the three
   integer kernels with `torch.equal`, the embedding bag to rtol = atol =
   1e-5 (float32 sums in another order), over each kernel's edge cases
   (for the relax sweep every case of `tests/_sweep_cases.py`, where the
   autotuner's `sorted` impl is held equal to the kernel as well; for
   min-plus and the legacy edge relax every case of
   `tests/_kernel_cases.py`, as `tests/test_torch_cuda.py` runs them; and
   the ValueError of each block_v limit).
3. Drives the port's main path through `repro_torch.api` at full size:
   Barabási–Albert(2^20, m=4, seed 0), capacity 2^23 edges, 32 landmarks;
   build; one mixed BHL⁺ tick of 512 inserts + 512 deletes; 1024 uniform
   queries in microbatches of 32 with max_steps 64. Kernel launch counts
   are set to 0 just before and read just after.
4. Checks that run: landmark distances after build and after the update
   against scipy BFS, 64 answers against scipy BFS, the update and one
   microbatch rerun on the COO reference (plan=None) equal the kernel
   path, and both kernels were launched in phase 3.
3b. Runs the same tick again in the frontier mode (`RelaxEngine(
   frontier=True)`, threshold 0.25, frontier blocks of 64) through
   `api.update`, holds it bit for bit to phase 3's update, and reports
   its masked and full waves per kind and the two host tilings' seconds;
   then a trickle tick of 2 inserts + 2 deletes through the full sweep,
   the frontier mode and the frontier mode at threshold 1.0 (every wave
   masked), plans tiled beforehand, all three held equal.
5. Times each kernel on its own path's shapes with CUDA events, in turns
   with its plain version, beside its bound (bytes over 3.35 TB/s, or
   operations over 67 T/s, whichever is larger): the relax sweep and
   min-plus at the main path's shapes (the sweep for each wave kind of
   the main path, the two per-plane-mask repair kinds among them, with
   the bound of the bytes the sweep needs — index streams of the live
   tile slots, only `slot_t` of the padding ones, w and mask of the live
   edges — beside the bound of every padded tile slot, and the device
   time of each of its kernels — key transpose, mask pack, `inf` fill,
   sweep — from one `torch.profiler` pass over three calls, failing the
   phase when its parts sum to 0); one query microbatch under
   `torch.profiler` (device-busy ms, against the same call's median host
   ms timed without the profiler for the idle share), and its plan-cache
   hit (`RelaxEngine.prepare` of the queried snapshot: device ms, host
   syncs, and the fingerprint's kernels alone); min-plus also by its own
   device microseconds under the profiler, beside a launch floor (a
   one-element fill profiled the same way); the legacy edge relax
   through `ops.prepare` / `ops.edge_relax` on the post-update graph
   (also held to the COO oracle `ref.edge_relax`; device ms of its
   `inf` fill and its sweep); the embedding bag through
   `ops.embed_bag` at the MIND config's widths (10,485,760 × 64 float32
   table, bags of 50, batches of 512 and 65,536), beside
   `torch.nn.functional.embedding_bag` as the library yardstick. Each of
   those two entry points is its kernel's path: its count is set to 0
   just before the call and read just after. Every profiler pass must
   record each hand-written kernel as often as its wrapper launched it
   (and kernel A's transpose, fill and pack once per launch); a pass that
   lost records is logged and run again, and three such passes in a row
   fail the phase.
6. The serving path at full width (`repro_torch.launch.serve`, the
   production config: BA(2^20, 4), 32 landmarks, batches of 1024, query
   microbatches of 32, 256 queries a tick at 2000 per second). First
   BHLˢ on the phase-3 batch and UHL⁺ on the trickle batch through an
   engine, each held to the COO path; the phase-3 tick as a pipelined
   update stepped by hand (full sweep, fused, frontier), each held to
   phase 3's update, with the host syncs of every step. Then the serve
   loop: 3 ticks in pipeline mode with checkpoints (run A; kernel launch
   counts set to 0 just before and read just after, both kernels must
   run), in sync mode (every committed version equal to run A's), fused
   (final snapshot equal), a restore of run A's last checkpoint and a run
   resumed after 2 ticks (equal), and 2 ticks of the `growth` scenario
   from 64 free slot pairs (must grow). Served answers, up to 32 per
   version, equal a recomputation on the COO path at their version and
   scipy BFS; the final dist of run A and of the growth run equal scipy
   BFS from every landmark. Per tick: update seconds, affected count,
   growth and checkpoint seconds; latency from arrival to answer (p50,
   p95, p99), mean staleness, checkpoint bytes and restore seconds, peak
   device memory and the phase's wall time.
7. Directed BatchHL at full width: the BA(2^20, 4) edges oriented u->v
   with probability 0.7 (else v->u, `numpy.random.default_rng(7)`), 2048
   free arc slots, the 32 landmarks of highest total degree; built through
   a forward and a reverse `RelaxEngine` (block_v 512, block_e 4096), one
   `batchhl_update_directed` of 512 deletions and 512 insertions, 1024
   uniform queries in microbatches of 32 (max_steps 64). fwd/bwd dist equal
   scipy BFS (on the arcs and on their transpose) after build and update,
   64 answers equal scipy BFS, the update and one microbatch equal the COO
   path, and kernel A ran. Build, update and per-microbatch seconds, waves
   per kind, both orientations' tiling seconds and peak device memory.
8. The autotuner at full width: phase 6's run A in pipeline mode (without
   its checkpoints and history) with `autotune=True` and a tuning table
   under `build/chip_smoke_tune/` (removed after): it tunes once at the
   fresh snapshot, kernel A under each launch shape of the reference's
   grid against the `sorted` impl. Every candidate's compile and steady
   microseconds, the winner, the COO path's time, the
   tune's wall seconds and the peak device memory through the tune and
   the build. Its final snapshot must equal run A's; kernel A must have run
   if the winner is a kernel config; a second loop on the same table must
   tune nothing and commit the same.
9. The replica tier at full width (`repro_torch.launch.replica`): run
   A's configuration with `TopologySpec(readers=2, restart=True)`, an
   updater resumed from run A's version 0 (saved in phase 6, so that no
   process regenerates the graph), two readers and a router, each its own
   process on the card, their output in `build/chip_smoke_replica/logs/`.
   An open-loop stream of single-query requests at 2000/s from 32 client
   connections runs through the router until the updater has published
   its last version and the restarted reader has acked; reader 0 is
   killed once version 1 is published. The updater must exit 0, reader 0
   must have been restarted, staleness stay ≤ 1, answered + rejected
   equal offered, every published step equal run A's step byte for byte,
   up to 32 served answers per version equal the COO path and scipy BFS
   at that version, and each role's exit line show kernels A and B in
   every reader stopped cleanly and kernel A in the updater. Latency
   (all, and while a reader maps a version), rates, router stats, map
   seconds per reader and version, barrier waits, the restarted reader's
   spawn to first ack, and each process's peak device memory.
10. Prints a `summary:` line with every number above as JSON, the
   `{"kernels": [...]}` line (kernel A's and B's launches are run A's),
   the card line, and last `{"ok": true, "device": {...}}`.

Exits nonzero, printing no result, without a CUDA device or if any phase
fails. Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # _sweep_cases, kernel A's cases

N = 1 << 20
BA_M = 4
CAPACITY = 1 << 23
LANDMARKS = 32
N_INS = N_DEL = 512
QUERIES = 1024
MICROBATCH = 32
MAX_STEPS = 64
QUERY_BUDGET_S = 480.0   # past this many seconds, fewer query microbatches
FRONTIER_BLOCK = 64
FRONTIER_THRESHOLD = 0.25
TRICKLE = 2   # inserts and deletes of the small frontier tick
# The MIND config's widths (src/repro/configs/mind.py, configs/common.py).
MIND_ITEMS = 10_485_760
MIND_DIM = 64
MIND_HIST = 50
MIND_BATCHES = (512, 65_536)   # serve_p99, train_batch
BAG_TOL = 1e-5
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn()` over `reps` runs (after one
    warm-up run), by CUDA events."""
    import torch
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(kernel_fn, plain_fn, reps: int, plain_reps: int):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, plain_reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, plain_reps)
    return min(k1, k2), min(p1, p2)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.embed_bag import kernel as ek
    from repro_torch.kernels.minplus import kernel as mk
    rk.launches = rk.launches_edge_relax = mk.launches = ek.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.embed_bag import kernel as ek
    from repro_torch.kernels.minplus import kernel as mk
    return {"relax_sweep": rk.launches, "minplus": mk.launches,
            "edge_relax": rk.launches_edge_relax, "embed_bag": ek.launches}


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: The device name of each hand-written kernel that the profiler passes
#: check, and its wrapper's count in `read_launches`.
COUNTED = {"relax_sweep_kernel": "relax_sweep", "minplus_kernel": "minplus",
           "edge_relax_kernel": "edge_relax"}
PROFILER_TRIES = 3
#: Profiler passes that recorded fewer device kernels than were launched,
#: each discarded and run again (see `device_kernels`).
short_passes: list = []


def device_kernels(torch, fn, parts: tuple = ()) -> tuple[dict, float,
                                                          float]:
    """Run `fn()` once under `torch.profiler`: ({kernel name: [device ms,
    launches]}, device-busy ms, host ms). The card runs one stream here,
    so the kernels' times add up to the busy time.

    The pass must record each kernel of `COUNTED` as often as its wrapper
    launched it during `fn()`, and each kernel named in `parts` as often
    as kernel A's wrapper ran (one of each per run). The profiler now and
    then loses the device records of whole calls (`tools/probe_profiler.py`
    counts how often), so a short pass is logged, kept in `short_passes`
    and run again; after `PROFILER_TRIES` short passes the phase fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen_short = []
    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        before = read_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        per: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                row = per.setdefault(e.name[:90], [0.0, 0])
                row[0] += e.time_range.elapsed_us() / 1e3
                row[1] += 1
        want = {k: after[c] - before[c] for k, c in COUNTED.items()}
        want.update({k: want["relax_sweep_kernel"] for k in parts})
        got = {k: sum(v[1] for name, v in per.items() if k in name)
               for k in want}
        if got == want:
            return per, sum(v[0] for v in per.values()), host_ms
        seen_short.append({"launched": want, "recorded": got})
        short_passes.append(seen_short[-1])
        log(f"profiler pass short, run again: launched {want}, recorded "
            f"{got}")
    raise AssertionError(f"{PROFILER_TRIES} profiler passes in a row lost "
                         f"device records: {seen_short}")


def sweep_parts(per: dict) -> dict:
    """Kernel A's device ms by its kernels (transpose, pack, fill, sweep)."""
    out = {}
    for part in ("transpose_kernel", "pack_mask_kernel",
                 "fill_chunked_kernel", "relax_sweep_kernel"):
        out[part] = sum(v[0] for k, v in per.items() if part in k)
    return out


def sweep_split(torch, fn, per_plane: bool, reps: int = 3) -> dict:
    """Kernel A's device ms per call by its kernels, from one profiler pass
    over `reps` warm calls that recorded every kernel of every call (the
    mask pack only runs for a per-plane mask). Fails the phase if the
    parts sum to 0."""
    parts = ("transpose_kernel", "fill_chunked_kernel") + (
        ("pack_mask_kernel",) if per_plane else ())
    per = device_kernels(torch, lambda: [fn() for _ in range(reps)],
                         parts)[0]
    out = {k: v / reps for k, v in sweep_parts(per).items()}
    if sum(out.values()) <= 0:
        raise AssertionError(f"kernel A's split sums to 0: {out}")
    return out


def profiled_us(torch, fn, match: str, reps: int = 20) -> float:
    """Mean device microseconds per call of `fn()` (already warm) over
    `reps` calls under `torch.profiler`, counting the device kernels whose
    name contains `match` ("" counts them all)."""
    per = device_kernels(torch, lambda: [fn() for _ in range(reps)])[0]
    return sum(v[0] for k, v in per.items() if match in k) * 1e3 / reps


def host_syncs(torch, fn, sources: list | None = None) -> int:
    """The synchronising CUDA calls `fn()` makes, counted by the warnings
    of `torch.cuda.set_sync_debug_mode` (not its one-time notice that the
    mode is a prototype, which also speaks of synchronising). `sources`,
    if given, gets the file:line of each."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    if sources is not None:
        sources += [f"{Path(w.filename).name}:{w.lineno}" for w in hits]
    return len(hits)


def profile_prepare_hit(torch, engine, g) -> dict:
    """What a plan-cache hit costs the query path: the device ms and host
    syncs of `engine.prepare(g)` once g's plan is cached (the fingerprint
    and the check that the plan holds every live slot), beside the
    fingerprint's kernels alone, which are all the hit ran on the device
    before that check existed (it synced twice then)."""
    from repro_torch.core.engine import RelaxEngine
    engine.prepare(g)
    hits = engine.plan_cache_hits
    per, busy, _ = device_kernels(torch, lambda: engine.prepare(g))
    fp_per, fp_busy, _ = device_kernels(
        torch, lambda: RelaxEngine.snapshot_fingerprint(g))
    syncs = host_syncs(torch, lambda: engine.prepare(g))
    if engine.plan_cache_hits != hits + 2:
        raise AssertionError("prepare of a cached snapshot was not a hit")
    # One `.item()`, to read the count in transfers (the mode may warn
    # more than once for one).
    per_item = host_syncs(torch, lambda: g.valid[:1].sum().item())
    out = dict(device_ms=busy, launches=sum(v[1] for v in per.values()),
               fingerprint_device_ms=fp_busy,
               fingerprint_launches=sum(v[1] for v in fp_per.values()),
               host_syncs=syncs, host_syncs_per_item=per_item,
               cached_plans=len(engine._plans))
    log(f"prepare hit ({out['cached_plans']} cached plans): device "
        f"{busy:.4f} ms in {out['launches']} launches, {syncs} host syncs "
        f"({per_item} for one .item()); the fingerprint alone "
        f"{fp_busy:.4f} ms in {out['fingerprint_launches']} launches")
    return out


def profile_query(torch, api, g, lab, s, t, reps: int = 7) -> dict:
    """One query microbatch (already warm): its median host ms over `reps`
    runs without the profiler, then one run under it for the device-busy
    ms. The idle share divides by the unprofiled wall, since the
    profiler's own host work lengthens the profiled one."""
    def call():
        return api.query(g, lab, s, t, max_steps=MAX_STEPS)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    host = statistics.median(walls)
    per, busy, host_prof = device_kernels(torch, call)
    top = dict(sorted(per.items(), key=lambda kv: -kv[1][0])[:8])
    out = dict(host_ms=host, host_ms_runs=walls, host_ms_profiled=host_prof,
               device_busy_ms=busy,
               launches=sum(v[1] for v in per.values()),
               idle_share=1.0 - busy / host,
               idle_share_profiled_wall=1.0 - busy / host_prof,
               relax_sweep=sweep_parts(per), longest=top)
    log(f"query microbatch: host {host:.3f} ms (median of {reps} without "
        f"the profiler; {host_prof:.3f} ms under it), device busy "
        f"{busy:.3f} ms in {out['launches']} device launches, idle share "
        f"{out['idle_share']:.4f} ({out['idle_share_profiled_wall']:.4f} "
        f"against the profiled wall); kernel A parts {out['relax_sweep']};"
        f" longest {top}")
    if out["launches"] == 0:
        raise AssertionError("the profiler saw no device kernel")
    return out


# --- phase 2: each kernel against its plain version -------------------------

def check_kernels_small(torch, np, dev) -> int:
    import _kernel_cases as kernel_cases
    import _sweep_cases as sweep_cases
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops
    from repro_torch.kernels.minplus import kernel as mk

    cases = 0
    for name in sweep_cases.names():
        for c in sweep_cases.make(name):
            args = sweep_cases.sweep_args(c, dev)
            got = rk.relax_sweep(*args)
            torch.cuda.synchronize()
            want = rk.relax_sweep_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"relax_sweep != plain: {name} "
                                     f"{c.label} ({bad} entries differ)")
            # The autotuner's sorted impl on the same sweep.
            sg = rops.prepare_sorted(c.src, c.dst, c.keep, c.n, device=dev)
            srt = rops.relax_sweep_sorted(args[0], sg, args[7], c.step, c.inf,
                                          args[8], clear_bit=c.clear,
                                          hub=args[1])
            torch.cuda.synchronize()
            if not torch.equal(srt, got):
                raise AssertionError(f"sorted impl != relax_sweep: {name} "
                                     f"{c.label}")
            cases += 1
    # One block_v past the shared-memory limit raises, the limit named.
    limit = rk.SWEEP_MAX_BLOCK_V
    c = dataclasses.replace(sweep_cases.make("near-inf")[0],
                            block_v=limit + 1)
    try:
        rk.relax_sweep(*sweep_cases.sweep_args(c, dev))
    except ValueError as err:
        if f"block_v <= {limit}" not in str(err):
            raise
    else:
        raise AssertionError(f"relax_sweep took block_v={limit + 1}")
    cases += 1

    # Min-plus over every case of tests/_kernel_cases.py.
    for name in kernel_cases.minplus_names():
        s, h, tt = (torch.from_numpy(x).to(dev)
                    for x in kernel_cases.minplus_case(name))
        got = mk.minplus(s, h, tt)
        torch.cuda.synchronize()
        if not torch.equal(got, mk.minplus_plain(s, h, tt)):
            raise AssertionError(f"minplus != plain: {name} "
                                 f"(S {tuple(s.shape)}, H {tuple(h.shape)})")
        cases += 1
    rng = np.random.default_rng(0)
    return cases + check_edge_relax_small(torch, dev) \
        + check_embed_bag_small(torch, np, dev, rng)


def check_edge_relax_small(torch, dev) -> int:
    """Kernel C against its plain version and the COO oracle, bit for bit,
    over every case of tests/_kernel_cases.py; one block_v past its limit
    raises."""
    import _kernel_cases as kernel_cases
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ref as rref
    cases = 0
    for name in kernel_cases.edge_relax_names():
        for c in kernel_cases.edge_relax_case(name):
            for step in kernel_cases.STEPS:
                args = kernel_cases.edge_relax_args(c, step, dev)
                got = rk.edge_relax(*args)
                torch.cuda.synchronize()
                coo = rref.edge_relax(*(torch.from_numpy(x).to(dev) for x in
                                        (c.keys, c.src, c.dst, c.valid)),
                                      step, c.n)
                if not (torch.equal(got, rk.edge_relax_plain(*args))
                        and torch.equal(got, coo)):
                    raise AssertionError(f"edge_relax != plain / COO: {name}"
                                         f" {c.label} step={step}")
                cases += 1
    limit = rk.EDGE_RELAX_MAX_BLOCK_V
    c = dataclasses.replace(kernel_cases.edge_relax_case("near-inf")[0],
                            block_v=limit + 1)
    try:
        rk.edge_relax(*kernel_cases.edge_relax_args(c, 1, dev))
    except ValueError as err:
        if f"block_v <= {limit}" not in str(err):
            raise
    else:
        raise AssertionError(f"edge_relax took block_v={limit + 1}")
    return cases + 1


def check_embed_bag_small(torch, np, dev, rng) -> int:
    """Kernel D against its plain version, to rtol = atol = BAG_TOL."""
    from repro_torch.kernels.embed_bag import kernel as ek
    from repro_torch.kernels.embed_bag import ops as eops
    cases = 0

    def close(table, idx, w, what):
        nonlocal cases
        got = ek.embed_bag(table, idx, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ek.embed_bag_plain(table, idx, w),
                                   rtol=BAG_TOL, atol=BAG_TOL,
                                   equal_nan=True, msg=f"embed_bag: {what}")
        cases += 1

    n, b = 500, 37
    for d in (1, 8, 64, 100):
        for bag in (1, 7, 50):
            table = torch.from_numpy(
                rng.normal(size=(n, d)).astype(np.float32)).to(dev)
            idx = torch.from_numpy(
                rng.integers(0, n, (b, bag)).astype(np.int32)).to(dev)
            w = torch.from_numpy(
                rng.random((b, bag)).astype(np.float32)).to(dev)
            close(table, idx, w, f"D={d} L={bag}")
    n, d = 5, 8
    table = torch.arange(n * d, dtype=torch.float32, device=dev).view(n, d)
    idx = torch.tensor([[-1, 0], [n, 0], [-n, 1], [-n - 1, 2], [2, n + 3]],
                       dtype=torch.int32, device=dev)
    w = torch.tensor([[1.0, 0.5], [0.0, 1.0], [1.0, 1.0], [0.0, 1.0],
                      [1.0, 0.0]], device=dev)
    close(table, idx, w, "wrapped and NaN indices")
    nan_rows = torch.isnan(ek.embed_bag(table, idx, w)).all(1).tolist()
    if nan_rows != [False, True, False, True, True]:
        raise AssertionError(f"embed_bag NaN rows {nan_rows}")
    table = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 300, (20, 9)).astype(np.int32))
    mask = torch.from_numpy(rng.random((20, 9)) < 0.6)
    got = eops.embed_bag(table.to(dev), idx.to(dev), mask.to(dev), "mean")
    torch.testing.assert_close(got.cpu(), eops.embed_bag(table, idx, mask,
                                                         "mean"),
                               rtol=BAG_TOL, atol=BAG_TOL,
                               msg="ops.embed_bag mean with a mask")
    return cases + 1


# --- phase 4 helpers: the scipy oracle --------------------------------------

def csr_of(g, np):
    import scipy.sparse as sp
    valid = g.valid.cpu().numpy()
    src = g.src.cpu().numpy()[valid]
    dst = g.dst.cpu().numpy()[valid]
    return sp.csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                         shape=(g.n, g.n))


def bfs_dist(csr, sources, np, inf_d):
    """Hop distances [len(sources), n] over the arcs of `csr` (row to
    column), `inf_d` where unreached: one BFS of all sources at once, a
    level per scipy sparse product (the same distances as
    `scipy.sparse.csgraph.shortest_path(unweighted=True)`, which runs one
    Dijkstra per source and takes several times longer at 2^20)."""
    sources = np.asarray(sources, np.int64)
    cols = np.arange(len(sources))
    back = csr.T.tocsr().astype(np.float32)   # back[v, u]: an arc u -> v
    dist = np.full((csr.shape[0], len(sources)), inf_d, np.int64)
    dist[sources, cols] = 0
    front = np.zeros(dist.shape, np.float32)
    front[sources, cols] = 1
    level = 0
    while True:
        level += 1
        new = (back @ front > 0) & (dist == inf_d)
        if not new.any():
            return dist.T.copy()
        dist[new] = level
        front = new.astype(np.float32)


# --- phase 3b: the frontier update ---------------------------------------------

def timed_update(torch, engine, g0, lab0, batch):
    """api.update through `engine` with the launch and wave counts set to
    0 just before: ((g, lab, aff), seconds, waves, launches)."""
    from repro_torch import api
    from repro_torch.core import engine as teng
    reset_launches()
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = api.update(g0, lab0, batch, engine=engine)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(teng.WAVES), read_launches()


def assert_same_update(torch, got, want, what: str) -> None:
    (g, lab, aff), (g2, lab2, aff2) = got, want
    for name, a, b in (("src", g.src, g2.src), ("dst", g.dst, g2.dst),
                       ("valid", g.valid, g2.valid), ("w", g.w, g2.w),
                       ("dist", lab.dist, lab2.dist),
                       ("hub", lab.hub, lab2.hub),
                       ("highway", lab.highway, lab2.highway),
                       ("aff", aff, aff2)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")


def wave_kinds(waves: dict) -> dict:
    out = {}
    for k in ("search_improved", "repair_base", "repair"):
        total, masked = waves.get(k, 0), waves.get(k + ".masked", 0)
        out[k] = dict(all=total, masked=masked, full=total - masked)
    return out


def run_frontier_update(torch, dev, g0, lab0, batch, full, trickle) -> dict:
    """The phase-3 tick through a frontier engine, held to `full`; then
    the small tick `trickle` through a full-sweep and a frontier engine,
    held to each other."""
    from repro_torch import api
    from repro_torch.core import engine as teng
    from repro_torch.graphs import coo
    from repro_torch.kernels.edge_relax import ops as rops

    def engine(frontier, threshold=FRONTIER_THRESHOLD):
        return teng.RelaxEngine(block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                                frontier=frontier,
                                frontier_threshold=threshold,
                                frontier_block=FRONTIER_BLOCK, device=dev)

    fr = engine(True)
    got, wall, waves, launches = timed_update(torch, fr, g0, lab0, batch)
    assert_same_update(torch, got, full, "phase-3 tick")
    if launches["relax_sweep"] <= 0:
        raise AssertionError("the frontier update launched no relax sweep")
    # Again with the plan cached: the waves and the per-tick bookkeeping
    # without the two host tilings.
    again, warm, _, _ = timed_update(torch, fr, g0, lab0, batch)
    assert_same_update(torch, again, full, "phase-3 tick, plan cached")
    del again
    ft = fr.prepare(got[0], topology_changed=False).frontier
    src, dst = got[0].src.cpu().numpy(), got[0].dst.cpu().numpy()
    keep = got[0].valid.cpu().numpy()
    t0 = time.perf_counter()
    rops.prepare_topology(src, dst, keep, g0.n, api.BLOCK_V, 1, api.BLOCK_E,
                          device=dev)
    torch.cuda.synchronize()
    topo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rops.prepare_frontier(src, dst, keep, g0.n, FRONTIER_BLOCK,
                          threshold=FRONTIER_THRESHOLD, device=dev)
    torch.cuda.synchronize()
    frontier_s = time.perf_counter() - t0
    out = dict(update_s=wall, update_cached_plan_s=warm,
               waves=wave_kinds(waves), launches=launches,
               nrows=ft.nrows, rows_cap=ft.rows_cap, nbf=ft.nbf,
               row_slots=ft.src_r.numel(), prepare_topology_s=topo_s,
               prepare_frontier_s=frontier_s)
    log(f"phase 3b: frontier update (threshold {FRONTIER_THRESHOLD}, "
        f"blocks of {FRONTIER_BLOCK}) {wall:.3f} s ({warm:.3f} s with the "
        f"plan cached) == full-sweep update on "
        f"slots, labelling and aff; waves {out['waves']}; launches "
        f"{launches}; {ft.nrows} rows ({ft.nbf} blocks), rows_cap "
        f"{ft.rows_cap}; host prepare: topology {topo_s:.3f} s, frontier "
        f"{frontier_s:.3f} s")

    # The trickle tick through three engines, each plan tiled before the
    # timed update: full sweep, the frontier mode, and the frontier mode
    # at threshold 1.0 (every wave masked).
    g_new = coo.apply_batch(g0, trickle)
    out["trickle"] = dict(rows=int(trickle.valid.sum()))
    want = None
    for name, eng in (("full", engine(False)), ("frontier", fr),
                      ("masked", engine(True, 1.0))):
        eng.prepare(g_new)
        got, secs, waves, launches = timed_update(torch, eng, g0, lab0,
                                                  trickle)
        if want is None:
            want = got
        else:
            assert_same_update(torch, got, want, f"trickle tick ({name})")
        out["trickle"][name] = dict(update_s=secs, waves=wave_kinds(waves),
                                    launches=launches)
        log(f"phase 3b trickle ({out['trickle']['rows']} updates, {name}, "
            f"plan cached): {secs:.3f} s, waves {wave_kinds(waves)}, "
            f"launches {launches}")
    if any(k["full"] for k in out["trickle"]["masked"]["waves"].values()):
        raise AssertionError("threshold 1.0 ran a full wave")
    return out, fr


# --- phase 5: kernels C and D on their own paths --------------------------------

def time_edge_relax(torch, dev, g1, lab1) -> dict:
    """Kernel C through `ops.prepare` / `ops.edge_relax` on the
    post-update graph, one plane, step 1."""
    from repro_torch import api
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops
    from repro_torch.kernels.edge_relax import ref as rref

    t0 = time.perf_counter()
    bg = rops.prepare(g1.src.cpu().numpy(), g1.dst.cpu().numpy(),
                      g1.valid.cpu().numpy(), g1.n, api.BLOCK_V, 1,
                      api.BLOCK_E, device=dev)
    prep_s = time.perf_counter() - t0
    keys = lab1.dist[0].contiguous()
    reset_launches()
    got = rops.edge_relax(keys, bg, 1)
    torch.cuda.synchronize()
    launches = read_launches()["edge_relax"]
    if launches != 1:
        raise AssertionError(f"ops.edge_relax launched {launches} kernels")
    args = (keys, bg.src_t, bg.dstloc_t, bg.valid_t, bg.rowblk_t, 1, g1.n,
            bg.block_v, bg.nb)
    want = rk.edge_relax_plain(*args)
    coo = rref.edge_relax(keys, g1.src, g1.dst, g1.valid, 1, g1.n)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, coo):
        raise AssertionError("edge_relax at full size != plain / COO oracle")
    ms, plain = paired_ms(lambda: rk.edge_relax(*args),
                          lambda: rk.edge_relax_plain(*args), 10, 3)
    parts = {k: profiled_us(torch, lambda: rk.edge_relax(*args), k, 10) / 1e3
             for k in ("fill_chunked_kernel", "edge_relax_kernel")}
    rows = bg.rowblk_t.numel()
    live = int((bg.valid_t != 0).sum())
    # What this run's data needs: valid_t of every slot, src and local dst
    # of the valid ones, rowblk, keys once and out once.
    nbytes = bg.slots * 4 + live * 8 + rows * 4 + 2 * g1.n * 4
    bms, by = bound_ms(nbytes, 3 * live)   # add, saturate, min per slot
    row = dict(rows=rows, slots=bg.slots, valid_slots=live,
               prepare_s=prep_s, launches=launches, max_abs_err=err, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, bytes=nbytes,
               device_ms=parts)
    log(f"edge_relax (ops.prepare of every slot, block_v={api.BLOCK_V} "
        f"block_e={api.BLOCK_E}): {rows} rows, {bg.slots} slots "
        f"({live} valid), host prepare {prep_s:.3f} s; kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}), max_abs_err {err}"
        f"; == COO oracle; device ms of one call {parts}")
    return row


def time_embed_bag(torch, dev) -> list:
    """Kernel D through `ops.embed_bag` (mean, ~80 % mask) at the MIND
    config's widths, beside `F.embedding_bag` on the same weights."""
    import torch.nn.functional as F
    from repro_torch.kernels.embed_bag import kernel as ek
    from repro_torch.kernels.embed_bag import ops as eops

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(MIND_ITEMS, MIND_DIM, generator=gen, device=dev)
    rows = []
    for b in MIND_BATCHES:
        idx = torch.randint(0, MIND_ITEMS, (b, MIND_HIST), generator=gen,
                            device=dev, dtype=torch.int32)
        mask = torch.rand(b, MIND_HIST, generator=gen, device=dev) < 0.8
        reset_launches()
        got = eops.embed_bag(table, idx, mask, mode="mean")
        torch.cuda.synchronize()
        launches = read_launches()["embed_bag"]
        if launches != 1:
            raise AssertionError(f"ops.embed_bag launched {launches} kernels")
        # The weights and indices ops.embed_bag hands the kernel.
        w = mask.to(torch.float32)
        w = w / w.sum(1, keepdim=True).clamp_min(1.0)
        idx_m = torch.where(mask, idx, 0)
        idx64 = idx_m.long()
        want = ek.embed_bag_plain(table, idx_m, w)
        lib = F.embedding_bag(idx64, table, per_sample_weights=w, mode="sum")
        torch.cuda.synchronize()
        if not torch.equal(got, ek.embed_bag(table, idx_m, w)):
            raise AssertionError("ops.embed_bag != the kernel on its weights")
        for what, ref in (("plain", want), ("F.embedding_bag", lib)):
            torch.testing.assert_close(got, ref, rtol=BAG_TOL, atol=BAG_TOL,
                                       msg=f"embed_bag B={b} != {what}")
        err = float((got - want).abs().max())
        reps = 50 if b <= 512 else 10
        ms, plain = paired_ms(lambda: ek.embed_bag(table, idx_m, w),
                              lambda: ek.embed_bag_plain(table, idx_m, w),
                              reps, 3)
        lib_ms = min(cuda_ms(lambda: F.embedding_bag(
            idx64, table, per_sample_weights=w, mode="sum"), reps)
            for _ in range(2))
        # What this run's data needs: each distinct gathered row once,
        # idx and w of every slot, out once. (Every slot's row, the
        # count with repeats, would be B·L·4·D.)
        distinct = int(torch.unique(idx_m).numel())
        nbytes = (distinct * 4 * MIND_DIM + b * MIND_HIST * 8
                  + 4 * b * MIND_DIM)
        bms, by = bound_ms(nbytes, 2 * b * MIND_HIST * MIND_DIM)
        rows.append(dict(batch=b, launches=launches, max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, bytes=nbytes, distinct_rows=distinct,
                         bytes_every_slot=b * MIND_HIST * (4 * MIND_DIM + 8)
                         + 4 * b * MIND_DIM,
                         lib_max_abs_err=float((got - lib).abs().max())))
        log(f"embed_bag B={b} L={MIND_HIST} D={MIND_DIM} (table "
            f"{MIND_ITEMS} rows, {distinct} distinct gathered): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"F.embedding_bag {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"max_abs_err {err:.3g} (vs library "
            f"{rows[-1]['lib_max_abs_err']:.3g})")
    del table
    return rows


# --- phase 6: the serving loop at full width ----------------------------------

SERVE_BATCHES = 3
SERVE_BATCH = 1024
SERVE_QUERIES = 256
SERVE_QPS = 2000.0
SERVE_CHECK = 32   # served answers per version held to the COO path and BFS
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"   # checkpoints, removed after


def memoise_ba() -> None:
    """Generate each Barabási–Albert graph once per run of this script: the
    serve loop regenerates its graph at every start, and at 2^20 that
    pure-Python generator takes longer than the rest of a loop's start."""
    from repro_torch.graphs import generators as gen
    made: dict = {}
    orig = gen.barabasi_albert

    def barabasi_albert(n, m, seed=0):
        if (n, m, seed) not in made:
            made[n, m, seed] = orig(n, m, seed)
        return made[n, m, seed].copy()
    gen.barabasi_albert = barabasi_albert


def same_snapshot(torch, got, want, what: str) -> None:
    """Two snapshots bit for bit: version, n, graph slots, labelling."""
    if (got.version, got.graph.n) != (want.version, want.graph.n):
        raise AssertionError(f"{what}: version/n {got.version}/{got.graph.n}"
                             f" != {want.version}/{want.graph.n}")
    for part in ("graph", "labelling"):
        a, b = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if torch.is_tensor(x) and not torch.equal(x, y):
                raise AssertionError(f"{what}: {part}.{f.name} differs")


def step_syncs(torch, gen, sources: dict):
    """Drive a pipelined update one step at a time, counting each step's
    host syncs: ([(phase tag, syncs)], syncs of the last step, result);
    `sources` gets the file:line of each sync, by phase tag."""
    steps = []
    while True:
        box = {}

        def step():
            try:
                box["tag"] = next(gen)
            except StopIteration as stop:
                box["result"] = stop.value
        where: list = []
        n = host_syncs(torch, step, where)
        tag = box.get("tag", "finish")
        sources[tag] = sorted(set(sources.get(tag, [])) | set(where))
        if "result" in box:
            return steps, n, box["result"]
        steps.append((tag, n))


def chunk_profile(torch, snap, batch, plan, g_new, want, what: str,
                  fused: bool = False) -> dict:
    """One pipelined update (chunk_sweeps 1) stepped by hand: chunks per
    phase and the host syncs of each step, held to `want` (g, lab, aff)."""
    from repro_torch.core import engine as teng
    from repro_torch.core import snapshot as tsnap
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sources: dict = {}
    steps, last, (nxt, aff) = step_syncs(torch, tsnap.pipelined_update(
        snap, batch, plan=plan, g_new=g_new, fused=fused), sources)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g, lab, aff_want = want
    same_snapshot(torch, nxt, dataclasses.replace(nxt, graph=g,
                                                  labelling=lab), what)
    if not torch.equal(aff, aff_want):
        raise AssertionError(f"{what}: aff differs")
    by_tag: dict = {}
    for tag, n in steps:
        by_tag.setdefault(tag, []).append(n)
    out = dict(wall_s=wall, chunks={k: len(v) for k, v in by_tag.items()},
               syncs={k: v for k, v in by_tag.items()},
               last_step_syncs=last, sync_sources=sources,
               waves=dict(teng.WAVES))
    log(f"phase 6 chunks ({what}): {wall:.3f} s, chunks per phase "
        f"{out['chunks']}; host syncs per step {out['syncs']}, last step "
        f"{last}, at {sources}; == the monolithic update (slots, "
        "labelling, aff)")
    return out


def served_answers(reports, version: int, k: int):
    """The first `k` (s, t, answer) served at `version` across `reports`."""
    rows = []
    for rep in reports:
        for m in rep.microbatches:
            if m.version == version:
                rows += list(zip(m.qs.tolist(), m.qt.tolist(),
                                 m.answers.tolist()))
    return rows[:k]


def check_served(torch, np, dev, snap, rows, what: str) -> None:
    """Served answers against the COO path at their version and BFS."""
    from repro_torch.core import query as tq
    from repro_torch.graphs.coo import INF_D
    s = np.asarray([r[0] for r in rows], np.int32)
    t = np.asarray([r[1] for r in rows], np.int32)
    got = np.asarray([r[2] for r in rows])
    coo = tq.batched_query(snap.graph, snap.labelling,
                           torch.from_numpy(s).to(dev),
                           torch.from_numpy(t).to(dev), use_kernel=False,
                           plan=None).cpu().numpy()
    bfs = bfs_dist(csr_of(snap.graph, np), s, np, INF_D)[np.arange(len(s)),
                                                           t]
    if not (np.array_equal(got, coo) and np.array_equal(got, bfs)):
        raise AssertionError(f"{what}: served answers != COO path / BFS")


def check_dist_bfs(np, snap, what: str) -> None:
    from repro_torch.graphs.coo import INF_D
    lab = snap.labelling
    want = bfs_dist(csr_of(snap.graph, np), lab.landmarks.cpu().numpy(), np,
                    INF_D)
    if not np.array_equal(lab.dist.cpu().numpy(), want):
        raise AssertionError(f"{what}: dist != scipy BFS")


def serve_row(rep, wall: float) -> dict:
    pct = rep.latency_percentiles()
    ticks = [dict(tick=t.tick, update_s=t.update_s, affected=t.affected,
                  grew=t.grew, capacity=t.capacity, ckpt_s=t.ckpt_s)
             for t in rep.ticks]
    return dict(wall_s=wall, ticks=ticks, latency_s=pct,
                mean_staleness=rep.mean_staleness(),
                microbatches=len(rep.microbatches),
                growth=[dataclasses.asdict(e) for e in rep.growth])


def run_serve(torch, np, dev, g0, lab0, batch, full, trickle, fr) -> dict:
    """Phase 6: the update variants and the pipelined update's chunks on
    the phase-3 tick, then the single-process serve loop at full width in
    pipeline, sync, fused, resume and growth runs, held to each other and
    to scipy BFS."""
    import shutil
    from repro_torch import api
    from repro_torch.core import batch as tbat
    from repro_torch.core import engine as teng
    from repro_torch.core import snapshot as tsnap
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.graphs import generators as gen
    from repro_torch.launch.serve import EdgeSet, ServeConfig, ServeLoop

    t_phase = time.perf_counter()
    out: dict = {}
    g1, lab1, aff1 = full

    # BHLˢ on the phase-3 batch and UHL⁺ on the trickle batch, each through
    # an engine on the card, held to the COO path (engine=None).
    for name, fn, b in (("split", tbat.batchhl_update_split, batch),
                        ("uhl", tbat.uhl_update, trickle)):
        eng = teng.RelaxEngine(block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                               device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(g0, b, lab0, engine=eng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()["relax_sweep"]
        t0 = time.perf_counter()
        want = fn(g0, b, lab0, engine=None)
        assert_same_update(torch, got, want, f"{name} (engine vs COO)")
        coo_s = time.perf_counter() - t0
        out[name] = dict(rows=int(b.valid.sum()), seconds=secs,
                         retiles=eng.retile_count, relax_launches=launches,
                         coo_s=coo_s)
        log(f"phase 6 {name}: {out[name]['rows']} rows, {secs:.3f} s, "
            f"{eng.retile_count} retiles, {launches} relax_sweep launches; "
            f"== COO path (slots, labelling, aff; {coo_s:.1f} s)")
        del got, want, eng

    # The pipelined update's chunks on the phase-3 tick: full sweep (fused
    # and not) and the frontier mode.
    plan1 = api.default_engine(dev).prepare(g1)
    snap0 = tsnap.Snapshot(0, g0, lab0, None)
    out["per_item_syncs"] = host_syncs(torch,
                                       lambda: g1.valid[:1].sum().item())
    out["chunks"] = {
        "full": chunk_profile(torch, snap0, batch, plan1, g1, full, "full"),
        "fused": chunk_profile(torch, snap0, batch, plan1, g1, full,
                               "fused", fused=True),
        "frontier": chunk_profile(torch, snap0, batch, fr.prepare(g1), g1,
                                  full, "frontier")}

    # The serve loop. Every run gets run A's capacity (the loop's default
    # sizes it from the run's own tick count), so that the runs cut after 2
    # ticks hold the same slots.
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    edges = int(g0.valid.sum()) // 2
    capacity = edges + 64 + get_scenario("mixed").max_inserts(SERVE_BATCHES,
                                                              SERVE_BATCH)
    base = dict(n=N, deg=BA_M, landmarks=LANDMARKS, batches=SERVE_BATCHES,
                capacity=capacity,
                batch_size=SERVE_BATCH, scenario="mixed",
                queries=SERVE_QUERIES, qps=SERVE_QPS, microbatch=MICROBATCH,
                chunk_sweeps=1, block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                quiet=True)

    def serve(what, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ServeLoop(ServeConfig(**{**base, **kw}), device=dev).run()
        torch.cuda.synchronize()
        row = serve_row(rep, time.perf_counter() - t0)
        out[what] = row
        pct = row["latency_s"]
        log(f"phase 6 serve {what}: {row['wall_s']:.1f} s; ticks "
            + "; ".join(f"{t['tick']}: update {t['update_s']:.3f} s, "
                        f"{t['affected']} affected, grew {t['grew']}, "
                        f"ckpt {t['ckpt_s']:.3f} s" for t in row["ticks"])
            + f" | latency p50 {pct['p50'] * 1e3:.1f} ms p95 "
            f"{pct['p95'] * 1e3:.1f} ms p99 {pct['p99'] * 1e3:.1f} ms, "
            f"mean staleness {row['mean_staleness']:.3f}, "
            f"{row['microbatches']} microbatches")
        return rep

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    teng.WAVES.clear()
    rep_a = serve("pipeline", pipeline=True, keep_history=True,
                  ckpt_dir=str(SERVE_DIR / "a"))
    out["pipeline"]["launches"] = launches = read_launches()
    out["pipeline"]["waves"] = dict(teng.WAVES)
    if launches["relax_sweep"] <= 0 or launches["minplus"] <= 0:
        raise AssertionError(f"the serve loop skipped a kernel: {launches}")
    rep_b = serve("sync", keep_history=True)
    same_snapshot(torch, rep_b.final, rep_a.final, "sync vs pipeline")
    for v in rep_a.history:
        same_snapshot(torch, rep_b.history[v], rep_a.history[v],
                      f"sync vs pipeline, version {v}")
    t0 = time.perf_counter()
    checked = {}
    for v, snap in sorted(rep_a.history.items()):
        rows = served_answers((rep_a, rep_b), v, SERVE_CHECK)
        if rows:
            check_served(torch, np, dev, snap, rows, f"version {v}")
        checked[v] = len(rows)
    check_dist_bfs(np, rep_a.final, "serve final")
    out["checked_answers"] = checked
    out["check_s"] = time.perf_counter() - t0
    log(f"phase 6: sync == pipeline at every version; served answers == "
        f"COO path == scipy BFS per version {checked}; final dist == scipy "
        f"BFS from all {LANDMARKS} landmarks ({out['check_s']:.1f} s of "
        f"checks); launches {launches}")
    del rep_b
    rep = serve("fused", pipeline=True, fused=True)
    same_snapshot(torch, rep.final, rep_a.final, "fused vs pipeline")
    del rep

    # Checkpoints: restore run A's last step, then resume a 2-tick run.
    step = SERVE_DIR / "a" / f"step_{SERVE_BATCHES}"
    nbytes = sum(f.stat().st_size for f in step.iterdir())
    # Run A's version 0 beside its ticks' steps, with the leaves its loop
    # checkpoints carry: phase 9's updater resumes from it.
    t0 = time.perf_counter()
    tsnap.save_snapshot(str(SERVE_DIR / "a"), rep_a.history[0], extra={
        "edge_list": EdgeSet(gen.barabasi_albert(N, BA_M, seed=0)).edges(),
        "base_n": np.int64(N)})
    out["seed_step_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = tsnap.restore_snapshot(str(SERVE_DIR / "a"), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_snapshot(torch, dataclasses.replace(back, plan=None),
                  dataclasses.replace(rep_a.final, plan=None), "restore")
    out["checkpoint"] = dict(bytes=nbytes, restore_s=restore_s,
                             save_s=[t["ckpt_s"] for t in
                                     out["pipeline"]["ticks"]])
    log(f"phase 6 checkpoint: step of {nbytes} bytes, saves "
        f"{out['checkpoint']['save_s']} s, restore {restore_s:.3f} s "
        "== run A's final snapshot")
    del back
    serve("resume_first", pipeline=True, batches=2,
          ckpt_dir=str(SERVE_DIR / "r"))
    rep = serve("resume", pipeline=True, ckpt_dir=str(SERVE_DIR / "r"),
                resume=True)
    same_snapshot(torch, rep.final, rep_a.final, "resumed vs pipeline")
    final_a = rep_a.final
    del rep, rep_a
    # Run A's steps stay for phase 9, which removes them.
    shutil.rmtree(SERVE_DIR / "r", ignore_errors=True)

    # Growth: pure inserts from a capacity 64 pairs above the edge count.
    rep = serve("growth", pipeline=True, scenario="growth", batches=2,
                capacity=edges + 64, grow=True)
    if not rep.growth:
        raise AssertionError("the growth run did not grow")
    t0 = time.perf_counter()
    check_dist_bfs(np, rep.final, "growth final")
    log(f"phase 6 growth: {len(rep.growth)} growths, capacity "
        f"{rep.growth[0].old_capacity} -> {rep.final.graph.capacity}; "
        f"final dist == scipy BFS ({time.perf_counter() - t0:.1f} s)")
    del rep
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 6: {out['wall_s']:.1f} s, peak device memory "
        f"{out['peak_gb']:.2f} GB")
    return out, base, final_a


# --- phase 7: directed BatchHL at full width -----------------------------------

DIRECTED_P = 0.7       # an edge u-v becomes u->v with this probability
DIRECTED_SLACK = 2048  # free arc slots
DIRECTED_CHECK = 64    # answers held to scipy BFS


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def run_directed(torch, np, dev, edges) -> dict:
    """Phase 7: the BA(2^20, 4) edges oriented at random into arcs, built,
    updated once (512 deletions, 512 insertions) and queried (1024 pairs)
    through one engine per orientation; held to scipy BFS and to the COO
    path."""
    from repro_torch import api
    from repro_torch.core import directed as tdir
    from repro_torch.core import engine as teng
    from repro_torch.graphs.coo import INF_D, make_batch

    t_phase = time.perf_counter()
    out: dict = {}
    rng = np.random.default_rng(7)
    fwd = rng.random(len(edges)) < DIRECTED_P
    arcs = np.where(fwd[:, None], edges[:, :2], edges[:, 1::-1])
    arcs = np.ascontiguousarray(arcs, np.int32)
    deg = np.bincount(arcs.ravel(), minlength=N)
    landmarks = np.argsort(-deg, kind="stable")[:LANDMARKS].astype(np.int32)
    g0 = tdir.from_arcs(N, arcs, len(arcs) + DIRECTED_SLACK, device=dev)
    lms = torch.from_numpy(landmarks).to(dev)

    def engines():
        return [teng.RelaxEngine(block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                                 device=dev) for _ in range(2)]

    def plans(engs, g):
        """Each orientation's plan from its engine, and the host seconds
        of each prepare."""
        ps, secs = [], []
        for eng, og in zip(engs, (g.fwd(), g.rev())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps.append(eng.prepare(og))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return ps, secs

    engs = engines()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (pf, pb), out["build_tiling_s"] = plans(engs, g0)
    lab0 = tdir.build_directed_labelling(g0, lms, pf, pb)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_waves"] = dict(teng.WAVES)

    existing = set(zip(arcs[:, 0].tolist(), arcs[:, 1].tolist()))
    urng = np.random.default_rng(8)
    picks = urng.choice(len(arcs), size=N_DEL, replace=False)
    ups = [(int(arcs[i, 0]), int(arcs[i, 1]), True) for i in picks]
    while len(ups) < N_DEL + N_INS:
        u, v = (int(x) for x in urng.integers(0, N, 2))
        if u != v and (u, v) not in existing:
            existing.add((u, v))
            ups.append((u, v, False))
    batch = make_batch(ups, pad_to=N_DEL + N_INS, device=dev)
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g1_new = tdir.apply_batch_directed(g0, batch)
    (pf1, pb1), out["update_tiling_s"] = plans(engs, g1_new)
    g1, lab1, aff1 = tdir.batchhl_update_directed(g0, batch, lab0, pf1, pb1,
                                                  g_new=g1_new)
    torch.cuda.synchronize()
    out["update_s"] = time.perf_counter() - t0
    out["update_waves"] = dict(teng.WAVES)
    out["affected"] = int(aff1.sum())

    qrng = np.random.default_rng(9)
    qs = qrng.integers(0, N, QUERIES).astype(np.int32)
    qt = qrng.integers(0, N, QUERIES).astype(np.int32)
    teng.WAVES.clear()
    mb_ms, answers = [], []
    for i in range(QUERIES // MICROBATCH):
        sl = slice(i * MICROBATCH, (i + 1) * MICROBATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers.append(tdir.directed_query(
            g1, lab1, torch.from_numpy(qs[sl]).to(dev),
            torch.from_numpy(qt[sl]).to(dev), max_steps=MAX_STEPS,
            plan_fwd=pf1, plan_bwd=pb1))
        torch.cuda.synchronize()
        mb_ms.append((time.perf_counter() - t0) * 1e3)
    answers = torch.cat(answers).cpu().numpy()
    out["launches"] = read_launches()
    out["bibfs_waves"] = teng.WAVES["directed_bibfs"]
    out["query_mb_ms"] = dict(p50=statistics.median(mb_ms),
                              p99=percentile(mb_ms, 0.99), max=max(mb_ms),
                              runs=mb_ms)
    out["reachable"] = int((answers < INF_D).sum())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if out["launches"]["relax_sweep"] <= 0:
        raise AssertionError("directed BatchHL launched no relax sweep")
    log(f"phase 7: directed BA({N}, {BA_M}) {len(arcs)} arcs, capacity "
        f"{len(arcs) + DIRECTED_SLACK}; build {out['build_s']:.3f} s "
        f"(tilings {out['build_tiling_s']}), waves {out['build_waves']}; "
        f"update {out['update_s']:.3f} s (tilings {out['update_tiling_s']}), "
        f"waves {out['update_waves']}, {out['affected']} affected; queries "
        f"p50 {out['query_mb_ms']['p50']:.1f} ms p99 "
        f"{out['query_mb_ms']['p99']:.1f} ms per microbatch, "
        f"{out['bibfs_waves'] / len(mb_ms):.2f} BiBFS waves per microbatch, "
        f"{out['reachable']}/{QUERIES} reachable; launches {out['launches']};"
        f" peak {out['peak_gb']:.2f} GB")

    # Hold it: landmark distances both ways, sampled answers, the COO path.
    t0 = time.perf_counter()
    for tag, g, lab in (("build", g0, lab0), ("update", g1, lab1)):
        csr = csr_of(g.fwd(), np)
        for name, plane, m in (("fwd", lab.fwd, csr), ("bwd", lab.bwd,
                                                       csr.T.tocsr())):
            want = bfs_dist(m, landmarks, np, INF_D)
            if not np.array_equal(plane.dist.cpu().numpy(), want):
                raise AssertionError(f"directed {name}.dist after {tag} != "
                                     "scipy BFS")
    k = DIRECTED_CHECK
    want = bfs_dist(csr_of(g1.fwd(), np), qs[:k], np, INF_D)[np.arange(k),
                                                            qt[:k]]
    if not np.array_equal(answers[:k], want):
        raise AssertionError("directed answers != scipy BFS")
    g_ref, lab_ref, aff_ref = tdir.batchhl_update_directed(g0, batch, lab0)
    for name, a, b in (("src", g_ref.src, g1.src), ("dst", g_ref.dst, g1.dst),
                       ("valid", g_ref.valid, g1.valid), ("w", g_ref.w, g1.w),
                       ("aff", aff_ref, aff1)):
        if not torch.equal(a, b):
            raise AssertionError(f"directed update: COO path != kernel path "
                                 f"on {name}")
    for plane in ("fwd", "bwd"):
        for f in ("dist", "hub", "highway"):
            if not torch.equal(getattr(getattr(lab_ref, plane), f),
                               getattr(getattr(lab1, plane), f)):
                raise AssertionError(f"directed update: COO path != kernel "
                                     f"path on {plane}.{f}")
    del g_ref, lab_ref, aff_ref
    ans_ref = tdir.directed_query(
        g1, lab1, torch.from_numpy(qs[:MICROBATCH]).to(dev),
        torch.from_numpy(qt[:MICROBATCH]).to(dev), max_steps=MAX_STEPS)
    if not np.array_equal(ans_ref.cpu().numpy(), answers[:MICROBATCH]):
        raise AssertionError("directed answers: COO path != kernel path")
    out["check_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 7: fwd/bwd dist == scipy BFS (and on the transpose) from "
        f"all {LANDMARKS} landmarks after build and update; {k} answers == "
        f"scipy BFS; the update and one microbatch == the COO path "
        f"({out['check_s']:.1f} s of checks); phase {out['wall_s']:.1f} s")
    return out


# --- phase 8: the autotuner at full width ----------------------------------------

TUNE_DIR = ROOT / "build" / "chip_smoke_tune"   # the tuning table, removed


def run_autotune(torch, dev, base: dict, want) -> dict:
    """Phase 8: phase 6's run A (pipeline mode, without its checkpoints and
    history) with `autotune=True` and a tuning table on disk: it tunes once,
    at the fresh snapshot, and serves the winner. Its final snapshot must be
    run A's (`want`); a second loop on the same table must tune nothing and
    commit the same."""
    import shutil
    from repro_torch.launch.serve import ServeConfig, ServeLoop

    t_phase = time.perf_counter()
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    table = str(TUNE_DIR / "table.json")
    cfg = dict(base, pipeline=True, autotune=True, tune_table=table)
    out: dict = {}

    def peak_at_start(_snap):
        out["peak_gb_tune_and_build"] = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loop = ServeLoop(ServeConfig(**cfg), device=dev)
    loop.on_start = peak_at_start
    rep = loop.run()
    torch.cuda.synchronize()
    out["run_t_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    res = loop.engine.last_tune
    if loop.engine.tune_count != 1 or res is None:
        raise AssertionError(f"run T tuned {loop.engine.tune_count} times")
    out["tune"] = dict(
        winner=res.config.to_dict(), steady_us=res.steady_us,
        compile_us=res.compile_us, coo_us=res.jnp_us, wall_s=res.wall_s,
        candidates=[dict(config=c.to_dict(), compile_us=cu, steady_us=su)
                    for c, cu, su in res.candidates])
    out["engine"] = dict(block_v=loop.engine.block_v,
                         block_e=loop.engine.block_e,
                         retiles=loop.engine.retile_count)
    out["ticks"] = [dict(tick=t.tick, update_s=t.update_s)
                    for t in rep.ticks]
    out["latency_s"] = rep.latency_percentiles()
    for c in out["tune"]["candidates"]:
        log(f"phase 8 candidate {c['config']}: compile {c['compile_us']:.1f} "
            f"us, steady {c['steady_us']:.1f} us")
    log(f"phase 8 run T: winner {res.config.to_dict()} steady "
        f"{res.steady_us:.1f} us (COO path {res.jnp_us:.1f} us); tune wall "
        f"{res.wall_s:.1f} s; peak device memory through the tune and the "
        f"build {out['peak_gb_tune_and_build']:.2f} GB; run {out['run_t_s']:.1f}"
        f" s, ticks {[round(t['update_s'], 3) for t in out['ticks']]} s, "
        f"engine {out['engine']}, launches {out['launches']}")
    same_snapshot(torch, rep.final, want, "run T vs run A")
    if res.config.impl == "kernel" and out["launches"]["relax_sweep"] <= 0:
        raise AssertionError("run T's kernel winner launched no relax sweep")
    del rep, loop

    t0 = time.perf_counter()
    loop = ServeLoop(ServeConfig(**cfg), device=dev)
    rep = loop.run()
    torch.cuda.synchronize()
    out["run_t2_s"] = time.perf_counter() - t0
    if loop.engine.tune_count != 0:
        raise AssertionError("run T' tuned again on the same table")
    same_snapshot(torch, rep.final, want, "run T' vs run A")
    del rep, loop
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8: run T == run A's final snapshot; run T' "
        f"({out['run_t2_s']:.1f} s) tuned nothing and == run A; phase "
        f"{out['wall_s']:.1f} s")
    return out


# --- phase 9: the replica tier at full width ---------------------------------------

REPLICA_DIR = ROOT / "build" / "chip_smoke_replica"   # publish dir, removed
REPLICA_READERS = 2
REPLICA_WORKERS = 32      # client connections, one query per request
REPLICA_MAX_S = 90.0      # the stream's arrival schedule; `until` ends it
REPLICA_RESTART_S = 60.0  # how long the stream waits for the restarted reader
REPLICA_AFTER_S = 5.0     # the stream runs on this long after its first ack
REPLICA_CHECK = 32        # served answers per version held to the COO path


def dump_role_logs(log_dir: Path, lines: int = 40) -> None:
    """The last lines of each role's log, on stderr."""
    for path in sorted(log_dir.glob("*.log")):
        print(f"--- {path.name} (last {lines} lines)", file=sys.stderr)
        print("\n".join(path.read_text(errors="replace")
                        .splitlines()[-lines:]), file=sys.stderr)


def role_lines(log_dir: Path, prefix: str) -> list:
    """The JSON records after `prefix` in every role's log."""
    out = []
    for path in sorted(log_dir.glob("*.log")):
        for line in path.read_text(errors="replace").splitlines():
            if line.startswith(prefix):
                out.append(json.loads(line[len(prefix):]))
    return out


def card_memory_mib() -> int:
    """The card's used memory in MiB, all processes and contexts together
    (`nvidia-smi` in a container does not list them one by one)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30, check=True)
    return int(out.stdout.split()[0])


def pct_ms(xs) -> dict:
    import numpy as np
    if not len(xs):
        return {}
    return {p: float(np.percentile(xs, q)) * 1e3
            for p, q in (("p50", 50), ("p95", 95), ("p99", 99))}


def run_replica(torch, np, dev, base: dict) -> dict:
    """Phase 9: the replica tier (`launch/replica.py`) on the card at run
    A's configuration: an updater resumed from run A's version 0, two
    readers and a router, each its own process on the GPU, and an
    open-loop stream of single-query requests at 2000/s through the
    router until the updater has published its last version. Reader 0 is
    killed once version 1 is published and the topology restarts it. The
    published steps must be run A's byte for byte; served answers equal
    the COO path and scipy BFS at their version; staleness ≤ 1; every
    offered query answered or rejected; kernels A and B launched in each
    reader that was stopped cleanly and kernel A in the updater."""
    import filecmp
    import shutil
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import snapshot as tsnap
    from repro_torch.launch import replica
    from repro_torch.launch.config import ServeSpec, TopologySpec
    from repro_torch.launch.serve import ServeConfig

    t_phase = time.perf_counter()
    pub = str(REPLICA_DIR)
    logs = REPLICA_DIR / "logs"
    run_a = SERVE_DIR / "a"
    shutil.rmtree(REPLICA_DIR, ignore_errors=True)
    # The updater resumes from run A's version 0 instead of regenerating
    # BA(2^20, 4) (pure Python, 19-30 s) and building the labelling.
    shutil.copytree(run_a / "step_0", REPLICA_DIR / "step_0")
    spec = ServeSpec.from_serve_config(
        ServeConfig(**{**base, "pipeline": True, "resume": True,
                       "quiet": False}),
        topology=TopologySpec(readers=REPLICA_READERS, restart=True))
    # device=None: every role resolves the GPU itself.
    topo = replica.ReplicaTopology(spec, pub, log_dir=str(logs))
    out: dict = {}
    kill: dict = {}
    card_mib: list = []
    last_smi = [0.0]

    def restarted_acked() -> bool:
        rec = replica.read_acks(pub).get(0)
        return ("pid" in kill and rec is not None
                and rec["pid"] == topo.readers[0].pid != kill["pid"]
                and rec["version"] == ckpt.current_step(pub))

    def on_tick() -> None:
        now = time.monotonic()
        if "pid" not in kill and (ckpt.current_step(pub) or 0) >= 1:
            kill.update(pid=topo.readers[0].pid, t=now,
                        head=ckpt.current_step(pub))
            topo.kill_reader(0)
        if now - last_smi[0] > 1.0:
            last_smi[0] = now
            card_mib.append(card_memory_mib())
        if "acked" not in kill and restarted_acked():
            kill["acked"] = now

    def until() -> bool:
        if topo.updater_running() or "pid" not in kill:
            return False
        now = time.monotonic()
        if "acked" in kill:
            return now - kill["acked"] >= REPLICA_AFTER_S
        return now - kill["t"] > REPLICA_RESTART_S

    try:
        t0 = time.perf_counter()
        topo.start()
        out["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = replica.stream_queries(
            spec, topo, int(SERVE_QPS * REPLICA_MAX_S), SERVE_QPS,
            workers=REPLICA_WORKERS, on_tick=on_tick, until=until)
        out["stream_s"] = time.perf_counter() - t0
        out["restarted_acked"] = restarted_acked()
    finally:
        topo.stop()
    updater_rc = topo.updater.returncode

    # What the roles wrote down.
    exits = role_lines(logs, "replica exit: ")
    maps = role_lines(logs, "replica map: ")
    publishes = role_lines(logs, "replica publish: ")
    spawned0 = topo.reader_spawned[0]
    first = [m for m in maps if m["pid"] == topo.readers[0].pid]
    out.update(
        updater_rc=updater_rc, reader_restarts=report.reader_restarts,
        killed=dict(pid=kill.get("pid"), head=kill.get("head")),
        offered=report.offered,
        answered=len(report.answers), rejected=report.rejected,
        offered_qps=report.offered / out["stream_s"],
        answered_qps=len(report.answers) / out["stream_s"],
        latency_ms=pct_ms([a.latency_s for a in report.answers]),
        max_staleness=report.max_staleness(),
        router=report.router_stats,
        barrier_s={p["version"]: p["barrier_s"] for p in publishes},
        barrier_timeouts=sum(not p["barrier_ok"] for p in publishes),
        maps=[{k: m[k] for k in ("reader", "pid", "version", "restore_s",
                                 "prepare_s", "warm_s")} for m in maps],
        restart_to_first_ack_s=(first[0]["acked"] - spawned0) if first
        else None,
        exits=exits,
        peak_device_gb={f"{e['role']}{e.get('reader', '')}:{e['pid']}":
                        e["peak_device_bytes"] / 1e9 for e in exits},
        card_mib_peak=max(card_mib, default=None), card_mib_samples=card_mib)
    # Latency of the queries that arrived while some reader was mapping a
    # version (restore, prepare, warm), against the rest.
    windows = [(m["start"], m["acked"]) for m in maps]
    during = [a.latency_s for a in report.answers
              if any(lo <= a.arrival <= hi for lo, hi in windows)]
    calm = [a.latency_s for a in report.answers
            if not any(lo <= a.arrival <= hi for lo, hi in windows)]
    out["latency_during_map_ms"] = dict(pct_ms(during), n=len(during))
    out["latency_outside_map_ms"] = dict(pct_ms(calm), n=len(calm))
    # A timeline by the second of completion, from the stream's first
    # arrival: answers, their p50 latency, and the events in that second.
    t_first = min((a.arrival for a in report.answers), default=0.0)
    events = [(kill.get("t"), "reader 0 killed"),
              (kill.get("acked"), "reader 0 back")] + [
        (p["t"], f"v{p['version']} published") for p in publishes]
    timeline: dict = {}
    for a in report.answers:
        sec = int(a.arrival + a.latency_s - t_first)
        timeline.setdefault(sec, []).append(a.latency_s)
    out["timeline"] = [
        dict(second=sec, answered=len(xs),
             p50_ms=float(np.percentile(xs, 50)) * 1e3,
             events=[name for t, name in events if t is not None
                     and sec <= t - t_first < sec + 1])
        for sec, xs in sorted(timeline.items())]
    # Each reader's routed batches: size, and the seconds from receipt to
    # the answer sent, while some reader maps and otherwise.
    out["reader_batches"] = {}
    for rec in role_lines(logs, "replica batches: "):
        rows = rec["batches"]
        busy, free = [], []
        for b in rows:
            (busy if any(lo <= b[0] <= hi for lo, hi in windows)
             else free).append(b)
        out["reader_batches"][f"{rec['reader']}:{rec['pid']}"] = dict(
            batches=len(rows),
            mean_size=sum(b[1] for b in rows) / max(1, len(rows)),
            service_ms=pct_ms([b[2] for b in rows]),
            service_during_map_ms=dict(pct_ms([b[2] for b in busy]),
                                       n=len(busy)),
            service_outside_map_ms=dict(pct_ms([b[2] for b in free]),
                                        n=len(free)))
    log(f"phase 9 reader batches: {out['reader_batches']}")
    lat = out["latency_ms"]
    log(f"phase 9: start {out['start_s']:.1f} s, stream {out['stream_s']:.1f}"
        f" s; offered {report.offered} ({out['offered_qps']:.1f}/s), "
        f"answered {len(report.answers)} ({out['answered_qps']:.1f}/s), "
        f"rejected {report.rejected}; latency p50 {lat.get('p50', 0):.1f} ms"
        f" p95 {lat.get('p95', 0):.1f} ms p99 {lat.get('p99', 0):.1f} ms; "
        f"during a map {out['latency_during_map_ms']}, outside "
        f"{out['latency_outside_map_ms']}")
    log("phase 9 timeline (second: answered, p50 ms, events): " + "; ".join(
        f"{r['second']}: {r['answered']}, {r['p50_ms']:.0f}"
        + (f" {r['events']}" if r["events"] else "")
        for r in out["timeline"]))
    log(f"phase 9 router: per reader {report.router_stats.get('per_reader')}"
        f", requeued {report.router_stats.get('requeued')}, reader errors "
        f"{report.router_stats.get('reader_errors')}, staleness "
        f"{report.router_stats.get('staleness')}, max staleness "
        f"{out['max_staleness']}")
    for m in out["maps"]:
        log(f"phase 9 map: reader {m['reader']} (pid {m['pid']}) v"
            f"{m['version']}: restore {m['restore_s']:.3f} s, prepare "
            f"{m['prepare_s']:.3f} s, warm {m['warm_s']:.3f} s")
    log(f"phase 9: reader 0 killed at v{kill.get('head')}, "
        f"{report.reader_restarts} restarts, the restarted reader's spawn "
        f"to first ack "
        f"{out['restart_to_first_ack_s']} s; barrier waits "
        f"{out['barrier_s']} s ({out['barrier_timeouts']} timeouts); "
        f"updater rc {updater_rc}")
    log(f"phase 9 peak device memory: {out['peak_device_gb']} GB "
        f"(torch allocator, per process; the killed reader printed none); "
        f"card memory used, all contexts, peak {out['card_mib_peak']} MiB "
        f"(nvidia-smi, sampled each second)")

    # Hold it.
    if updater_rc != 0:
        raise AssertionError(f"the updater exited rc={updater_rc}")
    if report.reader_restarts < 1 or "pid" not in kill:
        raise AssertionError("reader 0 was not killed and restarted")
    if report.max_staleness() > 1:
        raise AssertionError(f"staleness {report.max_staleness()} > 1")
    if len(report.answers) + report.rejected != report.offered:
        raise AssertionError(f"answered {len(report.answers)} + rejected "
                             f"{report.rejected} != offered "
                             f"{report.offered}")
    t0 = time.perf_counter()
    head = ckpt.current_step(pub)
    if head != SERVE_BATCHES:
        raise AssertionError(f"CURRENT names v{head}")
    for v in range(SERVE_BATCHES + 1):
        names = sorted(os.listdir(run_a / f"step_{v}"))
        if sorted(os.listdir(REPLICA_DIR / f"step_{v}")) != names:
            raise AssertionError(f"published step {v} has other leaves")
        _, bad, err = filecmp.cmpfiles(run_a / f"step_{v}",
                                       REPLICA_DIR / f"step_{v}", names,
                                       shallow=False)
        if bad or err:
            raise AssertionError(f"published step {v} != run A's: {bad}"
                                 f" {err}")
    checked = {}
    for v in sorted({a.version for a in report.answers}):
        rows = [(a.qs, a.qt, a.answer) for a in report.answers
                if a.version == v][:REPLICA_CHECK]
        snap = tsnap.restore_snapshot(pub, step=v, mmap=True, device=dev)
        check_served(torch, np, dev, snap, rows, f"replica version {v}")
        checked[v] = len(rows)
        del snap
    readers = [e for e in exits if e["role"] == "reader"]
    clean = REPLICA_READERS + report.reader_restarts - 1
    upd = [e for e in exits if e["role"] == "updater"]
    if len(readers) != clean or not upd:
        raise AssertionError(f"exit lines: {len(readers)} readers (want "
                             f"{clean}), {len(upd)} updater")
    if any(min(e["launches"].values()) <= 0 for e in readers) or \
            upd[0]["launches"]["relax_sweep"] <= 0:
        raise AssertionError(f"a role skipped a kernel: {exits}")
    out["checked_answers"] = checked
    out["check_s"] = time.perf_counter() - t0
    shutil.rmtree(REPLICA_DIR, ignore_errors=True)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 9: published v0..v{SERVE_BATCHES} == run A's steps byte for "
        f"byte; served answers == COO path == scipy BFS per version "
        f"{checked}; launches per role "
        f"{[(e['role'], e.get('reader'), e['launches']) for e in exits]} "
        f"({out['check_s']:.1f} s of checks); phase {out['wall_s']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    import numpy as np

    from repro_torch import api
    from repro_torch.core import batch as tbat
    from repro_torch.core import engine as teng
    from repro_torch.core import query as tq
    from repro_torch.core.labelling import (INF_KEY2, INF_KEY4,
                                            per_plane_hub_mask)
    from repro_torch.graphs import coo
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.coo import INF_D
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.minplus import kernel as mk

    dev = torch.device(DEVICE)
    memoise_ba()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # --- 1. build ------------------------------------------------------------
    build_s = build.build()
    log(f"build: {build_s:.2f} s for {', '.join(build.SOURCES)} "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # --- 2. kernels against plain versions -----------------------------------
    cases = check_kernels_small(torch, np, dev)
    log(f"phase 2: {cases} kernel cases equal their plain versions (and "
        "the sorted impl equals kernel A on every relax-sweep case)")

    # --- 3. the main path ------------------------------------------------------
    t0 = time.perf_counter()
    edges = gen.barabasi_albert(N, BA_M, seed=0)
    log(f"graph: BA(n={N}, m={BA_M}) {len(edges)} edges, capacity "
        f"{CAPACITY} ({time.perf_counter() - t0:.1f} s to generate)")
    ups = gen.random_batch_updates(edges, N, n_ins=N_INS, n_del=N_DEL,
                                   seed=1)
    rng = np.random.default_rng(2)
    qs = rng.integers(0, N, QUERIES).astype(np.int32)
    qt = rng.integers(0, N, QUERIES).astype(np.int32)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0, lab0 = api.build(N, edges, num_landmarks=LANDMARKS,
                         capacity=CAPACITY, device=dev)
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    log(f"construction: {build_wall:.3f} s, waves {dict(teng.WAVES)}")
    waves_build = dict(teng.WAVES)

    teng.WAVES.clear()
    batch = coo.make_batch(ups, pad_to=N_INS + N_DEL, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g1, lab1, aff1 = api.update(g0, lab0, batch)
    torch.cuda.synchronize()
    update_wall = time.perf_counter() - t0
    waves_update = dict(teng.WAVES)
    log(f"update (BHL+, {N_INS} ins + {N_DEL} del): {update_wall:.3f} s, "
        f"waves {waves_update}, affected {int(aff1.sum())}")

    teng.WAVES.clear()
    mb_ms, answers = [], []
    n_mb = QUERIES // MICROBATCH
    for i in range(n_mb):
        if time.perf_counter() - t_start > QUERY_BUDGET_S:
            log(f"CUT: ran {i} of {n_mb} query microbatches, past "
                f"{QUERY_BUDGET_S:.0f} s")
            break
        sl = slice(i * MICROBATCH, (i + 1) * MICROBATCH)
        t0 = time.perf_counter()
        answers.append(api.query(g1, lab1, qs[sl], qt[sl],
                                 max_steps=MAX_STEPS))
        torch.cuda.synchronize()
        mb_ms.append((time.perf_counter() - t0) * 1e3)
    answers = torch.cat(answers)
    bibfs_waves = teng.WAVES["bibfs"]
    launches = {k: v for k, v in read_launches().items()
                if k in ("relax_sweep", "minplus")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q_sorted = sorted(mb_ms)
    log(f"queries: {len(answers)} in {len(mb_ms)} microbatches of "
        f"{MICROBATCH}; per microbatch ms p50 {statistics.median(mb_ms):.3f} "
        f"p99 {q_sorted[min(len(q_sorted) - 1, int(0.99 * len(q_sorted)))]:.3f}"
        f" max {q_sorted[-1]:.3f}; bibfs waves {bibfs_waves} "
        f"({bibfs_waves / len(mb_ms):.2f} per microbatch)")
    log(f"main path: kernel launches {launches}, peak device memory "
        f"{peak_gb:.2f} GB")

    # --- 4. hold the main path -----------------------------------------------
    lm = lab0.landmarks.cpu().numpy()
    for tag, g, lab in (("build", g0, lab0), ("update", g1, lab1)):
        want = bfs_dist(csr_of(g, np), lm, np, INF_D)
        got = lab.dist.cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"dist after {tag} != scipy BFS "
                                 f"({int((got != want).sum())} entries)")
        if not torch.equal(lab.highway, lab.dist[:, lab.landmarks.long()]):
            raise AssertionError(f"highway after {tag} != dist[:, landmarks]")
    log(f"phase 4a: dist == scipy BFS from all {len(lm)} landmarks after "
        "build and after the update; highway == dist[:, landmarks]")
    k = min(64, len(answers))
    want = bfs_dist(csr_of(g1, np), qs[:k], np, INF_D)[np.arange(k), qt[:k]]
    if not np.array_equal(answers[:k].cpu().numpy(), want):
        raise AssertionError("sampled answers != scipy BFS")
    log(f"phase 4b: {k} sampled answers == scipy BFS")
    g_ref, lab_ref, aff_ref = tbat.batchhl_update(g0, batch, lab0,
                                                  improved=True, plan=None)
    for name, a, b in (("src", g_ref.src, g1.src), ("dst", g_ref.dst, g1.dst),
                       ("valid", g_ref.valid, g1.valid), ("w", g_ref.w, g1.w),
                       ("dist", lab_ref.dist, lab1.dist),
                       ("hub", lab_ref.hub, lab1.hub),
                       ("highway", lab_ref.highway, lab1.highway),
                       ("aff", aff_ref, aff1)):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel path != COO reference on {name}")
    del g_ref, lab_ref, aff_ref
    ans_ref = tq.batched_query(
        g1, lab1, torch.from_numpy(qs[:MICROBATCH]).to(dev),
        torch.from_numpy(qt[:MICROBATCH]).to(dev), max_steps=MAX_STEPS,
        use_kernel=False, plan=None)
    if not torch.equal(ans_ref, answers[:MICROBATCH]):
        raise AssertionError("kernel path answers != COO reference")
    log("phase 4c: update (slots, labelling, aff) and one microbatch of "
        "answers equal the COO reference (plan=None) on the card")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    log(f"phase 4d: launches on the main path {launches}")

    # --- 3b. the same tick in the frontier mode ------------------------------
    trickle = coo.make_batch(gen.random_batch_updates(
        edges, N, n_ins=TRICKLE, n_del=TRICKLE, seed=3), pad_to=2 * TRICKLE,
        device=dev)
    frontier, fr_engine = run_frontier_update(torch, dev, g0, lab0, batch,
                                              (g1, lab1, aff1), trickle)

    # --- 5. timings at the main path's shapes -----------------------------------
    eng = teng.RelaxEngine(block_v=api.BLOCK_V, block_e=api.BLOCK_E,
                           device=dev)
    t0 = time.perf_counter()
    bg = eng.prepare(g1).tiles
    prep_s = time.perf_counter() - t0
    s_, nr, be = bg.src_t.shape
    unchunked = -(-N // api.BLOCK_V) * int(
        torch.bincount(g1.dst[g1.valid].long() // api.BLOCK_V).max())
    log(f"tiling: block_v={api.BLOCK_V} block_e={api.BLOCK_E}: {nr} rows, "
        f"{bg.slots} tile slots (one row per block would give {unchunked});"
        f" host prepare {prep_s:.3f} s")
    e2 = g1.src.shape[0]
    live = int(g1.valid.sum())
    hub_mask = per_plane_hub_mask(lab1.landmarks, lab1.landmarks, N)
    key2 = lab1.key2()
    # A BiBFS plane after two waves from 32 query sources.
    ds = torch.full((MICROBATCH, N), INF_D, dtype=torch.int32, device=dev)
    ds[torch.arange(MICROBATCH, device=dev),
       torch.from_numpy(qs[:MICROBATCH]).long().to(dev)] = 0
    for _ in range(2):
        ds = torch.minimum(ds, teng.relax_sweep(
            teng.RelaxPlan(bg), g1, ds, 1, INF_D))
    # The repair's per-plane masks on the update's affected sets.
    src_aff = aff1[:, g1.src.long()]
    dst_aff = aff1[:, g1.dst.long()]
    bou_mask = g1.valid & ~src_aff & dst_aff
    int_mask = g1.valid & src_aff & dst_aff
    del src_aff, dst_aff
    waves = [("bibfs (1, INF_D, 0)", ds, None, g1.valid, 1, INF_D, 0),
             ("search basic (1, INF_D, 0)", lab1.dist, None, g1.valid, 1,
              INF_D, 0),
             ("construct/repair (2, INF_KEY2, 1)", key2, hub_mask, g1.valid,
              2, INF_KEY2, 1),
             ("search improved (4, INF_KEY4, 2)", 2 * key2 + 1, hub_mask,
              g1.valid, 4, INF_KEY4, 2),
             ("repair base, per-plane bou_mask (2, INF_KEY2, 1)", key2,
              hub_mask, bou_mask, 2, INF_KEY2, 1),
             ("repair interior, per-plane int_mask (2, INF_KEY2, 1)", key2,
              hub_mask, int_mask, 2, INF_KEY2, 1)]
    live_slot = bg.slot_t.reshape(-1) != 0
    live_slots = int(live_slot.sum())
    perm_live = bg.perm_t.reshape(-1)[live_slot].long()
    del live_slot
    sweep_rows = []
    for name, keys, hub, mask, step, inf, clear in waves:
        keys = keys.contiguous()
        args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
                bg.rowblk_t, mask, g1.w, step, inf, clear, N,
                bg.block_v, bg.nb)
        got = rk.relax_sweep(*args)
        want = rk.relax_sweep_plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"relax_sweep != plain at full size: {name}")
        ms, plain = paired_ms(lambda: rk.relax_sweep(*args),
                              lambda: rk.relax_sweep_plain(*args), 10, 3)
        parts = sweep_split(torch, lambda: rk.relax_sweep(*args),
                            mask.dim() == 2)
        p = keys.shape[0]
        # The mask at each live tile slot's edge; the (plane, slot) pairs
        # it lets through, and the slots some plane lets through.
        m_live = mask[..., perm_live]
        plane_edges = int(m_live.sum()) * (p if mask.dim() == 1 else 1)
        used = int((m_live if mask.dim() == 1 else m_live.any(0)).sum())
        del m_live
        # Needed bytes: keys in and out, hub and rowblk once each; the four
        # index streams of each live tile slot and only slot_t of each
        # padding slot; the mask of each live slot's edge and w of each
        # edge a plane lets through.
        keys_hub = (p * N * 4 * 2 + (p * N if hub is not None else 0)
                    + bg.rowblk_t.numel() * 4)
        nbytes = (keys_hub + live_slots * 16 + (bg.slots - live_slots) * 4
                  + live_slots * (p if mask.dim() == 2 else 1) + used * 4)
        ops = 4 * plane_edges   # add, saturate, hub clear, min per pair
        bms, by = bound_ms(nbytes, ops)
        # Every padded tile slot's indices, and w and mask of every slot.
        padded_bytes = keys_hub + bg.slots * 16 + mask.numel() + e2 * 4
        padded_ms, _ = bound_ms(padded_bytes, ops)
        sweep_rows.append(dict(wave=name, ms=ms, plain_ms=plain, bound_ms=bms,
                               bound_by=by, bytes=nbytes,
                               padded_bound_ms=padded_ms,
                               padded_bytes=padded_bytes,
                               max_abs_err=err, planes=p,
                               live_plane_edges=plane_edges,
                               device_ms=parts))
        log(f"relax_sweep {name}: [{p}, {N}] keys, {bg.slots} slots "
            f"({live_slots} live): kernel {ms:.3f} ms, plain {plain:.3f} ms,"
            f" bound {bms:.4f} ms ({by}, {nbytes} needed bytes), padded-tile "
            f"bound {padded_ms:.4f} ms ({padded_bytes} bytes), max_abs_err "
            f"{err}; device ms of one call {parts}")
    del bou_mask, int_mask, perm_live

    # One query microbatch under the profiler: how busy the card is, and
    # what its plan-cache hit (the default engine's prepare of g1) costs.
    q_prof = profile_query(torch, api, g1, lab1, qs[:MICROBATCH],
                           qt[:MICROBATCH])
    q_prof["prepare_hit"] = profile_prepare_hit(
        torch, api.default_engine(g1.device), g1)

    # The launch floor: a one-element fill, profiled as the kernels are.
    one = torch.empty(1, dtype=torch.int32, device=dev)
    one.fill_(0)
    floor_us = profiled_us(torch, lambda: one.fill_(0), "")
    mp_rows = []
    lab_eff = tq.effective_labels(lab1)
    for b in (1024, 32):
        s = lab_eff[:, torch.from_numpy(qs[:b]).long().to(dev)].T \
            .clamp_max(INF_D).contiguous()
        t = lab_eff[:, torch.from_numpy(qt[:b]).long().to(dev)].T \
            .clamp_max(INF_D).contiguous()
        h = lab1.highway.contiguous()
        got = mk.minplus(s, h, t)
        want = mk.minplus_plain(s, h, t)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"minplus != plain at B={b}")
        ms, plain = paired_ms(lambda: mk.minplus(s, h, t),
                              lambda: mk.minplus_plain(s, h, t), 50, 20)
        kernel_us = profiled_us(torch, lambda: mk.minplus(s, h, t),
                                "minplus_kernel")
        plain_us = profiled_us(torch, lambda: mk.minplus_plain(s, h, t), "")
        r = h.shape[0]
        bms, by = bound_ms((b * r * 2 + r * r + b) * 4, 2 * b * r * r)
        mp_rows.append(dict(batch=b, ms=ms, plain_ms=plain, bound_ms=bms,
                            bound_by=by, max_abs_err=err,
                            kernel_device_us=kernel_us,
                            plain_device_us=plain_us,
                            launch_floor_us=floor_us))
        log(f"minplus B={b} R={r}: kernel {ms:.4f} ms per call (events), "
            f"{kernel_us:.2f} us on the device (profiler; launch floor "
            f"{floor_us:.2f} us), plain {plain:.4f} ms ({plain_us:.2f} "
            f"device us), bound {bms:.6f} ms ({by}), max_abs_err {err}")

    er_row = time_edge_relax(torch, dev, g1, lab1)
    bag_rows = time_embed_bag(torch, dev)

    # --- 6. the serving loop at full width ------------------------------------
    serve, serve_base, final_a = run_serve(
        torch, np, dev, g0, lab0, batch, (g1, lab1, aff1), trickle, fr_engine)

    # --- 7. directed BatchHL at full width -----------------------------------
    del g1, lab1, aff1, fr_engine, trickle, lab_eff, key2, hub_mask, ds
    directed = run_directed(torch, np, dev, edges)

    # --- 8. the autotuner at full width ---------------------------------------
    autotune = run_autotune(torch, dev, serve_base, final_a)
    del final_a

    # --- 9. the replica tier at full width --------------------------------------
    try:
        replica_tier = run_replica(torch, np, dev, serve_base)
    except BaseException:
        dump_role_logs(REPLICA_DIR / "logs")
        raise

    # --- 10. the kernels line and the summary -------------------------------------
    key2_row = sweep_rows[2]
    kernels = [
        dict(name="relax_sweep", route="cuda",
             source="src/repro_torch/csrc/relax_sweep.cu",
             replaces="src/repro/kernels/edge_relax/kernel.py:68",
             launches=serve["pipeline"]["launches"]["relax_sweep"],
             max_abs_err=max(r["max_abs_err"] for r in sweep_rows),
             ms=key2_row["ms"], plain_ms=key2_row["plain_ms"],
             bound_ms=key2_row["bound_ms"], bound_by=key2_row["bound_by"],
             library_ms=None),
        dict(name="minplus", route="cuda",
             source="src/repro_torch/csrc/minplus.cu",
             replaces="src/repro/kernels/minplus/kernel.py:37",
             launches=serve["pipeline"]["launches"]["minplus"],
             max_abs_err=max(r["max_abs_err"] for r in mp_rows),
             ms=mp_rows[1]["ms"], plain_ms=mp_rows[1]["plain_ms"],
             bound_ms=mp_rows[1]["bound_ms"], bound_by=mp_rows[1]["bound_by"],
             library_ms=None),
        dict(name="edge_relax", route="cuda",
             source="src/repro_torch/csrc/edge_relax.cu",
             replaces="src/repro/kernels/edge_relax/kernel.py:52",
             launches=er_row["launches"], max_abs_err=er_row["max_abs_err"],
             ms=er_row["ms"], plain_ms=er_row["plain_ms"],
             bound_ms=er_row["bound_ms"], bound_by=er_row["bound_by"],
             library_ms=None),
        dict(name="embed_bag", route="cuda",
             source="src/repro_torch/csrc/embed_bag.cu",
             replaces="src/repro/kernels/embed_bag/kernel.py:29",
             launches=bag_rows[-1]["launches"],
             max_abs_err=max(r["max_abs_err"] for r in bag_rows),
             ms=bag_rows[-1]["ms"], plain_ms=bag_rows[-1]["plain_ms"],
             bound_ms=bag_rows[-1]["bound_ms"],
             bound_by=bag_rows[-1]["bound_by"],
             library_ms=bag_rows[-1]["library_ms"]),
    ]
    summary = dict(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   kernel_cases=cases, edges=int(len(edges)),
                   construction_s=build_wall, construction_waves=waves_build,
                   update_s=update_wall, update_waves=waves_update,
                   query_microbatches=len(mb_ms), query_mb_ms=mb_ms,
                   bibfs_waves=bibfs_waves, peak_gb=peak_gb,
                   tile_rows=nr, tile_slots=bg.slots,
                   unchunked_slots=unchunked, prepare_s=prep_s,
                   relax_sweep=sweep_rows, query_profile=q_prof,
                   minplus=mp_rows,
                   frontier=frontier, edge_relax=er_row, embed_bag=bag_rows,
                   serve=serve, directed=directed, autotune=autotune,
                   replica=replica_tier,
                   profiler_short_passes=short_passes,
                   total_s=time.perf_counter() - t_start)
    log(f"total: {summary['total_s']:.1f} s")
    log("summary: " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
