#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit), torch and CUDA versions, and
   builds both CUDA kernels from `src/repro_torch/csrc/` with nvcc.
2. Holds each kernel to its plain PyTorch version on the card
   (`torch.equal`; every output is an integer, so no tolerance), over the
   relax sweep's edge cases and the min-plus shapes.
3. Drives the port's main path through `repro_torch.api` at full size:
   Barabási–Albert(2^20, m=4, seed 0), capacity 2^23 edges, 32 landmarks;
   build; one mixed BHL⁺ tick of 512 inserts + 512 deletes; 1024 uniform
   queries in microbatches of 32 with max_steps 64. Kernel launch counts
   are set to 0 just before and read just after.
4. Checks that run: landmark distances after build and after the update
   against scipy BFS, 64 answers against scipy BFS, the update and one
   microbatch rerun on the COO reference (plan=None) equal the kernel
   path, and both kernels were launched in phase 3.
5. Times each kernel at the main path's shapes with CUDA events, in turns
   with its plain version, beside its bound (bytes over 3.35 TB/s, or
   operations over 67 T/s, whichever is larger).
6. Prints a `summary:` line with every number above as JSON, the
   `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Exits nonzero, printing no result, without a CUDA device or if any phase
fails. Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 20
BA_M = 4
CAPACITY = 1 << 23
LANDMARKS = 32
N_INS = N_DEL = 512
QUERIES = 1024
MICROBATCH = 32
MAX_STEPS = 64
QUERY_BUDGET_S = 480.0   # past this many seconds, fewer query microbatches
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 2: each kernel against its plain version -------------------------

def check_kernels_small(torch, np, dev) -> int:
    from repro_torch.core.labelling import INF_KEY2, INF_KEY4
    from repro_torch.graphs.coo import INF_D
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops
    from repro_torch.kernels.minplus import kernel as mk

    params = [(1, INF_D, 0), (2, INF_KEY2, 1), (4, INF_KEY4, 2)]
    cases = 0

    def sweep_case(bg, keys, hub, mask, w, step, inf, clear, what):
        nonlocal cases
        args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
                bg.rowblk_t, mask, w, step, inf, clear, bg.n, bg.block_v,
                bg.nb)
        got = rk.relax_sweep(*args)
        torch.cuda.synchronize()
        want = rk.relax_sweep_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"relax_sweep != plain: {what} "
                                 f"({bad} entries differ)")
        cases += 1

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.default_rng(0)
    n, m, planes = 61, 240, 3
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = rng.random(m) < 0.8
    masks = keep & (rng.random((planes, m)) < 0.85)
    w = t(rng.integers(1, 9, m).astype(np.int32))
    hub = t(rng.random((planes, n)) < 0.3)
    for be, shards in ((None, 1), (7, 2)):
        bg = rops.prepare_topology(src, dst, keep, n, 16, shards, be,
                                   device=dev)
        assert bg.chunked == (be is not None)
        for step, inf, clear in params:
            keys = t(rng.integers(0, inf, (planes, n), endpoint=True)
                     .astype(np.int32))
            for h in (None, hub):
                for msk in (t(masks[0]), t(masks)):
                    sweep_case(bg, keys, h, msk, w, step, inf, clear,
                               f"step={step} block_e={be} hub="
                               f"{h is not None} mask={tuple(msk.shape)}")
        sweep_case(bg, keys, hub, t(np.zeros(m, bool)), w, 4, INF_KEY4, 2,
                   "empty mask")

    # The short last shard: n=24, block_v=8, shards=2, block_e=4.
    n = 24
    dst = np.array([1, 9, 16, 17, 18, 19, 20, 21, 2, 10], np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    ones = np.ones(len(dst), bool)
    bg = rops.prepare_topology(src, dst, ones, n, 8, 2, 4, device=dev)
    assert bg.chunked and bg.src_t.shape[1] == bg.nb
    sweep_case(bg, t(rng.integers(0, 2 * n, (2, n)).astype(np.int32)), None,
               t(ones), t(ones.astype(np.int32)), 1, 1 << 29, 0,
               "short last shard")

    # Near-INF weights: keys step·INF_D + step − 1 through w = INF_D.
    n = 6
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 2, 3, 4], np.int32)
    ones = np.ones(4, bool)
    bg = rops.prepare_topology(src, dst, ones, n, 4, 1, None, device=dev)
    hub_n = t(np.array([[False, True, False, True, False, False]]))
    for step, inf, clear in params:
        keys = t(np.full((1, n), step * INF_D + step - 1, np.int32))
        sweep_case(bg, keys, hub_n, t(ones), t(np.full(4, INF_D, np.int32)),
                   step, inf, clear, f"near-INF step={step}")

    # Min-plus: B in {1, 32, 1024} at R = 32, and a rectangular [8, 32] H.
    for b, p, r in ((1, 32, 32), (32, 32, 32), (1024, 32, 32),
                    (256, 8, 32)):
        def draw(shape):
            x = rng.integers(0, 64, shape).astype(np.int32)
            x[rng.random(shape) < 0.2] = 1 << 29
            return t(x)
        s, h, tt = draw((b, p)), draw((p, r)), draw((b, r))
        got = mk.minplus(s, h, tt)
        torch.cuda.synchronize()
        if not torch.equal(got, mk.minplus_plain(s, h, tt)):
            raise AssertionError(f"minplus != plain at B={b} P={p} R={r}")
        cases += 1
    return cases


# --- phase 4 helpers: the scipy oracle --------------------------------------

def csr_of(g, np):
    import scipy.sparse as sp
    valid = g.valid.cpu().numpy()
    src = g.src.cpu().numpy()[valid]
    dst = g.dst.cpu().numpy()[valid]
    return sp.csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                         shape=(g.n, g.n))


def bfs_dist(csr, sources, np, inf_d):
    from scipy.sparse.csgraph import shortest_path
    d = shortest_path(csr, method="D", unweighted=True, directed=True,
                      indices=np.asarray(sources))
    return np.where(np.isinf(d), inf_d, d).astype(np.int64)


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
    log(f"phase 2: {cases} kernel cases equal their plain versions")

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
    rk.launches = 0
    mk.launches = 0
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
    launches = {"relax_sweep": rk.launches, "minplus": mk.launches}
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
    waves = [("bibfs (1, INF_D, 0)", ds, None, 1, INF_D, 0),
             ("search basic (1, INF_D, 0)", lab1.dist, None, 1, INF_D, 0),
             ("construct/repair (2, INF_KEY2, 1)", key2, hub_mask, 2,
              INF_KEY2, 1),
             ("search improved (4, INF_KEY4, 2)", 2 * key2 + 1, hub_mask, 4,
              INF_KEY4, 2)]
    sweep_rows = []
    for name, keys, hub, step, inf, clear in waves:
        keys = keys.contiguous()
        args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
                bg.rowblk_t, g1.valid, g1.w, step, inf, clear, N,
                bg.block_v, bg.nb)
        got = rk.relax_sweep(*args)
        want = rk.relax_sweep_plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"relax_sweep != plain at full size: {name}")
        ms, plain = paired_ms(lambda: rk.relax_sweep(*args),
                              lambda: rk.relax_sweep_plain(*args), 10, 3)
        p = keys.shape[0]
        nbytes = (p * N * 4 * 2 + (p * N if hub is not None else 0)
                  + bg.slots * 4 * 4 + bg.rowblk_t.numel() * 4 + e2 + e2 * 4)
        ops = 4 * p * live  # add, saturate, hub clear, min per live slot
        bms, by = bound_ms(nbytes, ops)
        sweep_rows.append(dict(wave=name, ms=ms, plain_ms=plain, bound_ms=bms,
                               bound_by=by, max_abs_err=err,
                               planes=p, bytes=nbytes))
        log(f"relax_sweep {name}: [{p}, {N}] keys, {bg.slots} slots: kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"max_abs_err {err}")

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
        r = h.shape[0]
        bms, by = bound_ms((b * r * 2 + r * r + b) * 4, 2 * b * r * r)
        mp_rows.append(dict(batch=b, ms=ms, plain_ms=plain, bound_ms=bms,
                            bound_by=by, max_abs_err=err))
        log(f"minplus B={b} R={r}: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
            f" bound {bms:.6f} ms ({by}), max_abs_err {err}")

    # --- 6. the kernels line and the summary --------------------------------------
    key2_row = sweep_rows[2]
    kernels = [
        dict(name="relax_sweep", route="cuda",
             source="src/repro_torch/csrc/relax_sweep.cu",
             replaces="src/repro/kernels/edge_relax/kernel.py:68",
             launches=launches["relax_sweep"],
             max_abs_err=max(r["max_abs_err"] for r in sweep_rows),
             ms=key2_row["ms"], plain_ms=key2_row["plain_ms"],
             bound_ms=key2_row["bound_ms"], bound_by=key2_row["bound_by"],
             library_ms=None),
        dict(name="minplus", route="cuda",
             source="src/repro_torch/csrc/minplus.cu",
             replaces="src/repro/kernels/minplus/kernel.py:37",
             launches=launches["minplus"],
             max_abs_err=max(r["max_abs_err"] for r in mp_rows),
             ms=mp_rows[1]["ms"], plain_ms=mp_rows[1]["plain_ms"],
             bound_ms=mp_rows[1]["bound_ms"], bound_by=mp_rows[1]["bound_by"],
             library_ms=None),
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
                   relax_sweep=sweep_rows, minplus=mp_rows,
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
