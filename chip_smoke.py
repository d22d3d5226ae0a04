#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit), torch and CUDA versions, and
   builds every CUDA kernel in `build.SOURCES` (relax sweep, min-plus,
   legacy edge relax, embedding bag, seed match) from
   `src/repro_torch/csrc/` with nvcc, one process each, all at once.
2. Holds each kernel to its plain PyTorch version on the card: the three
   integer kernels with `torch.equal`, the embedding bag to rtol = atol =
   1e-5 (float32 sums in another order), over each kernel's edge cases
   (for the relax sweep every case of `tests/_sweep_cases.py`, where the
   autotuner's `sorted` impl is held equal to the kernel as well, and
   `ops.relax_sweep` in the reference's call form, keys and hub one
   plane [V] and `w=None`, one launch a call, on three of them; for
   min-plus and the legacy edge relax every case of
   `tests/_kernel_cases.py`, as `tests/test_torch_cuda.py` runs them; for
   the embedding bag D in {1, 8, 64, 100} × L in {1, 7, 50}, B = 1 and 512
   at L = 50, D = 64 (bags split over warps), two calls bit-equal, and
   wrapped and NaN indices). Every call of kernels A and C launches once,
   their wide modes (block_v past the shared-memory tile) among them: A
   on the `wide-*` sweep cases, C at block_v 58,113 and 131,072.
3. Drives the port's main path through `repro_torch.api` at full size:
   Barabási–Albert(2^20, m=4, seed 0), capacity 2^23 edges, 32 landmarks;
   build; one mixed BHL⁺ tick of 512 inserts + 512 deletes; 1024 uniform
   queries in microbatches of 32 with max_steps 64. Kernel launch counts
   are set to 0 just before and read just after.
4. Checks that run: landmark distances after build and after the update
   against scipy BFS, 64 answers against scipy BFS, the update and one
   microbatch rerun on the COO reference (plan=None) equal the kernel
   path, and both kernels were launched in phase 3. Then phase 3's
   update again through `RelaxEngine(block_v=2^20, block_e=4096)`, one
   destination block (kernel A's wide mode), held bit for bit to phase
   3's update, its launch count set to 0 just before and read after.
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
   `torch.nn.functional.embedding_bag` as the library yardstick, with its
   own device microseconds under the profiler beside the launch floor
   and the launch geometry `embed_bag_geometry` chose; the seed weights'
   slot match (`kernels/seed_match`) at the update cells' slot counts,
   2^24 and 2^25, with U = 1,024 row keys of live slots, equal to its
   plain version, one launch a call, beside its needed-bytes bound (src
   and dst of every slot, valid and w of the matched ones) and the bound
   of 13 bytes a slot (src, dst, w, valid of every slot). Each of
   those two entry points is its kernel's path: its count is set to 0
   just before the call and read just after. Every profiler pass must
   record each hand-written kernel as often as its wrapper launched it
   (and kernel A's transpose, fill and pack once per launch); a pass that
   lost records is logged and run again, and three such passes in a row
   fail the phase. The wide modes: kernel A's key2 wave at block_v
   28,033, 65,536 and 2^20 (block_e 4096; the tiled 512 is the row
   above) and kernel C at block_v 58,113 and 2^20, each by CUDA events
   in turns with its plain version, beside its needed-bytes bound, equal
   to its plain version and to the block_v 512 result.
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
10. The sharded path (`core/shard.py`) at phase 3's width, on meshes of
   the one card (a device repeats in the grid, so the shards run one
   after another): (data, model) = (1, 1), (1, 4), (2, 2), (4, 1). Each
   mesh's `shard_build_labelling` and `shard_batchhl_update` (phase 3's
   plans of G and G', tiled once) equal phase 3's labelling, update and
   aff; `affected_vertices` equals aff.any(0); `shard_batched_query` on
   phase 3's queries in microbatches of 32 equals phase 3's answers (and
   so scipy BFS on the 64 of phase 4b). Then `pipelined_update` on the
   (2, 2) mesh, full sweep, fused and frontier, held to phase 3's update
   with the host syncs of every step; then `ServeLoop` on the (2, 2) mesh,
   2 ticks of run A's configuration in pipeline mode, whose versions 1
   and 2 equal run A's steps on disk and whose served answers equal the
   COO path and scipy BFS. The serve loop's mesh is built by hand,
   `Mesh([["cuda"] * 2] * 2)`, naming the card without an index. Build,
   update and query-microbatch p50 per mesh beside the unsharded path's
   with the same plans, kernel A's and B's launches per mesh, peak device
   memory and the phase's wall time.
11. MIND and the training substrate (`models/mind.py`, `train/`), run
   right after phase 2 while the card is empty. At a medium size (65,536
   items, the full config's widths, B = 1,024, 25 % of the history
   masked; params from a seeded CPU generator, copied to the card) the
   card against the CPU: the loss (rtol 1e-5), the three gradients (atol
   1e-6), one `adamw_update` on the same inputs with and without int8
   error feedback (rtol 1e-6, atol 1e-7; the int8 codes equal) and 4
   train steps each way (losses rtol 1e-5, params atol 2e-5). At full
   width (`configs/mind.py:model_config`, 10,485,760 × 64 float32,
   `train_batch` B = 65,536 from `materialize`): init statistics, 8
   steps of `make_generic_train_step` at lr 3e-3 (finite, the last loss
   below the first), then 2 with `int8_ef`: step ms (CUDA events, median
   of steps 2–8), forward + backward ms against the optimiser's ms and
   its bytes bound, host syncs of step 8 (must be 0), peak device
   memory. Then `serve_p99`, `serve_bulk` and `retrieval_cand` on the
   trained params under `torch.no_grad()`: p50 and p99 over 20 calls,
   users or candidates per second, peak memory, and 8 sampled users' (or
   the one retrieval user's) scores against a float64 recomputation on
   the CPU (rtol 1e-4, atol 1e-5). The kernels' launch counts are set
   to 0 before the phase and must read 0 after it: MIND gathers with
   `jnp.take`'s rule and launches no hand-written kernel.
12. The GNN family (`models/gnn.py`) and the neighbour sampler
   (`graphs/sampler.py`). a/b run right after phase 11, while the card is
   empty: b first, each arch (`configs/{schnet,dimenet,mace,
   graphcast}.py:model_config`) at full width on the `molecule` batch of
   the reference's `gnn_cell` with params from a seeded CPU generator
   copied to the card, the card against the CPU: forward, loss and every
   gradient within 1e-4 of the tensor's largest |value| (GraphCast's
   gradients within 1e-3: float32 rounding through its 16 layers), each
   device's gradients against a float64 recomputation on the card within
   the same limits, and MACE's outputs under a seeded QR rotation of the
   positions within 1e-4; then a, for each arch on `minibatch_lg` (169,984
   nodes, 337,920 directed edges, d_in 602) and `molecule` (4,096 / 16,384
   / 16, 128 graphs), drawn by `materialize(gnn_layout(...), seed 0)`: init
   statistics, 8 steps of `make_generic_train_step` at lr 1e-3 (finite,
   the last loss below the first; for GraphCast, whose loss at full width
   need not fall at this rate in the reference either, instead the losses
   of the same steps from the same params on the CPU within 1e-2: all 8
   on `molecule`, the first 2 on `minibatch_lg`), step ms (CUDA events,
   median of steps 2–8), forward + backward ms against the optimiser's ms
   and its bytes bound, host syncs of step 8 (must be 0), peak device
   memory. c runs after phase 4, on phase 3's graph: `build_csr` of
   BA(2^20, 4) (seconds), `sample_subgraph` from 1,024 seeds with fanouts
   (15, 10), which gives `minibatch_lg`'s 169,984 nodes and 168,960 sampled
   edges, uniform and biased by closeness to the landmarks (−min over
   landmarks of phase 3's post-update `lab.dist`): every masked-in
   neighbour an edge of the CSR, the shapes static, the masks right, ms per
   call, host syncs, and the biased samples' mean landmark distance no
   larger than the uniform ones'. The kernels' launch counts are set to 0
   before a/b and before c and must read 0 after each: no GNN module or
   sampler launches a hand-written kernel.
13. The transformer LMs (`models/transformer.py`, `models/moe.py`,
   `train/serve_step.py`, `make_lm_train_step`), right after phase
   12a/b while the card is empty, one model at a time, each freed before
   the next; params from a seeded generator on the card. a: each arch's
   reduced config in float32, the card against the CPU (forward, loss,
   every gradient, 4 decode steps, 2 train steps, microbatched for
   minitron-4b); its full-width config cut to 2 layers (DeepSeek: 1
   dense + 1 MoE) on tokens [2, 64], forward, `chunked_loss` and every
   gradient in bfloat16 against a float32 recomputation of the same
   params on the card (relative L2 errors within `LM_BF16_TOL`); at full
   depth (Mixtral: 8 of 56 layers, `LM_DEPTH`) teacher-forced
   `decode_step` over 16 tokens against `forward` (`LM_FORCED_TOL`),
   greedy `generate` run twice (equal) and against forward's argmax (at
   least 0.75 agreeing, the reference test's bound). b: prefill_32k
   (one sequence of 32,768 tokens), decode_32k (cache at max_len 33,280
   from a seeded normal draw at cache_len 32,768, a warm-up step and 16
   greedy steps, the batch the largest power of two whose weights and
   cache fit in 68 GB), and DeepSeek at long_500k (max_len 524,800, 4
   steps): ms per step (CUDA events, p50 and p99 of the warmed steps),
   tokens/s, the bytes a step needs over 3.35 TB/s (`decode_bytes`),
   host syncs of a step, peak memory. c: 6 steps of
   `make_lm_train_step` on the full minitron-4b at train_4k's sequence
   4096 and batch 2: losses finite, step ms (median of steps 2–6),
   forward + backward against the optimiser and its bytes bound, MFU
   against 989.4 TFLOP/s (6·N·tokens, and `lm_train_flops`), host syncs
   of step 6 (must be 0), peak memory.
   The kernels' launch counts are set to 0 before the phase and must
   read 0 after it: the reference's LMs reach no Pallas kernel.
14. The BatchHL cells (`configs/batchhl.py`), right after phase 4, on
   phase 3's graph (their `model_config` is phase 3's width): each built
   by `configs.common.build_cell("batchhl", shape, pod=False)` and its
   `step_fn` called on phase 3's tensors. `construct` equals phase 3's
   labelling bit for bit (max_iters 64 must not bind); `update_1k` (phase
   3's batch) equals phase 3's update and its `aff.sum()`; `update_10k`
   (5,120 + 5,120 rows by seed) equals the COO path (plan=None) on the
   card and scipy BFS from every landmark; `query_1k` and `query_1k_repl`
   answer phase 3's 1024 queries in one call at max_steps 16 (kernel A
   on [1024, 2^20] keys): equal to each other, never below phase 3's
   answers, and equal to them unless all 16 waves ran. Launch counts are
   set to 0 before each cell and read after it: A in all five, B in both
   queries. Seconds and peak memory per cell. Then the dry run
   (`launch/dryrun.py`): its bytes pass over every cell of the 10 archs
   and batchhl on both production meshes (90 records, 0 failures), and
   its FLOPs pass on meta tensors for one cell per family.
15. Prints a `summary:` line with every number above as JSON (each
   phase's wall seconds under `phase_s`, also logged as each phase
   ends), the `{"kernels": [...]}` line (kernel A's, B's and the seed
   match's launches are run A's), the card line, and last `{"ok": true,
   "device": {...}}`.

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
# Phase 11's train steps peak at ≈ 64–66 GB in blocks of 17.18 GB ([B, B]
# float32 at B = 65,536) and 2.68 GB (the table). With fixed segments the
# caching allocator splits freed 17 GB blocks for table-sized tensors and
# then cannot place the next [B, B] block (22 GiB cached but unusable in
# one run); segments that grow in place avoid that. It must be set before
# CUDA's first allocation, so it holds for every phase and the processes
# they start. A value already in the environment is kept.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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
# The update cells' slot counts (perfbench's `ba20`, capacity 2^23 edges;
# `kron20`, 2^24) and rows a batch, for the seed match's timing.
SEED_MATCH_SLOTS = (1 << 24, 1 << 25)
SEED_MATCH_ROWS = 1024
BAG_TOL = 1e-5
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Wall seconds of each phase, from the end of the one before."""

    def __init__(self) -> None:
        self.t = time.perf_counter()
        self.s: dict = {}

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        self.s[phase] = now - self.t
        self.t = now
        log(f"phase {phase} wall: {self.s[phase]:.1f} s")


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
    from repro_torch.kernels.seed_match import kernel as sk
    rk.launches = rk.launches_edge_relax = mk.launches = ek.launches = 0
    sk.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.embed_bag import kernel as ek
    from repro_torch.kernels.minplus import kernel as mk
    from repro_torch.kernels.seed_match import kernel as sk
    return {"relax_sweep": rk.launches, "minplus": mk.launches,
            "edge_relax": rk.launches_edge_relax, "embed_bag": ek.launches,
            "seed_match": sk.launches}


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: The device name of each hand-written kernel that the profiler passes
#: check, and its wrapper's count in `read_launches`.
COUNTED = {"relax_sweep_kernel": "relax_sweep", "minplus_kernel": "minplus",
           "edge_relax_kernel": "edge_relax",
           "embed_bag_kernel": "embed_bag", "seed_match_kernel": "seed_match"}
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
    """Kernel A's device ms by its kernels (transpose, pack, fill, sweep;
    the wide mode's fill is `fill_inf_kernel`, its hub pack one more
    `pack_mask_kernel`)."""
    out = {}
    for part in ("transpose_kernel", "pack_mask_kernel",
                 "fill_chunked_kernel", "fill_inf_kernel",
                 "relax_sweep_kernel"):
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

    cases = wide = 0
    for name in sweep_cases.names():
        for c in sweep_cases.make(name):
            args = sweep_cases.sweep_args(c, dev)
            before = rk.launches
            got = rk.relax_sweep(*args)
            torch.cuda.synchronize()
            if rk.launches != before + 1:
                raise AssertionError(f"relax_sweep launched "
                                     f"{rk.launches - before} kernels: "
                                     f"{name} {c.label}")
            want = rk.relax_sweep_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"relax_sweep != plain: {name} "
                                     f"{c.label} ({bad} entries differ)")
            # The autotuner's sorted impl on the same sweep.
            sg = rops.prepare_sorted(c.src, c.dst, c.keep, c.n, device=dev)
            srt = rops.relax_sweep_sorted(args[0], sg, args[7], c.step, c.inf,
                                          clear_bit=c.clear, hub=args[1],
                                          w=args[8])
            torch.cuda.synchronize()
            if not torch.equal(srt, got):
                raise AssertionError(f"sorted impl != relax_sweep: {name} "
                                     f"{c.label}")
            cases += 1
            wide += rk.sweep_mode(c.block_v) == "wide"
    if wide == 0:
        raise AssertionError("no sweep case ran kernel A's wide mode")
    log(f"phase 2: kernel A's wide mode (block_v > {rk.SWEEP_MAX_BLOCK_V}) "
        f"on {wide} sweeps of the wide-* cases, each one launch and equal "
        f"to the plain version")
    cases += check_reference_form(torch, np, dev)

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


#: Sweep cases that phase 2 also runs through `ops.relax_sweep` in the
#: reference's call form: chunked rows over two shards with a hub, one
#: plane at block_v 512, and keys that saturate.
REFERENCE_FORM_CASES = ("rows-be7-s2-p3", "planes1-bv512", "near-inf")


def check_reference_form(torch, np, dev) -> int:
    """Kernel A through `ops.relax_sweep` in the reference's call forms,
    positional: `(keys, bg, mask, 1, INF32)` and `(keys, bg, mask, 2,
    INF32, 1, hub)`, with keys and hub one plane [V] and `w=None`. Each
    call launches kernel A once (its count read back as 1) and returns
    [V], equal bit for bit to the plain version on the CPU."""
    import _sweep_cases as sweep_cases
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops
    checked = 0
    for name in REFERENCE_FORM_CASES:
        c = sweep_cases.make(name)[0]
        mask = c.mask if c.mask.ndim == 1 else c.mask[0]
        hub = c.hub[0] if c.hub is not None else np.arange(c.n) % 3 == 0
        tiles = {d: rops.prepare_topology(c.src, c.dst, c.keep, c.n,
                                          c.block_v, c.shards, c.block_e,
                                          device=d) for d in (dev, "cpu")}

        def call(d, form):
            def t(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(d)
            extra = (t(hub),) if len(form) == 3 else ()
            return rops.relax_sweep(t(c.keys[0]), tiles[d], t(mask), *form,
                                    *extra)
        for form in ((1, rk.INF32), (2, rk.INF32, 1)):
            rk.launches = 0
            got = call(dev, form)
            torch.cuda.synchronize()
            launched = rk.launches
            want = call("cpu", form)
            if launched != 1 or got.shape != (c.n,) \
                    or not torch.equal(got.cpu(), want):
                raise AssertionError(
                    f"relax_sweep in the reference's form {form}: {name} "
                    f"{c.label}: {launched} launches, shape "
                    f"{tuple(got.shape)}, "
                    f"{int((got.cpu() != want).sum())} entries differ")
            checked += 1
    log(f"phase 2: ops.relax_sweep in the reference's form (keys [V], "
        f"w=None, hub [V]) on {', '.join(REFERENCE_FORM_CASES)}: one "
        f"launch a call, equal to the plain version on the CPU")
    return checked


def check_edge_relax_small(torch, dev) -> int:
    """Kernel C against its plain version and the COO oracle, bit for bit,
    one launch a call, over every case of tests/_kernel_cases.py (its
    wide mode at block_v 58,113 and 131,072 among them)."""
    import _kernel_cases as kernel_cases
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ref as rref
    cases = wide = 0
    for name in kernel_cases.edge_relax_names():
        for c in kernel_cases.edge_relax_case(name):
            for step in kernel_cases.STEPS:
                args = kernel_cases.edge_relax_args(c, step, dev)
                before = rk.launches_edge_relax
                got = rk.edge_relax(*args)
                torch.cuda.synchronize()
                if rk.launches_edge_relax != before + 1:
                    raise AssertionError(f"edge_relax launched "
                                         f"{rk.launches_edge_relax - before}"
                                         f" kernels: {name} {c.label}")
                coo = rref.edge_relax(*(torch.from_numpy(x).to(dev) for x in
                                        (c.keys, c.src, c.dst, c.valid)),
                                      step, c.n)
                if not (torch.equal(got, rk.edge_relax_plain(*args))
                        and torch.equal(got, coo)):
                    raise AssertionError(f"edge_relax != plain / COO: {name}"
                                         f" {c.label} step={step}")
                cases += 1
                wide += rk.edge_relax_mode(c.block_v) == "wide"
    if wide == 0:
        raise AssertionError("no edge_relax case ran kernel C's wide mode")
    log(f"phase 2: kernel C's wide mode (block_v > "
        f"{rk.EDGE_RELAX_MAX_BLOCK_V}) on {wide} calls, each one launch and "
        f"equal to the plain version and the COO oracle")
    return cases


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
    # Both launch regimes at the MIND widths (L = 50, D = 64): bags split
    # over warps (B = 1, 512) and a warp a bag (B = 65,536, phase 5);
    # then two calls on one input, which must give the same bits.
    n, d, bag = 100_000, MIND_DIM, MIND_HIST
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    for b in (1, 512):
        if ek.embed_bag_geometry(b, bag, d, sms).warps == 1:
            raise AssertionError(f"embed_bag B={b} does not split its bags")
        idx = torch.from_numpy(
            rng.integers(-n, n, (b, bag)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.random((b, bag)).astype(np.float32)).to(dev)
        close(table, idx, w, f"B={b} L={bag} D={d}")
    if not torch.equal(ek.embed_bag(table, idx, w),
                       ek.embed_bag(table, idx, w)):
        raise AssertionError("embed_bag: two calls on one input differ")
    cases += 1
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


# --- phase 5: kernel A's bound and tilings, kernels C and D ----------------------

def sweep_bound(bg, keys, hub, mask, e2: int) -> dict:
    """What one sweep of `keys` over tiling `bg` needs, and its bound:
    keys in and out, hub and rowblk once each; the four index streams of
    each live tile slot and only slot_t of each padding slot; the mask of
    each live slot's edge and w of each edge a plane lets through. Beside
    it the bound of every padded tile slot's indices and of w and mask of
    every slot."""
    p, n = keys.shape
    live_slot = bg.slot_t.reshape(-1) != 0
    live_slots = int(live_slot.sum())
    perm_live = bg.perm_t.reshape(-1)[live_slot].long()
    del live_slot
    # The mask at each live tile slot's edge; the (plane, slot) pairs it
    # lets through, and the slots some plane lets through.
    m_live = mask[..., perm_live]
    plane_edges = int(m_live.sum()) * (p if mask.dim() == 1 else 1)
    used = int((m_live if mask.dim() == 1 else m_live.any(0)).sum())
    del m_live, perm_live
    keys_hub = (p * n * 4 * 2 + (p * n if hub is not None else 0)
                + bg.rowblk_t.numel() * 4)
    nbytes = (keys_hub + live_slots * 16 + (bg.slots - live_slots) * 4
              + live_slots * (p if mask.dim() == 2 else 1) + used * 4)
    ops = 4 * plane_edges   # add, saturate, hub clear, min per pair
    bms, by = bound_ms(nbytes, ops)
    padded_bytes = keys_hub + bg.slots * 16 + mask.numel() + e2 * 4
    padded_ms, _ = bound_ms(padded_bytes, ops)
    return dict(bound_ms=bms, bound_by=by, bytes=nbytes,
                padded_bound_ms=padded_ms, padded_bytes=padded_bytes,
                live_slots=live_slots, live_plane_edges=plane_edges)


#: Kernel A's tilings beyond the main path's block_v 512 that phase 5
#: times (all past SWEEP_MAX_BLOCK_V, so in the wide mode), at block_e
#: api.BLOCK_E; 2^20 is one destination block.
SWEEP_TILINGS = (28_033, 65_536, 1 << 20)
#: Kernel C's, past EDGE_RELAX_MAX_BLOCK_V.
EDGE_RELAX_TILINGS = (58_113, 1 << 20)


def time_sweep_tilings(torch, dev, g1, keys, hub, one_block, want) -> list:
    """Kernel A's key2 wave (keys [32, 2^20], the landmarks' hub, the
    live edges) at each block_v of SWEEP_TILINGS, tiled by a new engine
    (by `one_block`, phase 3's, at its block_v): one launch, equal to its
    plain version and to `want` (the block_v 512 result); CUDA events in
    turns with the plain version beside the needed-bytes bound, and the
    device ms of its kernels from one profiler pass over three calls."""
    from repro_torch import api
    from repro_torch.core.engine import RelaxEngine
    from repro_torch.core.labelling import INF_KEY2
    from repro_torch.kernels.edge_relax import kernel as rk
    rows = []
    for block_v in SWEEP_TILINGS:
        eng = one_block if block_v == one_block.block_v else RelaxEngine(
            block_v=block_v, block_e=api.BLOCK_E, device=dev)
        t0 = time.perf_counter()
        bg = eng.prepare(g1).tiles
        prep_s = time.perf_counter() - t0
        args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
                bg.rowblk_t, g1.valid, g1.w, 2, INF_KEY2, 1, N, bg.block_v,
                bg.nb)
        reset_launches()
        got = rk.relax_sweep(*args)
        torch.cuda.synchronize()
        launches = read_launches()["relax_sweep"]
        plain = rk.relax_sweep_plain(*args)
        if launches != 1 or not torch.equal(got, plain) \
                or not torch.equal(got, want):
            raise AssertionError(
                f"relax_sweep at block_v={block_v}: {launches} launches, "
                f"{int((got != plain).sum())} entries != plain, "
                f"{int((got != want).sum())} != block_v {api.BLOCK_V}")
        del got, plain
        ms, plain_ms = paired_ms(lambda: rk.relax_sweep(*args),
                                 lambda: rk.relax_sweep_plain(*args), 10, 3)
        per = device_kernels(torch, lambda: [rk.relax_sweep(*args)
                                             for _ in range(3)])[0]
        parts = {k: v / 3 for k, v in sweep_parts(per).items()}
        mode = rk.sweep_mode(block_v)
        row = dict(block_v=block_v, block_e=api.BLOCK_E, mode=mode,
                   group=rk.plane_group(keys.shape[0], block_v),
                   rows=bg.rowblk_t.numel(), slots=bg.slots,
                   prepare_s=prep_s, launches=launches, max_abs_err=0,
                   ms=ms, plain_ms=plain_ms, device_ms=parts,
                   **sweep_bound(bg, keys, hub, g1.valid, g1.src.shape[0]))
        rows.append(row)
        log(f"relax_sweep key2 wave at block_v={block_v} ({mode} mode, "
            f"group {row['group']}, block_e={api.BLOCK_E}): {row['rows']} "
            f"rows, {bg.slots} slots, host prepare {prep_s:.3f} s; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); == plain and =="
            f" block_v {api.BLOCK_V}; device ms of one call {parts}")
        del bg, args
    return rows


# --- phase 5: kernels C and D on their own paths --------------------------------

def time_edge_relax(torch, dev, g1, lab1, block_v: int) -> dict:
    """Kernel C through `ops.prepare` / `ops.edge_relax` on the
    post-update graph, one plane, step 1, at `block_v` (block_e
    api.BLOCK_E)."""
    from repro_torch import api
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops
    from repro_torch.kernels.edge_relax import ref as rref

    t0 = time.perf_counter()
    bg = rops.prepare(g1.src.cpu().numpy(), g1.dst.cpu().numpy(),
                      g1.valid.cpu().numpy(), g1.n, block_v, 1,
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
    mode = rk.edge_relax_mode(block_v)
    fill = "fill_chunked_kernel" if mode == "tiled" else "fill_inf_kernel"
    parts = {k: profiled_us(torch, lambda: rk.edge_relax(*args), k, 10) / 1e3
             for k in (fill, "edge_relax_kernel")}
    rows = bg.rowblk_t.numel()
    live = int((bg.valid_t != 0).sum())
    # What this run's data needs: valid_t of every slot, src and local dst
    # of the valid ones, rowblk, keys once and out once.
    nbytes = bg.slots * 4 + live * 8 + rows * 4 + 2 * g1.n * 4
    bms, by = bound_ms(nbytes, 3 * live)   # add, saturate, min per slot
    row = dict(block_v=block_v, mode=mode, rows=rows, slots=bg.slots,
               valid_slots=live, prepare_s=prep_s, launches=launches,
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=by, bytes=nbytes, device_ms=parts)
    log(f"edge_relax (ops.prepare of every slot, block_v={block_v}, {mode} "
        f"mode, block_e={api.BLOCK_E}): {rows} rows, {bg.slots} slots "
        f"({live} valid), host prepare {prep_s:.3f} s; kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}), max_abs_err {err}"
        f"; == COO oracle; device ms of one call {parts}")
    return row


def time_embed_bag(torch, dev, floor_us: float) -> list:
    """Kernel D through `ops.embed_bag` (mean, ~80 % mask) at the MIND
    config's widths, beside `F.embedding_bag` on the same weights: event
    ms per call, the kernel's own device µs from the profiler beside the
    launch floor `floor_us`, and the launch geometry the wrapper chose."""
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
        kernel_us = profiled_us(torch, lambda: ek.embed_bag(table, idx_m, w),
                                "embed_bag_kernel")
        geo = ek.embed_bag_geometry(
            b, MIND_HIST, MIND_DIM,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            table.data_ptr() % 16 == 0)
        # What this run's data needs: each distinct gathered row once,
        # idx and w of every slot, out once. (Every slot's row, the
        # count with repeats, would be B·L·4·D.)
        distinct = int(torch.unique(idx_m).numel())
        nbytes = (distinct * 4 * MIND_DIM + b * MIND_HIST * 8
                  + 4 * b * MIND_DIM)
        bms, by = bound_ms(nbytes, 2 * b * MIND_HIST * MIND_DIM)
        rows.append(dict(batch=b, launches=launches, max_abs_err=err, ms=ms,
                         kernel_device_us=kernel_us, launch_floor_us=floor_us,
                         geometry=dataclasses.asdict(geo),
                         plain_ms=plain, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, bytes=nbytes, distinct_rows=distinct,
                         bytes_every_slot=b * MIND_HIST * (4 * MIND_DIM + 8)
                         + 4 * b * MIND_DIM,
                         lib_max_abs_err=float((got - lib).abs().max())))
        log(f"embed_bag B={b} L={MIND_HIST} D={MIND_DIM} (table "
            f"{MIND_ITEMS} rows, {distinct} distinct gathered; {geo}): "
            f"kernel {ms:.4f} ms per call (events), {kernel_us:.2f} us on "
            f"the device (profiler; launch floor {floor_us:.2f} us), plain "
            f"{plain:.4f} ms, "
            f"F.embedding_bag {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"max_abs_err {err:.3g} (vs library "
            f"{rows[-1]['lib_max_abs_err']:.3g})")
    del table
    return rows


def time_seed_match(torch, dev) -> list:
    """The seed weights' slot match at each of SEED_MATCH_SLOTS slots
    (undirected pairs of BA's |V|, half of them live) with
    SEED_MATCH_ROWS row keys of live slots, as a deletion batch's: equal
    to its plain version, one launch a call, then by CUDA events in turns
    with it, beside the bound of the bytes it needs (8 a slot, 5 more a
    slot whose key is a row's) and that of 13 bytes a slot."""
    from repro_torch.kernels.seed_match import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for e2 in SEED_MATCH_SLOTS:
        a, b = torch.randint(0, N, (2, e2 // 2), generator=gen, device=dev,
                             dtype=torch.int32)
        src = torch.stack([a, b], 1).reshape(-1)
        dst = torch.stack([b, a], 1).reshape(-1)
        valid = torch.rand(e2, generator=gen, device=dev) < 0.5
        w = torch.randint(1, 9, (e2,), generator=gen, device=dev,
                          dtype=torch.int32)
        live = valid.nonzero().flatten()
        pick = live[torch.randint(0, live.numel(), (SEED_MATCH_ROWS,),
                                  generator=gen, device=dev)]
        keys, _ = torch.sort(sk.slot_key(src[pick], dst[pick], "pair"))
        args = (src, dst, valid, w, keys, "pair")
        sk.launches = 0
        got = sk.seed_match(*args)
        want = sk.seed_match_plain(*args)
        torch.cuda.synchronize()
        if sk.launches != 1 or not torch.equal(got, want):
            raise AssertionError(f"seed_match != plain at {e2} slots "
                                 f"(launches {sk.launches})")
        ms, plain = paired_ms(lambda: sk.seed_match(*args),
                              lambda: sk.seed_match_plain(*args), 50, 3)
        matched = int(torch.isin(sk.slot_key(src, dst, "pair"), keys).sum())
        bms, by = bound_ms(8 * e2 + 5 * matched, 0)
        row = dict(slots=e2, rows=SEED_MATCH_ROWS, matched_slots=matched,
                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                   bound_13b_ms=13 * e2 / HBM_BYTES_PER_S * 1e3,
                   geometry=dataclasses.asdict(sk.seed_match_geometry(
                       SEED_MATCH_ROWS, e2, torch.cuda.get_device_properties(
                           dev).multi_processor_count)),
                   max_abs_err=0)
        rows.append(row)
        log(f"seed_match {e2} slots, U={SEED_MATCH_ROWS} ({matched} matched "
            f"slots): kernel {ms:.4f} ms, plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms ({by}, {100 * bms / ms:.1f} %), 13 B a slot "
            f"{row['bound_13b_ms']:.4f} ms; geometry {row['geometry']}")
        del a, b, src, dst, valid, w, live, pick, keys, args, got, want
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
                  fused: bool = False, mesh=None, phase: str = "6") -> dict:
    """One pipelined update (chunk_sweeps 1, on `mesh` if given) stepped
    by hand: chunks per phase and the host syncs of each step, held to
    `want` (g, lab, aff)."""
    from repro_torch.core import engine as teng
    from repro_torch.core import snapshot as tsnap
    teng.WAVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sources: dict = {}
    steps, last, (nxt, aff) = step_syncs(torch, tsnap.pipelined_update(
        snap, batch, plan=plan, g_new=g_new, fused=fused, mesh=mesh),
        sources)
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
    log(f"phase {phase} chunks ({what}): {wall:.3f} s, chunks per phase "
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
    if min(launches[k] for k in ("relax_sweep", "minplus", "seed_match")) \
            <= 0:
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


# --- phase 10: the sharded path on meshes of the one card --------------------

SHARD_MESHES = ((1, 1), (1, 4), (2, 2), (4, 1))   # (data, model)
SHARD_SERVE_MESH = (2, 2)


def run_sharded(torch, np, dev, card, g0, lab0, batch, full, answers, qs,
                qt, fr, base) -> dict:
    """Phase 10: `core/shard.py` at phase 3's width on meshes whose every
    device is the one card, held bit for bit to phase 3's build, update
    and answers; the pipelined update and the serve loop on a mesh."""
    from repro_torch import api
    from repro_torch.core import batch as tbat
    from repro_torch.core import construct as tcon
    from repro_torch.core import engine as teng
    from repro_torch.core import query as tq
    from repro_torch.core import shard
    from repro_torch.core import snapshot as tsnap
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.launch.serve import ServeConfig, ServeLoop

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g1, lab1, aff1 = full
    eng = api.default_engine(dev)
    plan0, plan1 = eng.prepare(g0), eng.prepare(g1)   # tiled once, reused
    lm = lab0.landmarks
    n_q = len(answers)
    s_all = torch.from_numpy(qs[:n_q]).to(dev)
    t_all = torch.from_numpy(qt[:n_q]).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def drive(build, update, query) -> dict:
        """Build, update and queries in microbatches, each timed and its
        kernel launches counted, every result held to phase 3's."""
        row = {}
        reset_launches()
        lab, row["build_s"] = timed(build)
        row["build_launches"] = read_launches()
        for f in ("landmarks", "dist", "hub", "highway"):
            if not torch.equal(getattr(lab, f), getattr(lab0, f)):
                raise AssertionError(f"{f} after the build != phase 3's")
        reset_launches()
        (_, lab_u, aff), row["update_s"] = timed(lambda: update(lab))
        row["update_launches"] = read_launches()
        for f in ("dist", "hub", "highway"):
            if not torch.equal(getattr(lab_u, f), getattr(lab1, f)):
                raise AssertionError(f"{f} after the update != phase 3's")
        if not torch.equal(aff, aff1):
            raise AssertionError("aff != phase 3's")
        reset_launches()
        mb, got = [], []
        for i in range(0, n_q, MICROBATCH):
            sl = slice(i, i + MICROBATCH)
            d, secs = timed(lambda: query(lab_u, s_all[sl], t_all[sl]))
            got.append(d)
            mb.append(secs * 1e3)
        row["query_launches"] = read_launches()
        if not torch.equal(torch.cat(got), answers):
            raise AssertionError("answers != phase 3's")
        row["query_mb_ms"] = mb
        row["query_mb_p50_ms"] = statistics.median(mb)
        return row, aff

    out: dict = {"meshes": {}}
    # The unsharded path with the same plans, for the comparison.
    row, _ = drive(
        lambda: tcon.build_labelling(g0, lm, plan=plan0),
        lambda lab: tbat.batchhl_update(g0, batch, lab, plan=plan1,
                                        g_new=g1),
        lambda lab, s, t: tq.batched_query(g1, lab, s, t,
                                           max_steps=MAX_STEPS, plan=plan1))
    out["unsharded"] = row
    log(f"phase 10 unsharded ({card}): build {row['build_s']:.3f} s, "
        f"update {row['update_s']:.3f} s, query microbatch p50 "
        f"{row['query_mb_p50_ms']:.3f} ms")
    for data, model in SHARD_MESHES:
        mesh = make_host_mesh(model=model, devices=[dev] * (data * model))
        row, aff = drive(
            lambda: shard.shard_build_labelling(mesh, g0, lm, plan=plan0),
            lambda lab: shard.shard_batchhl_update(mesh, g0, batch, lab,
                                                   plan=plan1, g_new=g1),
            lambda lab, s, t: shard.shard_batched_query(
                mesh, g1, lab, s, t, max_steps=MAX_STEPS, plan=plan1))
        if not torch.equal(shard.affected_vertices(mesh, aff),
                           aff1.any(0)):
            raise AssertionError("affected_vertices != aff.any(0)")
        # Kernel B once per (data, model) shard of each microbatch;
        # kernel A in every shard's waves.
        # Every shard's fixpoints launch kernel A at least once each.
        n_mb = len(row["query_mb_ms"])
        if row["query_launches"]["minplus"] != n_mb * data * model or min(
                row["build_launches"]["relax_sweep"],
                row["update_launches"]["relax_sweep"]) < data * model or \
                row["query_launches"]["relax_sweep"] <= 0:
            raise AssertionError(f"mesh ({data}, {model}): launches {row}")
        key = f"data={data},model={model}"
        out["meshes"][key] = row
        log(f"phase 10 mesh ({data}, {model}) ({card}): build "
            f"{row['build_s']:.3f} s, update {row['update_s']:.3f} s, query "
            f"microbatch p50 {row['query_mb_p50_ms']:.3f} ms; launches "
            f"build {row['build_launches']['relax_sweep']} A, update "
            f"{row['update_launches']['relax_sweep']} A, queries "
            f"{row['query_launches']['relax_sweep']} A + "
            f"{row['query_launches']['minplus']} B; == phase 3's labelling, "
            f"update, aff, affected vertices and {n_q} answers")

    # The pipelined update's chunks on a mesh, held to phase 3's update.
    mesh = make_host_mesh(model=SHARD_SERVE_MESH[1],
                          devices=[dev] * (SHARD_SERVE_MESH[0]
                                           * SHARD_SERVE_MESH[1]))
    snap0 = tsnap.Snapshot(0, g0, lab0, None)
    out["chunks"] = {
        "full": chunk_profile(torch, snap0, batch, plan1, g1, full,
                              "full, mesh (2, 2)", mesh=mesh, phase="10"),
        "fused": chunk_profile(torch, snap0, batch, plan1, g1, full,
                               "fused, mesh (2, 2)", fused=True, mesh=mesh,
                               phase="10"),
        "frontier": chunk_profile(torch, snap0, batch, fr.prepare(g1), g1,
                                  full, "frontier, mesh (2, 2)", mesh=mesh,
                                  phase="10")}

    # The serve loop on the mesh: 2 ticks of run A, held to run A's steps.
    # The mesh is built by hand and names the card without an index, as a
    # user would: its grid must resolve to the loop's device.
    cfg = ServeConfig(**{**base, "batches": 2}, pipeline=True,
                      keep_history=True, mesh="host",
                      shards=SHARD_SERVE_MESH[1])
    mesh = Mesh([["cuda"] * SHARD_SERVE_MESH[1]] * SHARD_SERVE_MESH[0])
    reset_launches()
    rep, wall = timed(lambda: ServeLoop(cfg, mesh=mesh).run())
    row = serve_row(rep, wall)
    row["launches"] = read_launches()
    checked = {}
    for v in (1, 2):
        want = tsnap.restore_snapshot(str(SERVE_DIR / "a"), step=v,
                                      device=dev)
        same_snapshot(torch, dataclasses.replace(rep.history[v], plan=None),
                      want, f"mesh serve loop, version {v}")
        del want
    for v, snap in sorted(rep.history.items()):
        rows = served_answers((rep,), v, SERVE_CHECK)
        if rows:
            check_served(torch, np, dev, snap, rows,
                         f"mesh serve loop, version {v}")
        checked[v] = len(rows)
    row["checked_answers"] = checked
    out["serve"] = row
    pct = row["latency_s"]
    log(f"phase 10 serve loop on the hand-built {mesh} ({card}): "
        f"{wall:.1f} s; "
        + "; ".join(f"tick {t['tick']} update {t['update_s']:.3f} s"
                    for t in row["ticks"])
        + f" | latency p50 {pct['p50'] * 1e3:.1f} ms p99 "
        f"{pct['p99'] * 1e3:.1f} ms; launches {row['launches']}; versions "
        f"1, 2 == run A's steps; served answers == COO path == scipy BFS "
        f"{checked}")
    del rep
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 10 ({card}): {out['wall_s']:.1f} s, peak device memory "
        f"{out['peak_gb']:.2f} GB")
    return out


# --- phase 11: MIND and the training substrate at full width ---------------

MIND_MEDIUM_ITEMS = 65_536
MIND_MEDIUM_BATCH = 1_024
MIND_MASKED = 0.25         # share of the medium batch's history masked
MIND_MEDIUM_STEPS = 4
MIND_STEPS = 8             # full-width train steps, then the int8_ef ones
MIND_EF_STEPS = 2
MIND_LR = 3e-3             # as tests/test_models_smoke.py
MIND_SERVE_CALLS = 20
MIND_CHECK_USERS = 8
MIND_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")
#: (rtol, atol) of tests/test_torch_mind.py and tests/test_torch_train.py
MIND_TOL = {"loss": (1e-5, 0.0), "grad": (0.0, 1e-6), "param": (0.0, 2e-5),
            "update": (1e-6, 1e-7), "score": (1e-4, 1e-5)}
#: Params after train steps on the card and on the CPU: a gradient
#: component a rounding apart can flip the sign of a near-zero Adam step
#: or move an int8 code (to or from 0), which moves that element by up
#: to ≈ lr. So at most this share of the elements may lie outside the
#: "param" tolerance, and none further than 2.5 lr (the bound of
#: tests/test_train_infra.py::test_microbatch_equals_full_batch). The
#: share is of all the params' elements together.
MIND_PARAM_SHARE = 1e-5
MIND_PARAM_CAP = 2.5 * MIND_LR


def mind_loss_grads(torch, mind, params, batch, cfg):
    """(loss, {name: gradient}) of `train_loss` at `params`."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = mind.train_loss(leaves, batch, cfg)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


class Held:
    """Card-against-CPU comparisons: each one's max abs error and its
    elements outside |got − want| <= atol + rtol·|want| (none allowed,
    but for "param" see `MIND_PARAM_SHARE`), all logged before the phase
    fails on any."""

    def __init__(self):
        self.rows, self.bad = {}, []

    def __call__(self, name: str, got, want, kind: str) -> None:
        rtol, atol = MIND_TOL[kind]
        g = got.detach().cpu().double()
        w = want.detach().cpu().double()
        diff = (g - w).abs()
        over = int((diff > atol + rtol * w.abs()).sum()) + int(
            (g.isnan() != w.isnan()).sum())
        row = dict(max_abs_err=float(diff.nan_to_num(0).max()),
                   outside=over, rtol=rtol, atol=atol)
        if kind == "param":
            row.update(share=MIND_PARAM_SHARE, cap=MIND_PARAM_CAP)
            ok = (over <= MIND_PARAM_SHARE * g.numel()
                  and row["max_abs_err"] <= MIND_PARAM_CAP
                  and not (g.isnan() != w.isnan()).any())
        else:
            ok = not over
        self.rows[name] = row
        if not ok:
            self.bad.append(name)


def mind_f64_interests(torch, emb, mask, bilinear, out_proj, cfg):
    """B2I routing in float64 on the CPU: a plain transcription of the
    reference's routing, independent of `repro_torch.models.mind`."""
    u = emb @ bilinear
    b = torch.zeros(emb.shape[0], cfg.n_interests, emb.shape[1],
                    dtype=torch.float64)
    for it in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(mask[:, None, :], b, -1e9), dim=1)
        z = torch.einsum("bkl,bld->bkd", w, u)
        sq = (z * z).sum(-1, keepdim=True)
        caps = sq / (1 + sq) * z / torch.sqrt(sq + 1e-9)
        if it < cfg.capsule_iters - 1:
            b = b + torch.einsum("bkd,bld->bkl", caps, u)
    return torch.einsum("bkd,de->bke", caps, out_proj)


def timed_train(torch, loss_fn, state, batch, opt, steps: int,
                count_syncs_at: int):
    """`steps` steps of `make_generic_train_step(loss_fn, opt)` from
    `state` on `batch`: (state, {losses, step_ms and opt_ms by CUDA
    events, host syncs of step `count_syncs_at` (None for 0), allocated
    GB before each step, each step's peak GB and their max})."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts
    opt_events: list = []
    real_update = opt_lib.adamw_update

    def timed_update(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_update(*args, **kw)
        ev[1].record()
        opt_events.append(ev)
        return res

    step = tts.make_generic_train_step(loss_fn, opt)
    ev, losses, syncs, before, peak = [], [], None, [], []
    opt_lib.adamw_update = timed_update
    try:
        for i in range(steps):
            torch.cuda.synchronize()
            before.append(torch.cuda.memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            if i + 1 == count_syncs_at:
                box = []
                syncs = host_syncs(torch, lambda: box.append(
                    step(state, batch)))
                state, aux = box[0]
            else:
                state, aux = step(state, batch)
            e[1].record()
            ev.append(e)
            losses.append(aux["loss"])
            torch.cuda.synchronize()
            peak.append(torch.cuda.max_memory_allocated() / 1e9)
    finally:
        opt_lib.adamw_update = real_update
    step_ms = [a.elapsed_time(b) for a, b in ev]
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    return state, dict(losses=[float(x) for x in losses],
                       step_ms=step_ms, opt_ms=opt_ms,
                       host_syncs=syncs, allocated_gb=before,
                       step_peak_gb=peak, peak_gb=max(peak))


def run_mind(torch, np, dev, card) -> dict:
    """Phase 11: MIND and the training substrate. The card against the CPU
    at a medium size; 8 + 2 train steps at full width; the three serve
    shapes at full width on the trained params, held to float64."""
    from repro_torch.configs import common
    from repro_torch.data import synthetic
    from repro_torch.models import mind
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts

    t_phase = time.perf_counter()
    cfg = common.get_arch("mind").model_config()
    out: dict = {"card": card}

    # --- the card against the CPU at a medium size --------------------------
    mcfg = dataclasses.replace(cfg, n_items=MIND_MEDIUM_ITEMS)
    p_cpu = mind.init_params(mcfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    b_cpu = synthetic.materialize(synthetic.mind_train_layout(
        MIND_MEDIUM_BATCH, mcfg.hist_len, mcfg.n_items), seed=1,
        device="cpu")
    b_cpu["hist_mask"] = torch.from_numpy(np.random.default_rng(2).random(
        (MIND_MEDIUM_BATCH, mcfg.hist_len)) >= MIND_MASKED)

    def on_card(tree):
        return {k: on_card(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    p_dev, b_dev = on_card(p_cpu), on_card(b_cpu)
    held = Held()
    loss_c, grads_c = mind_loss_grads(torch, mind, p_cpu, b_cpu, mcfg)
    loss_d, grads_d = mind_loss_grads(torch, mind, p_dev, b_dev, mcfg)
    held("loss", loss_d, loss_c, "loss")
    for k in grads_c:
        held(f"grad {k}", grads_d[k], grads_c[k], "grad")
    for compress in (None, "int8_ef"):
        tag = compress or "plain"
        opt = opt_lib.AdamWConfig(lr=MIND_LR, compress=compress)
        # One update on the same inputs: the CPU's state after one step
        # and the CPU's gradients, on both sides.
        _, st = opt_lib.adamw_update(
            p_cpu, grads_c, opt_lib.init_opt_state(p_cpu, opt), opt)
        want_p, want_s = opt_lib.adamw_update(p_cpu, grads_c, st, opt)
        got_p, got_s = opt_lib.adamw_update(p_dev, on_card(grads_c),
                                            on_card(st), opt)
        for k in sorted(p_cpu):
            held(f"update {tag} param {k}", got_p[k], want_p[k], "update")
            for part in ("m", "v") + (("ef",) if compress else ()):
                held(f"update {tag} {part} {k}", got_s[part][k],
                     want_s[part][k], "update")
            if compress:
                gf = grads_c[k] + st["ef"][k]
                q_c, _ = opt_lib._int8_codes(gf)
                q_d, _ = opt_lib._int8_codes(gf.to(dev))
                n = int((q_d.cpu() != q_c).sum())
                held.rows[f"update {tag} codes {k}"] = dict(differ=n)
                if n:
                    held.bad.append(f"update {tag} codes {k}")
        # Train steps from the same params on each side.
        step = tts.make_generic_train_step(
            lambda p, b: mind.train_loss(p, b, mcfg), opt)
        s_c = tts.init_train_state(p_cpu, opt)
        s_d = tts.init_train_state(p_dev, opt)
        for i in range(MIND_MEDIUM_STEPS):
            s_c, aux_c = step(s_c, b_cpu)
            s_d, aux_d = step(s_d, b_dev)
            held(f"steps {tag} loss {i + 1}", aux_d["loss"], aux_c["loss"],
                 "loss")
        # All params as one vector: the share is of all their elements.
        held(f"steps {tag} params", *(torch.cat(
            [s["params"][k].flatten().cpu() for k in sorted(p_cpu)])
            for s in (s_d, s_c)), "param")
        held.rows[f"steps {tag} params"]["max_abs_err_by_param"] = {
            k: float((s_d["params"][k].cpu() - s_c["params"][k]).abs().max())
            for k in sorted(p_cpu)}
        del s_c, s_d
    out["medium"] = dict(n_items=MIND_MEDIUM_ITEMS, batch=MIND_MEDIUM_BATCH,
                         masked=MIND_MASKED, steps=MIND_MEDIUM_STEPS,
                         held=held.rows)
    worst = {k: v.get("max_abs_err", v.get("differ"))
             for k, v in held.rows.items()}
    log(f"phase 11 medium ({MIND_MEDIUM_ITEMS} items, B "
        f"{MIND_MEDIUM_BATCH}, {MIND_MASKED:.0%} masked), card against the "
        f"CPU ({card}): max abs errors {worst}")
    if held.bad:
        raise AssertionError(f"phase 11: the card disagrees with the CPU on "
                             f"{held.bad}: {held.rows}")
    del p_cpu, b_cpu, p_dev, b_dev, grads_c, grads_d

    # --- training at full width ---------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    params = mind.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    std, mean = torch.std_mean(params["item_embed"])
    init = dict(table_mean=float(mean), table_std=float(std),
                **{f"{k}_std": float(params[k].std())
                   for k in ("bilinear", "out_proj")})
    if abs(init["table_mean"]) > 0.001 or \
            abs(init["table_std"] - 0.1) > 0.001 or any(
            abs(init[f"{k}_std"] - 1 / 8) > 0.05 / 8
            for k in ("bilinear", "out_proj")):
        raise AssertionError(f"phase 11: init statistics {init}")
    b_train = common.MIND_SHAPES["train_batch"]["batch"]
    batch = synthetic.materialize(synthetic.mind_train_layout(
        b_train, cfg.hist_len, cfg.n_items), seed=3, device=dev)

    def loss(p, b):
        return mind.train_loss(p, b, cfg)

    # The initial state goes to timed_train as a temporary, its only
    # reference, so its m and v die with step 1; the initial params stay
    # live through `params`, as in the GNN phase.
    opt = opt_lib.AdamWConfig(lr=MIND_LR)
    state, run = timed_train(torch, loss, tts.init_train_state(params, opt),
                             batch, opt, MIND_STEPS, MIND_STEPS)
    del params
    losses = run["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 11: full-width losses {losses}")
    later = slice(1, None)
    run["step_ms_p50"] = statistics.median(run["step_ms"][later])
    run["opt_ms_p50"] = statistics.median(run["opt_ms"][later])
    run["fwd_bwd_ms_p50"] = statistics.median(
        s - o for s, o in zip(run["step_ms"][later], run["opt_ms"][later]))
    # The optimiser's least bytes: p, g, m, v read and p, m, v written.
    nbytes = 7 * sum(t.numel() * 4 for t in state["params"].values())
    run["opt_bound_ms"], run["opt_bound_by"] = bound_ms(nbytes, 0)
    run["opt_bytes"] = nbytes
    log(f"phase 11 train ({card}): {cfg.n_items} x {cfg.embed_dim} table, "
        f"B {b_train}, {MIND_STEPS} steps lr {MIND_LR}: losses "
        f"{[round(x, 5) for x in losses]}; step p50 "
        f"{run['step_ms_p50']:.2f} ms (fwd+bwd {run['fwd_bwd_ms_p50']:.2f}, "
        f"optimiser {run['opt_ms_p50']:.2f} ms against a "
        f"{run['opt_bound_ms']:.2f} ms bound of {nbytes / 1e9:.2f} GB); "
        f"host syncs in step {MIND_STEPS}: {run['host_syncs']}; peak "
        f"device memory {run['peak_gb']:.2f} GB (allocated before each "
        f"step {[round(x, 2) for x in run['allocated_gb']]} GB); init "
        f"{init}")
    if run["host_syncs"]:
        raise AssertionError(f"phase 11: a train step synced the host "
                             f"{run['host_syncs']} times")

    opt_ef = opt_lib.AdamWConfig(lr=MIND_LR, compress="int8_ef")
    params = state["params"]
    del state
    state, run_ef = timed_train(torch, loss,
                                tts.init_train_state(params, opt_ef), batch,
                                opt_ef, MIND_EF_STEPS, 0)
    del params
    if not all(np.isfinite(run_ef["losses"])):
        raise AssertionError(f"phase 11: int8_ef losses {run_ef['losses']}")
    log(f"phase 11 train int8_ef ({card}): {MIND_EF_STEPS} steps: losses "
        f"{[round(x, 5) for x in run_ef['losses']]}; step ms "
        f"{[round(x, 2) for x in run_ef['step_ms']]}, optimiser ms "
        f"{[round(x, 2) for x in run_ef['opt_ms']]}; peak device memory "
        f"{run_ef['peak_gb']:.2f} GB (allocated before each step "
        f"{[round(x, 2) for x in run_ef['allocated_gb']]} GB)")
    out["init"], out["train"], out["train_int8_ef"] = init, run, run_ef
    params = state["params"]
    del state, batch

    # --- serving at full width on the trained params ------------------------
    rng = np.random.default_rng(9)
    serve = {}
    cpu_p = {k: params[k].cpu().double() for k in ("bilinear", "out_proj")}
    for i, name in enumerate(MIND_SERVE):
        sh = common.MIND_SHAPES[name]
        if sh["kind"] == "serve":
            layout = synthetic.mind_serve_layout(
                sh["batch"], cfg.hist_len, cfg.n_items, sh["n_cands"])
            fn = mind.serve_scores
        else:
            layout = synthetic.mind_retrieval_layout(
                cfg.hist_len, cfg.n_items, sh["n_cands"])
            fn = mind.retrieval_scores
        b = synthetic.materialize(layout, seed=4 + i, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        with torch.no_grad():
            scores = fn(params, b, cfg)
            for _ in range(MIND_SERVE_CALLS):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                fn(params, b, cfg)
                e[1].record()
                ms.append(e)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(c) for a, c in ms]
        users = (rng.choice(sh["batch"], MIND_CHECK_USERS, replace=False)
                 if sh["batch"] > 1 else np.zeros(1, np.int64))
        u = torch.from_numpy(users).to(dev)
        hist, mask = b["hist"][u].long(), b["hist_mask"][u]
        cands = b["cands"][u] if sh["kind"] == "serve" else b["cands"]
        with torch.no_grad():
            emb = params["item_embed"][hist].cpu().double()
            cand = params["item_embed"][cands.long()].cpu().double()
        ints = mind_f64_interests(torch, emb, mask.cpu(), cpu_p["bilinear"],
                                  cpu_p["out_proj"], cfg)
        eq = "bkd,bcd->bkc" if sh["kind"] == "serve" else "bkd,cd->bkc"
        want = torch.einsum(eq, ints, cand).amax(1)
        got = scores[u] if sh["kind"] == "serve" else scores
        check = Held()
        check("scores", got, want, "score")
        per = (sh["batch"] if sh["kind"] == "serve" else sh["n_cands"])
        row = dict(batch=sh["batch"], n_cands=sh["n_cands"],
                   p50_ms=percentile(ms, 0.5), p99_ms=percentile(ms, 0.99),
                   ms=ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   checked_users=len(users), **check.rows["scores"])
        row["per_s"] = per / (row["p50_ms"] / 1e3)
        serve[name] = row
        unit = "users" if sh["kind"] == "serve" else "candidates"
        log(f"phase 11 {name} ({card}): B {sh['batch']} x {sh['n_cands']} "
            f"candidates, {MIND_SERVE_CALLS} calls: p50 {row['p50_ms']:.3f} "
            f"ms p99 {row['p99_ms']:.3f} ms, {row['per_s']:.4g} {unit}/s, "
            f"peak device memory {row['peak_gb']:.2f} GB; {len(users)} "
            f"users against float64, max abs err {row['max_abs_err']:.3g}")
        if check.bad:
            raise AssertionError(f"phase 11 {name}: scores != float64 "
                                 f"({check.rows})")
        del b, scores, hist, mask, cands, emb, cand
    out["serve"] = serve
    del params
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 11 ({card}): {out['wall_s']:.1f} s")
    return out


# --- phase 12: the GNN family and the neighbour sampler ----------------------

GNN_ARCHS = ("schnet", "dimenet", "mace", "graphcast")
GNN_RUN_SHAPES = ("minibatch_lg", "molecule")
GNN_STEPS = 8
GNN_LR = 1e-3              # tests/test_models_smoke.py::test_gnn_smoke_train
#: Card against CPU at full width on `molecule`: max |card − CPU| over the
#: tensor's largest |CPU value|, for the forward output and each gradient,
#: and the loss's relative error. Float32 sums over widths up to 1,536 in
#: another order (cuBLAS; the card's scatter-add atomics): ≈ 1e-6–1e-5
#: expected, 10× that allowed.
GNN_CARD_TOL = 1e-4
#: GraphCast's gradients: its 16 layers at outputs of ≈ 1e6–1e7 amplify
#: float32 rounding, on each device against the float64 recomputation
#: (logged as `grad_cpu_f64` and `grad_card_f64`; on a cut shape,
#: tests/test_torch_gnn.py::test_graphcast_full_width_float32_rounding),
#: so card and CPU lie farther apart than the other archs do.
GNN_GRAD_TOL = {"graphcast": 1e-3}
#: MACE's outputs after a rotation of the positions, over their largest
#: |value| (the reference test's 1e-4).
GNN_ROTATION_TOL = 1e-4
#: Archs whose loss need not fall at lr 1e-3 at full width: GraphCast's
#: 16 residual sum-aggregation layers of width 512 (no normalisation, as
#: in the reference) give outputs of ≈ 1e6–1e7 at init, and 8 AdamW steps
#: then drive the loss up or down with the init, in `repro` as in the
#: port (tests/test_torch_gnn.py::test_graphcast_full_width_diverges_as_
#: reference). Their losses must stay finite and equal those of the same
#: steps on the CPU from the same params and batch, the first
#: `GNN_CPU_STEPS[shape]` of them, within `GNN_UNSTABLE_RTOL` (the tolerance
#: between the reference and the port in that test: the growth amplifies
#: rounding).
GNN_UNSTABLE = {"graphcast"}
GNN_CPU_STEPS = {"molecule": GNN_STEPS, "minibatch_lg": 2}
GNN_UNSTABLE_RTOL = 1e-2
SAMPLER_SEEDS = 1024
SAMPLER_FANOUTS = (15, 10)
SAMPLER_CALLS = 20


def gnn_cell_batch(torch, cfg, shape: str, dev):
    """(config, batch) of the reference's `gnn_cell` for `shape`
    (`src/repro/configs/common.py:163-190`): `d_in` set to the shape's
    `d_feat`, the padded sizes, `tri_cap` = min(4 e2, 2^27), drawn by
    `materialize(..., seed 0)`."""
    from repro_torch.configs import common
    from repro_torch.data import synthetic
    sh = common.GNN_SHAPES[shape]
    cfg = dataclasses.replace(cfg, d_in=sh["d_feat"])
    e2 = sh["e2_pad"]
    layout = synthetic.gnn_layout(cfg.arch, sh["n_pad"], e2, sh["d_feat"],
                                  cfg.d_out, n_graphs=sh.get("n_graphs"),
                                  tri_cap=min(4 * e2, 1 << 27))
    return cfg, synthetic.materialize(layout, seed=0, device=dev)


def scaled_err(got, want) -> float:
    """max |got − want| over the largest |want|."""
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def gnn_loss_grads(torch, gnn, params, batch, cfg):
    """(forward output, loss, gradients in the tree's leaf order)."""
    from repro_torch.tree import tree_leaves, tree_map
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.no_grad():
        out = gnn.forward(leaves, batch, cfg)
    loss = gnn.loss_fn(leaves, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                materialize_grads=True)
    return out, loss.detach(), grads


def gnn_init_stats(torch, params) -> dict:
    """Weights times √fan_in (mean ≈ 0, std ≈ 1) and the largest |bias|
    (0)."""
    from repro_torch.tree import tree_leaves
    z, bias = [], 0.0
    for t in tree_leaves(params):
        if t.dim() == 1:
            bias = max(bias, float(t.abs().max()))
        else:
            fan_in = t.shape[-1] if t.dim() == 3 else t.shape[0]
            z.append(t.flatten().float() * fan_in ** 0.5)
    z = torch.cat(z)
    return dict(weights=z.numel(), z_mean=float(z.mean()),
                z_std=float(z.std()), max_abs_bias=bias)


def gnn_card_vs_cpu(torch, np, dev, card) -> dict:
    """Phase 12b: each arch at full width on `molecule`, params from a
    seeded CPU generator copied to the card: forward, loss and every
    gradient against the CPU's; MACE's outputs under a rotation."""
    from repro_torch.configs import common
    from repro_torch.models import gnn
    from repro_torch.tree import tree_map
    rows, bad = {}, []
    for arch in GNN_ARCHS:
        cfg, b_cpu = gnn_cell_batch(torch, common.get_arch(arch)
                                    .model_config(), "molecule", "cpu")
        p_cpu = gnn.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        o_c, l_c, g_c = gnn_loss_grads(torch, gnn, p_cpu, b_cpu, cfg)
        o_d, l_d, g_d = gnn_loss_grads(torch, gnn, p_dev, b_dev, cfg)
        # The float64 recomputation, on the card.
        o_w, l_w, g_w = gnn_loss_grads(
            torch, gnn, tree_map(torch.Tensor.double, p_dev),
            {k: v.double() if v.is_floating_point() else v
             for k, v in b_dev.items()},
            dataclasses.replace(cfg, dtype=torch.float64))
        used = [i for i, c in enumerate(g_c) if c.abs().max() > 0]
        row = dict(forward=scaled_err(o_d, o_c),
                   loss=abs(float(l_d) - float(l_c)) / abs(float(l_c)),
                   grad=max(scaled_err(g_d[i], g_c[i]) for i in used),
                   forward_card_f64=scaled_err(o_d, o_w),
                   forward_cpu_f64=scaled_err(o_c, o_w),
                   grad_card_f64=max(scaled_err(g_d[i], g_w[i])
                                     for i in used),
                   grad_cpu_f64=max(scaled_err(g_c[i], g_w[i])
                                    for i in used),
                   leaves=len(g_c), zero_grad_leaves=len(g_c) - len(used),
                   zero_grads_equal=all(not a.any() and not w.any() for
                                        a, c, w in zip(g_d, g_c, g_w)
                                        if not c.any()))
        row["grad_tol"] = GNN_GRAD_TOL.get(arch, GNN_CARD_TOL)
        ok = max(row["forward"], row["loss"], row["forward_card_f64"],
                 row["forward_cpu_f64"]) <= GNN_CARD_TOL \
            and max(row["grad"], row["grad_card_f64"],
                    row["grad_cpu_f64"]) <= row["grad_tol"] \
            and row["zero_grads_equal"]
        if arch == "mace":
            q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            rot = dict(b_dev)
            rot["positions"] = b_dev["positions"] @ torch.from_numpy(
                q.astype(np.float32)).to(dev)
            with torch.no_grad():
                row["rotation"] = scaled_err(gnn.forward(p_dev, rot, cfg),
                                             o_d)
            ok = ok and row["rotation"] <= GNN_ROTATION_TOL
        rows[arch] = row
        if not ok:
            bad.append(arch)
    log(f"phase 12b ({card}): card against the CPU at full width on "
        f"molecule, and each against a float64 recomputation on the card "
        f"(*_f64) (max error over the largest |value|, limit "
        f"{GNN_CARD_TOL}, GraphCast's gradients {GNN_GRAD_TOL['graphcast']};"
        f" MACE's rotation, limit {GNN_ROTATION_TOL}): "
        f"{rows}")
    if bad:
        raise AssertionError(f"phase 12b: the card disagrees with the CPU "
                             f"(or MACE with its rotation) on {bad}")
    return rows


def gnn_train(torch, np, dev, card, arch: str, shape: str) -> dict:
    """Phase 12a for one (arch, shape): init statistics, then `GNN_STEPS`
    steps at full width. Fails on bad init statistics, non-finite or
    non-falling losses (for `GNN_UNSTABLE`, losses off the CPU's), or a
    host sync in the last step."""
    from repro_torch.configs import common
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts
    from repro_torch.tree import tree_leaves, tree_map
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, batch = gnn_cell_batch(torch, common.get_arch(arch).model_config(),
                                shape, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    params = gnn.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    init = gnn_init_stats(torch, params)
    if abs(init["z_mean"]) > 0.01 or abs(init["z_std"] - 1) > 0.01 or \
            init["max_abs_bias"] != 0:
        raise AssertionError(f"phase 12 {arch} {shape}: init statistics "
                             f"{init}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    unstable = arch in GNN_UNSTABLE
    if unstable:
        p_cpu = tree_map(lambda t: t.cpu(), params)
    opt = opt_lib.AdamWConfig(lr=GNN_LR)
    state, run = timed_train(torch, lambda p, b: gnn.loss_fn(p, b, cfg),
                             tts.init_train_state(params, opt), batch, opt,
                             GNN_STEPS, GNN_STEPS)
    del params, state
    if unstable:
        t0 = time.perf_counter()
        run["cpu_losses"] = gnn_cpu_losses(
            torch, gnn, p_cpu, {k: v.cpu() for k, v in batch.items()}, cfg,
            GNN_CPU_STEPS[shape])
        run["cpu_s"] = time.perf_counter() - t0
        del p_cpu
    del batch
    later = slice(1, None)
    # The optimiser's least bytes: p, g, m, v read and p, m, v written.
    nbytes = 7 * 4 * n_params
    run.update(shape=shape, data_s=data_s, init=init, n_params=n_params,
               step_ms_p50=statistics.median(run["step_ms"][later]),
               opt_ms_p50=statistics.median(run["opt_ms"][later]),
               fwd_bwd_ms_p50=statistics.median(
                   s - o for s, o in zip(run["step_ms"][later],
                                         run["opt_ms"][later])),
               opt_bytes=nbytes)
    run["opt_bound_ms"], run["opt_bound_by"] = bound_ms(nbytes, 0)
    sh = common.GNN_SHAPES[shape]
    losses = run["losses"]
    log(f"phase 12 train {arch} {shape} ({card}): {sh['n_pad']} nodes, "
        f"{sh['e2_pad']} edges, d_in {cfg.d_in}, {n_params} params; "
        f"{GNN_STEPS} steps lr {GNN_LR}: losses "
        f"{[float(f'{x:.6g}') for x in losses]}; step p50 "
        f"{run['step_ms_p50']:.2f} ms (fwd+bwd {run['fwd_bwd_ms_p50']:.2f}, "
        f"optimiser {run['opt_ms_p50']:.3f} ms against a "
        f"{run['opt_bound_ms']:.4f} ms bound); host syncs in step "
        f"{GNN_STEPS}: {run['host_syncs']}; peak device memory "
        f"{run['peak_gb']:.2f} GB; batch drawn in {data_s:.1f} s; init "
        f"{init}")
    if unstable:
        run["cpu_loss_err"] = max(abs(a - b) / abs(b) for a, b in
                                  zip(losses, run["cpu_losses"]))
        log(f"phase 12 train {arch} {shape}: the loss "
            f"{'falls' if losses[-1] < losses[0] else 'rises'} (need not "
            f"fall at this width, in the reference too); the first "
            f"{len(run['cpu_losses'])} losses against the CPU's "
            f"{[float(f'{x:.6g}') for x in run['cpu_losses']]} from the same "
            f"params (relative {run['cpu_loss_err']:.3g}, limit "
            f"{GNN_UNSTABLE_RTOL}; the CPU took {run['cpu_s']:.1f} s)")
        ok = run["cpu_loss_err"] <= GNN_UNSTABLE_RTOL
    else:
        ok = losses[-1] < losses[0]
    if not all(np.isfinite(losses)) or not ok:
        raise AssertionError(f"phase 12 {arch} {shape}: losses {losses}")
    if run["host_syncs"]:
        raise AssertionError(f"phase 12 {arch} {shape}: a train step synced "
                             f"the host {run['host_syncs']} times")
    return run


def gnn_cpu_losses(torch, gnn, params, batch, cfg, k: int) -> list:
    """The first `k` losses of phase 12a's train steps, on the CPU from
    `params`: `k` − 1 steps, then the loss they leave."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts
    opt = opt_lib.AdamWConfig(lr=GNN_LR)
    step = tts.make_generic_train_step(lambda p, b: gnn.loss_fn(p, b, cfg),
                                       opt)
    state, losses = tts.init_train_state(params, opt), []
    for _ in range(k - 1):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    with torch.no_grad():
        losses.append(float(gnn.loss_fn(state["params"], batch, cfg)))
    return losses


def run_gnn(torch, np, dev, card) -> dict:
    """Phase 12a/b: the card against the CPU, then every (arch, shape)'s
    train steps."""
    t_phase = time.perf_counter()
    out = {"card": card, "card_vs_cpu": gnn_card_vs_cpu(torch, np, dev, card),
           "train": {}}
    for arch in GNN_ARCHS:
        for shape in GNN_RUN_SHAPES:
            torch.cuda.empty_cache()
            out["train"][f"{arch} {shape}"] = gnn_train(torch, np, dev, card,
                                                        arch, shape)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 12a/b ({card}): {out['wall_s']:.1f} s")
    return out


def run_sampler(torch, np, dev, card, edges, lab) -> dict:
    """Phase 12c: `build_csr` of phase 3's graph and `sample_subgraph`
    from `SAMPLER_SEEDS` seeds with `SAMPLER_FANOUTS`, uniform and biased
    by closeness to the landmarks (−min over landmarks of `lab.dist`, the
    prior of `examples/gnn_demo.py:46-55`). Every masked-in neighbour must
    be an edge of the CSR, the shapes `minibatch_lg`'s, the masks right,
    and the biased samples no farther from the landmarks on average."""
    from repro_torch.configs import common
    from repro_torch.graphs import sampler
    from repro_torch.graphs.coo import INF_D
    t_phase = time.perf_counter()
    n = lab.dist.shape[1]
    t0 = time.perf_counter()
    csr = sampler.build_csr(n, edges, device=dev)
    torch.cuda.synchronize()
    out = {"card": card, "build_csr_s": time.perf_counter() - t0,
           "seeds": SAMPLER_SEEDS, "fanouts": list(SAMPLER_FANOUTS)}
    # The CSR's edges as sorted keys u·n + v, for the membership check.
    deg = (csr.indptr[1:] - csr.indptr[:-1]).long()
    keys = torch.sort(torch.repeat_interleave(
        torch.arange(n, device=dev), deg) * n + csr.indices.long()).values
    seeds = torch.from_numpy(np.random.default_rng(12).choice(
        n, SAMPLER_SEEDS, replace=False).astype(np.int32)).to(dev)
    near = lab.dist.min(0).values
    closeness = -near.float()
    sh = common.GNN_SHAPES["minibatch_lg"]
    for name, bias in (("uniform", None), ("biased", closeness)):
        layers, (src, dst, mask) = sampler.sample_subgraph(
            csr, seeds, SAMPLER_FANOUTS,
            torch.Generator(device=dev).manual_seed(0), bias)
        gen = torch.Generator(device=dev).manual_seed(1)

        def call():
            return sampler.sample_subgraph(csr, seeds, SAMPLER_FANOUTS, gen,
                                           bias)
        ms = cuda_ms(call, SAMPLER_CALLS)
        syncs = host_syncs(torch, call)
        nodes = sum(int(l[0].numel()) for l in layers)
        width, want_shapes = SAMPLER_SEEDS, []
        for f in (1,) + SAMPLER_FANOUTS:
            width *= f
            want_shapes.append((width,))
        shapes_ok = (
            [tuple(l[0].shape) for l in layers] == want_shapes
            and [tuple(l[1].shape) for l in layers] == want_shapes
            and src.shape == dst.shape == mask.shape
            == (sum(w[0] for w in want_shapes[1:]),))
        # Masks: hop h's entry is set iff its parent was and has an edge.
        masks_ok, parent, parent_mask = True, seeds, layers[0][1]
        for (nodes_h, mask_h), f in zip(layers[1:], SAMPLER_FANOUTS):
            want = ((deg[parent.long()] > 0) & parent_mask)[:, None] \
                .expand(-1, f).reshape(-1)
            masks_ok &= bool(torch.equal(mask_h, want)) and \
                not bool(nodes_h[~mask_h].any())
            parent, parent_mask = nodes_h, mask_h
        q = dst.long() * n + src.long()
        at = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
        not_edges = int((mask & (keys[at] != q)).sum())
        d = near[src[mask].long()].double()
        row = dict(ms=ms, host_syncs=syncs, nodes=nodes,
                   edges=int(src.numel()), masked_in=int(mask.sum()),
                   not_edges=not_edges, shapes_ok=shapes_ok,
                   masks_ok=masks_ok,
                   mean_landmark_dist=float(d.mean()),
                   unreachable=int((d >= INF_D).sum()))
        out[name] = row
        log(f"phase 12c sampler {name} ({card}): {SAMPLER_SEEDS} seeds, "
            f"fanouts {SAMPLER_FANOUTS}: {nodes} nodes, {row['edges']} "
            f"sampled edges ({row['masked_in']} masked in, {not_edges} not "
            f"an edge of the CSR); shapes {'static' if shapes_ok else 'WRONG'}"
            f", masks {'right' if masks_ok else 'WRONG'}; {ms:.3f} ms per "
            f"call ({SAMPLER_CALLS} calls, CUDA events), {syncs} host syncs;"
            f" mean landmark distance {row['mean_landmark_dist']:.4f}")
        if not (shapes_ok and masks_ok and not not_edges
                and nodes == sh["n_nodes"] and row["edges"] == sh["n_edges"]):
            raise AssertionError(f"phase 12c: sampler {name}: {row}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 12c ({card}): build_csr of {n} vertices and "
        f"{2 * len(edges)} directed edges {out['build_csr_s']:.2f} s; mean "
        f"landmark distance biased {out['biased']['mean_landmark_dist']:.4f}"
        f" against uniform {out['uniform']['mean_landmark_dist']:.4f}; "
        f"phase {out['wall_s']:.1f} s")
    if out["biased"]["mean_landmark_dist"] > \
            out["uniform"]["mean_landmark_dist"]:
        raise AssertionError("phase 12c: the biased samples lie farther from "
                             "the landmarks than the uniform ones")
    return out


# --- phase 13: the transformer LMs at full width -----------------------------

LM_ARCHS = ("gemma2-9b", "minitron-4b", "granite-8b", "deepseek-v2-lite-16b",
            "mixtral-8x22b")
#: Layers kept of the full config where the whole does not fit one card:
#: Mixtral's 56 layers hold 2.504 B params each (281 GB in bfloat16); 8 of
#: them with the embedding and the head are 40.9 GB.
LM_DEPTH = {"mixtral-8x22b": 8}
LM_CUT_LAYERS = 2          # 13a's bfloat16 check (DeepSeek: 1 dense + 1 MoE)
LM_CUT_TOKENS = (2, 64)
LM_FORCED = (2, 16)        # teacher-forced decode: batch, tokens
LM_GEN = (2, 16, 8)        # generate: batch, prompt, new tokens
LM_GEN_AGREE = 0.75        # tests/test_models_smoke.py::test_generate_loop
LM_NO_DROP = 16.0          # capacity factor of 13a's decode checks: no drops
LM_SERVE_GB = 68.0         # weights + cache of a decode batch
LM_MAX_BATCH = 128         # decode_32k's batch in configs/common.py
LM_DECODE_STEPS = 16
LM_LONG = ("deepseek-v2-lite-16b",)
LM_LONG_STEPS = 4
LM_TRAIN_ARCH = "minitron-4b"
LM_TRAIN_BATCH = 2         # cut from train_4k's 256
LM_TRAIN_STEPS = 6
LM_REDUCED_STEPS = 2
LM_BF16_PEAK = 989.4e12    # H100 SXM dense bfloat16, FLOP/s
#: 13a, bfloat16 against the float32 recomputation of the same params on
#: the card: relative L2 errors ‖bf16 − f32‖ / ‖f32‖. bfloat16 keeps 8
#: significant bits (unit roundoff 2^-9 = 2.0e-3 by rounding to nearest);
#: two layers round each activation a few times, so the logits and each
#: gradient may lie a few roundoffs away. 2^-5 = 3.1e-2 for the logits
#: and the gradients; the loss, a mean over 128 tokens, 2^-8. The
#: float32 run routes each MoE token to the bfloat16 run's experts
#: (`ReplayRoute`), so a near-tie of the router does not count here.
LM_BF16_TOL = {"logits": 2.0 ** -5, "loss": 2.0 ** -8, "grad": 2.0 ** -5}
#: 13a at full depth, teacher-forced decode against forward (two bfloat16
#: paths through every layer, each rounding in its own order): 2^-4.
LM_FORCED_TOL = 2.0 ** -4
#: 13a, reduced configs in float32, the card against the CPU: forward and
#: each gradient within 1e-4 of the tensor's largest |value| (float32 sums
#: in another order, as phase 12's GNN_CARD_TOL), losses rtol 1e-5.
LM_CARD_TOL = {"fwd": 1e-4, "grad": 1e-4, "loss": 1e-5}


def lm_config(arch: str, **changes):
    from repro_torch.configs import common
    cfg = common.get_arch(arch).model_config()
    if arch in LM_DEPTH and "n_layers" not in changes:
        changes["n_layers"] = LM_DEPTH[arch]
    return dataclasses.replace(cfg, **changes)


def rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖, the squares summed in float64 over slices
    of 2^26 elements on the tensors' device (a whole float64 copy of
    Mixtral's expert leaves would not fit beside them)."""
    num = den = 0.0
    for g, w in zip(got.detach().reshape(-1).split(1 << 26),
                    want.detach().reshape(-1).split(1 << 26)):
        w = w.double()
        num += float(((g.double() - w) ** 2).sum())
        den += float((w * w).sum())
    return (num / max(den, 1e-300)) ** 0.5


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_loss_grads(torch, tfm, params, tokens, cfg):
    """(loss, gradients in the tree's leaf order) of `chunked_loss` with
    targets = tokens."""
    from repro_torch.tree import tree_leaves, tree_map
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = tfm.chunked_loss(leaves, tokens, tokens, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), list(grads)


class ReplayRoute:
    """Wraps `models.moe.route`: in "record" mode keeps each call's expert
    ids; in "replay" mode gives the recorded ids back, call by call, with
    the gates of this run's own router probabilities at them, and counts
    the tokens whose free choice would have been another set of experts.
    The bfloat16 and float32 runs of 13a make the same calls in the same
    order, so the float32 recomputation routes each token to the experts
    the bfloat16 run chose: at random init the router's probabilities
    are near uniform, and a rounding-sized change flips near-ties among
    64 experts, which would move whole expert gradients."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.real = torch, moe, moe.route
        self.ids, self.mode, self.tokens, self.flipped = [], "record", 0, 0

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def __call__(self, p, xt, c):
        torch = self.torch
        if self.mode == "record":
            gates, ids = self.real(p, xt, c)
            self.ids.append(ids)
            return gates, ids
        ids = self.ids.pop(0)
        _, free = self.real(p, xt, c)
        self.tokens += ids.shape[0] * ids.shape[1]
        self.flipped += int((torch.sort(free, -1).values
                             != torch.sort(ids, -1).values).any(-1).sum())
        probs = torch.softmax(torch.matmul(xt.float(), p["router"].float()),
                              dim=-1)
        gates = torch.gather(probs, -1, ids)
        return gates / torch.clamp(torch.sum(gates, -1, keepdim=True),
                                   min=1e-9), ids


def lm_bf16_check(torch, np, dev, card, arch) -> dict:
    """13a: the full-width config cut to `LM_CUT_LAYERS` layers, bfloat16
    against a float32 recomputation from the same params on the card,
    which routes each MoE token as the bfloat16 run did (`ReplayRoute`)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    cfg = lm_config(arch, n_layers=LM_CUT_LAYERS)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, LM_CUT_TOKENS).astype(np.int32)).to(dev)
    with ReplayRoute(torch, moe) as routes:
        with torch.no_grad():
            logits = tfm.forward(params, toks, cfg)
        loss, grads = lm_loss_grads(torch, tfm, params, toks, cfg)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = tree_map(lambda p: p.float(), params)
        del params
        routes.mode = "replay"
        with torch.no_grad():
            logits32 = tfm.forward(p32, toks, cfg32)
        loss32, grads32 = lm_loss_grads(torch, tfm, p32, toks, cfg32)
    names = leaf_names(p32)
    row = dict(layers=LM_CUT_LAYERS, tokens=list(LM_CUT_TOKENS),
               logits=rel_l2(logits, logits32),
               loss=abs(float(loss) - float(loss32)) / abs(float(loss32)),
               loss_bf16=float(loss), loss_f32=float(loss32),
               grad={n: rel_l2(g, g32) for n, g, g32 in zip(names, grads,
                                                           grads32)},
               routed_tokens=routes.tokens,
               route_flips=routes.flipped / max(routes.tokens, 1),
               finite=bool(torch.isfinite(logits).all()) and all(
                   bool(torch.isfinite(g).all()) for g in grads))
    row["grad_max"] = max(row["grad"].values())
    row["ok"] = (row["finite"] and row["logits"] <= LM_BF16_TOL["logits"]
                 and row["loss"] <= LM_BF16_TOL["loss"]
                 and row["grad_max"] <= LM_BF16_TOL["grad"])
    worst = max(row["grad"], key=row["grad"].get)
    flips = (f"; float32's free routing would move "
             f"{row['route_flips']:.1%} of {routes.tokens} routed tokens"
             if routes.tokens else "")
    log(f"phase 13a {arch} bf16 vs float32 ({card}; {LM_CUT_LAYERS} layers, "
        f"tokens {LM_CUT_TOKENS}): logits rel err {row['logits']:.3e}, loss "
        f"{row['loss']:.3e} ({row['loss_bf16']:.5f} vs {row['loss_f32']:.5f}),"
        f" gradients max rel err {row['grad_max']:.3e} ({worst}); limits "
        f"{LM_BF16_TOL}{flips}")
    del p32, grads, grads32, logits, logits32
    return row


def leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in `tree_leaves` order, joined by '/'."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def lm_reduced_check(torch, np, dev, arch) -> dict:
    """13a: the reduced config in float32, the card against the CPU:
    forward, loss and gradients, 4 decode steps, and `LM_REDUCED_STEPS`
    train steps (microbatched for one arch)."""
    from repro_torch.configs import common
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as tts
    from repro_torch.tree import tree_map
    cfg = common.get_arch(arch).reduced_config()
    p_cpu = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    out = {}
    res = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        p = tree_map(lambda t: t.to(d), p_cpu)
        t = toks.to(d)
        with torch.no_grad():
            fwd = tfm.forward(p, t, cfg)
        loss, grads = lm_loss_grads(torch, tfm, p, t, cfg)
        cache = ss.make_cache(cfg, 4, 32, device=d)
        dec = [tfm.decode_step(p, cache, t[:, i:i + 1], i, cfg)[0]
               for i in range(4)]
        opt = opt_lib.AdamWConfig(lr=3e-3)
        micro = 2 if arch == LM_TRAIN_ARCH else None
        step = tts.make_lm_train_step(cfg, opt, microbatch=micro)
        state = tts.init_train_state(tree_map(torch.clone, p), opt)
        losses = []
        for _ in range(LM_REDUCED_STEPS):
            state, aux = step(state, {"tokens": t, "targets": t})
            losses.append(aux["loss"])
        res[name] = (fwd, loss, grads, torch.stack(dec, 1),
                     torch.stack(losses))
    c, k = res["cpu"], res["card"]
    out["fwd"] = scaled_err(k[0], c[0])
    out["decode"] = scaled_err(k[3], c[3])
    out["grad"] = max(scaled_err(a, b) for a, b in zip(k[2], c[2]))
    out["loss"] = max(float(((k[4].cpu() - c[4]).abs() / c[4].abs()).max()),
                      abs(float(k[1]) - float(c[1])) / abs(float(c[1])))
    out["microbatch"] = arch == LM_TRAIN_ARCH
    out["ok"] = (out["fwd"] <= LM_CARD_TOL["fwd"]
                 and out["decode"] <= LM_CARD_TOL["fwd"]
                 and out["grad"] <= LM_CARD_TOL["grad"]
                 and out["loss"] <= LM_CARD_TOL["loss"])
    return out


def decode_batch(cfg, weights: int, max_len: int) -> int:
    """The largest power of two ≤ `LM_MAX_BATCH` whose cache at `max_len`
    and the weights fit in `LM_SERVE_GB`."""
    from repro_torch.models import transformer as tfm
    per_seq = tree_bytes(tfm.cache_shapes(cfg, 1, max_len))
    b = 1
    while 2 * b <= LM_MAX_BATCH and weights + 2 * b * per_seq \
            <= LM_SERVE_GB * 1e9:
        b *= 2
    return b


def fill_cache(torch, cache, upto: int, gen) -> None:
    """Entries [0, upto) of every cache leaf [L, B, S, ...] from N(0, 1)."""
    from repro_torch.tree import tree_leaves
    for leaf in tree_leaves(cache):
        for layer in leaf:
            layer[:, :upto].normal_(generator=gen)


def decode_bytes(tfm, cfg, params, batch: int, n_valid: int,
                 experts: list) -> int:
    """The bytes a decode step of `batch` tokens must move with `n_valid`
    cache entries: every weight but the embedding table, of which the
    batch's rows; of MoE layer i's routed experts only the `experts[i]`
    its tokens chose; each layer's valid cache entries, a sliding-window
    layer's at most `window` of them; the logits written."""
    def size(a):
        return a.numel() * a.element_size()
    n = sum(size(a) for k, a in params.items()
            if k not in ("embed", "dense_layers", "moe_layers"))
    n += batch * size(params["embed"][0])
    n += sum(size(a) for a in params.get("dense_layers", {}).values())
    for k, a in params.get("moe_layers", {}).items():
        if k in ("w_gate", "w_up", "w_down"):   # [L, E, ...]
            n += sum(size(a[0]) // cfg.n_experts * used for used in experts)
        else:
            n += size(a)
    per_entry = tree_bytes(tfm.cache_shapes(cfg, batch, 1)) // cfg.n_layers
    n += per_entry * sum(min(n_valid, cfg.window) if local else n_valid
                         for local in tfm._is_local_flags(cfg, cfg.n_layers,
                                                          0))
    return n + batch * cfg.vocab * params["lm_head"].element_size()


def lm_decode_run(torch, np, dev, params, cfg, batch: int, ctx: int,
                  steps: int) -> dict:
    """One untimed warm-up step, then `steps` greedy decode steps after a
    cache of `ctx` entries from a seeded normal draw, at max_len ctx +
    512: ms per step by CUDA events (p50 and p99 over the timed steps),
    host syncs of the middle step, peak GB, and the middle step's bytes
    bound (`decode_bytes`, its experts read off its routes)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.train import serve_step as ss
    max_len = ctx + 512
    torch.cuda.reset_peak_memory_stats()
    cache = ss.make_cache(cfg, batch, max_len, device=dev)
    fill_cache(torch, cache, ctx, torch.Generator(device=dev).manual_seed(1))
    decode = ss.make_decode_step(cfg)
    tok = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (batch, 1)).astype(np.int32)).to(dev)
    logits, cache = decode(params, cache, tok, ctx)          # warm-up
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    ms, syncs, finite, mid = [], None, True, steps // 2
    for i in range(steps):
        pos = ctx + 1 + i
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        if i == mid:
            box, where = [], []
            with ReplayRoute(torch, moe) as routes:
                syncs = host_syncs(torch, lambda: box.append(
                    decode(params, cache, tok, pos)), where)
            logits, cache = box[0]
        else:
            logits, cache = decode(params, cache, tok, pos)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        ev[1].record()
        ms.append(ev)
        finite &= bool(torch.isfinite(logits).all()) if i == steps - 1 \
            else True
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ms]
    experts = [int(torch.unique(ids).numel()) for ids in routes.ids]
    nbytes = decode_bytes(tfm, cfg, params, batch, ctx + 2 + mid, experts)
    row = dict(batch=batch, ctx=ctx, max_len=max_len, steps=steps, ms=ms,
               p50_ms=percentile(ms, 0.5), p99_ms=percentile(ms, 0.99),
               host_syncs=syncs, sync_sources=where, finite=finite,
               logits_shape=list(logits.shape), experts_read=experts,
               cache_gb=tree_bytes(cache) / 1e9,
               weights_gb=tree_bytes(params) / 1e9,
               bound_gb=nbytes / 1e9,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    row["tokens_per_s"] = batch / (row["p50_ms"] / 1e3)
    del cache
    return row


def lm_serve(torch, np, dev, card, arch) -> dict:
    """13a at full depth (teacher-forced decode against forward, greedy
    generate twice and against forward's argmax) and 13b (prefill_32k,
    decode_32k, long_500k where it fits) on one model."""
    from repro_torch.configs import common
    from repro_torch.models import transformer as tfm
    from repro_torch.train import serve_step as ss
    cfg = lm_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    out = dict(layers=cfg.n_layers, full_layers=common.get_arch(
        arch).model_config().n_layers, params=cfg.params_count,
        weights_gb=tree_bytes(params) / 1e9,
        init_s=time.perf_counter() - t0)

    # --- 13a at full depth ---------------------------------------------------
    nd = dataclasses.replace(cfg, capacity_factor=LM_NO_DROP)
    rng = np.random.default_rng(16)
    b, s = LM_FORCED
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        full = tfm.forward(params, toks, nd)
    cache = ss.make_cache(nd, b, nd.kv_chunk, device=dev)
    dec = torch.stack([tfm.decode_step(params, cache, toks[:, i:i + 1], i,
                                       nd)[0] for i in range(s)], 1)
    del cache
    forced = rel_l2(dec, full)
    b, s, n_new = LM_GEN
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    g1 = ss.generate(params, nd, prompt, n_new, temperature=0.0)
    g2 = ss.generate(params, nd, prompt, n_new, temperature=0.0)
    with torch.no_grad():
        greedy = torch.argmax(tfm.forward(params, g1[:, :-1], nd)[:, s - 1:],
                              dim=-1)
    agree = float((greedy == g1[:, s:]).float().mean())
    out["check"] = dict(forced_rel_err=forced, forced_tol=LM_FORCED_TOL,
                        generate_equal=bool(torch.equal(g1, g2)),
                        generate_agree=agree, agree_min=LM_GEN_AGREE)
    log(f"phase 13a {arch} full depth ({cfg.n_layers} layers, {card}): "
        f"teacher-forced decode vs forward rel err {forced:.3e} (limit "
        f"{LM_FORCED_TOL:.3e}); greedy generate twice equal "
        f"{out['check']['generate_equal']}, agreement with forward's argmax "
        f"{agree:.3f} (min {LM_GEN_AGREE})")
    if not (forced <= LM_FORCED_TOL and out["check"]["generate_equal"]
            and agree >= LM_GEN_AGREE):
        raise AssertionError(f"phase 13a {arch}: {out['check']}")
    del full, dec, g1, g2, greedy

    # --- 13b: prefill_32k, one sequence --------------------------------------
    sh = common.LM_SHAPES["prefill_32k"]
    torch.cuda.reset_peak_memory_stats()
    cache = ss.make_cache(cfg, 1, sh["seq"], device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, sh["seq"])).astype(
        np.int32)).to(dev)
    prefill = ss.make_prefill_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    logits, cache = prefill(params, cache, toks)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    out["prefill_32k"] = dict(
        batch=1, seq=sh["seq"], ms=ms, tokens_per_s=sh["seq"] / (ms / 1e3),
        finite=bool(torch.isfinite(logits).all()),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        model_tflop=2 * cfg.active_params_count * sh["seq"] / 1e12)
    del cache, logits
    torch.cuda.empty_cache()
    log(f"phase 13b {arch} prefill_32k ({card}): 1 x {sh['seq']} tokens in "
        f"{ms:.1f} ms, one call, the first at this shape ({out['prefill_32k']['tokens_per_s']:.0f} tokens/s), "
        f"peak {out['prefill_32k']['peak_gb']:.2f} GB")

    # --- 13b: decode_32k and long_500k ---------------------------------------
    for shape, steps in (("decode_32k", LM_DECODE_STEPS),
                         ("long_500k", LM_LONG_STEPS)):
        if shape == "long_500k" and arch not in LM_LONG:
            continue
        ctx = common.LM_SHAPES[shape]["seq"]
        batch = decode_batch(cfg, tree_bytes(params), ctx + 512)
        if shape == "long_500k":
            batch = common.LM_SHAPES[shape]["batch"]
        row = lm_decode_run(torch, np, dev, params, cfg, batch, ctx, steps)
        out[shape] = row
        torch.cuda.empty_cache()
        log(f"phase 13b {arch} {shape} ({card}): B {batch}, cache "
            f"{row['cache_gb']:.2f} GB at max_len {row['max_len']}, "
            f"{steps} greedy steps after a warm-up step: p50 "
            f"{row['p50_ms']:.2f} ms p99 {row['p99_ms']:.2f} ms, "
            f"{row['tokens_per_s']:.1f} tokens/s; bytes bound "
            f"{row['bound_ms']:.2f} ms ({row['bound_gb']:.2f} GB, routed "
            f"experts read {row['experts_read']}); {row['host_syncs']} host "
            f"syncs in a step {row['sync_sources']}; peak "
            f"{row['peak_gb']:.2f} GB")
        if not row["finite"] or row["logits_shape"] != [batch, cfg.vocab]:
            raise AssertionError(f"phase 13b {arch} {shape}: {row}")
    if not out["prefill_32k"]["finite"]:
        raise AssertionError(f"phase 13b {arch}: prefill logits not finite")
    del params
    torch.cuda.empty_cache()
    return out


def lm_train_flops(cfg, seq: int) -> float:
    """Model FLOPs a trained token (PaLM, arXiv:2204.02311, App. B): 6
    a weight that enters a product (all but the input embedding table,
    a lookup) and 12·L·H·d_head·seq for the attention's scores and
    values, forward and backward, the causal mask not halving it."""
    return (6 * (cfg.params_count - cfg.vocab * cfg.d_model)
            + 12 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq)


def lm_train(torch, np, dev, card) -> dict:
    """13c: `LM_TRAIN_STEPS` steps of `make_lm_train_step` on the full
    minitron-4b at train_4k's sequence, batch `LM_TRAIN_BATCH`."""
    from repro_torch.configs import common
    from repro_torch.launch.train import synth_lm_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts
    cfg = lm_config(LM_TRAIN_ARCH)
    seq = common.LM_SHAPES["train_4k"]["seq"]
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    opt = opt_lib.AdamWConfig()
    state = tts.init_train_state(params, opt)
    batch = synth_lm_batch(0, LM_TRAIN_BATCH, seq, cfg.vocab, device=dev)
    step = tts.make_lm_train_step(cfg, opt)
    opt_events: list = []
    real_update = opt_lib.adamw_update_

    def timed_update(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_update(*args, **kw)
        ev[1].record()
        opt_events.append(ev)
        return res

    ev, losses, syncs, peak = [], [], None, []
    opt_lib.adamw_update_ = timed_update
    try:
        for i in range(LM_TRAIN_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            if i + 1 == LM_TRAIN_STEPS:
                box, where = [], []
                syncs = host_syncs(torch, lambda: box.append(
                    step(state, batch)), where)
                state, aux = box[0]
            else:
                state, aux = step(state, batch)
            e[1].record()
            ev.append(e)
            losses.append(aux["loss"])
            torch.cuda.synchronize()
            peak.append(torch.cuda.max_memory_allocated() / 1e9)
    finally:
        opt_lib.adamw_update_ = real_update
    step_ms = [a.elapsed_time(b) for a, b in ev]
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    from repro_torch.tree import tree_leaves
    n = sum(p.numel() for p in tree_leaves(state["params"]))
    tokens = LM_TRAIN_BATCH * seq
    med = statistics.median(step_ms[1:])
    opt_med = statistics.median(opt_ms[1:])
    # AdamW reads p, g, m, v and writes p, m, v: 2 + 2 + 4 + 4 + 2 + 4 + 4
    # bytes a bfloat16 param.
    opt_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                    for p in tree_leaves(state["params"]))
    out = dict(arch=LM_TRAIN_ARCH, batch=LM_TRAIN_BATCH, seq=seq,
               steps=LM_TRAIN_STEPS, params=n,
               losses=[float(x) for x in losses], step_ms=step_ms,
               opt_ms=opt_ms, step_ms_median=med, opt_ms_median=opt_med,
               fwd_bwd_ms=med - opt_med,
               opt_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
               mfu=6 * cfg.params_count * tokens / (med / 1e3) / LM_BF16_PEAK,
               mfu_palm=lm_train_flops(cfg, seq) * tokens / (med / 1e3)
               / LM_BF16_PEAK,
               tokens_per_s=tokens / (med / 1e3), host_syncs=syncs,
               sync_sources=where, step_peak_gb=peak, peak_gb=max(peak))
    log(f"phase 13c train {LM_TRAIN_ARCH} ({card}): B {LM_TRAIN_BATCH} x "
        f"{seq}, {n} params: losses {[round(x, 4) for x in out['losses']]}; "
        f"step {med:.1f} ms (median of 2-{LM_TRAIN_STEPS}), fwd+bwd "
        f"{out['fwd_bwd_ms']:.1f} ms, optimiser {opt_med:.2f} ms (bound "
        f"{out['opt_bound_ms']:.2f}); mfu {out['mfu']:.3f} (6·N), "
        f"{out['mfu_palm']:.3f} (6·N without the embedding table + "
        f"attention); "
        f"{syncs} host syncs in step {LM_TRAIN_STEPS} {where}; peak "
        f"{out['peak_gb']:.2f} GB")
    if not all(np.isfinite(out["losses"])) or syncs:
        raise AssertionError(f"phase 13c: {out}")
    del state, params, batch
    torch.cuda.empty_cache()
    return out


def run_lm(torch, np, dev, card) -> dict:
    """Phase 13: the five LMs, one model at a time (13a, 13b), then
    minitron-4b's train steps (13c)."""
    t_phase = time.perf_counter()
    out = {"card": card, "bf16": {}, "reduced": {}, "serve": {}}
    for arch in LM_ARCHS:
        red = lm_reduced_check(torch, np, dev, arch)
        out["reduced"][arch] = red
        log(f"phase 13a {arch} reduced float32, card against the CPU "
            f"({card}): forward {red['fwd']:.2e}, decode {red['decode']:.2e},"
            f" gradients {red['grad']:.2e} (of the largest |value|), losses "
            f"{red['loss']:.2e} (relative)"
            f"{'; microbatched' if red['microbatch'] else ''}")
        if not red["ok"]:
            raise AssertionError(f"phase 13a {arch} reduced: {red}")
    for arch in LM_ARCHS:
        row = lm_bf16_check(torch, np, dev, card, arch)
        out["bf16"][arch] = row
        torch.cuda.empty_cache()
        if not row["ok"]:
            raise AssertionError(f"phase 13a {arch}: bfloat16 against float32"
                                 f" past its limits: {row}")
    for arch in LM_ARCHS:
        out["serve"][arch] = lm_serve(torch, np, dev, card, arch)
    out["train"] = lm_train(torch, np, dev, card)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13 ({card}): {out['wall_s']:.1f} s")
    return out


# --- phase 14: the BatchHL cells and the dry run -----------------------------

BHL_10K = 5120          # inserts and deletions of update_10k
BHL_QUERY_STEPS = 16    # the query cells' max_steps (configs/batchhl.py)
#: One cell per family for the dry run's FLOPs pass on meta tensors.
DRYRUN_FLOPS_CELLS = (("minitron-4b", "decode_32k"), ("schnet", "molecule"),
                      ("mind", "serve_p99"))


def bhl_cell_run(torch, cell, args) -> tuple:
    """One call of a BatchHL cell's step with the launch and wave counts
    set to 0 just before: (outputs, row of seconds, peak, launches)."""
    from repro_torch.core import engine as teng
    reset_launches()
    teng.WAVES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cell.step_fn(*args)
    torch.cuda.synchronize()
    row = dict(step_s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               waves=dict(teng.WAVES), launches=read_launches())
    return out, row


def run_batchhl_cells(torch, np, dev, card, edges, g0, lab0, batch, full,
                      answers, qs, qt) -> dict:
    """Phase 14: the five cells of `configs/batchhl.py` built by
    `configs.common.build_cell("batchhl", shape, pod=False)` and their
    `step_fn`s called on phase 3's graph (BA(2^20, 4), capacity 2^23, 32
    landmarks: the cells' `model_config`), each held to phase 3, the COO
    path or scipy BFS; then the dry run's bytes pass over every cell and
    its FLOPs pass on one cell per family."""
    from repro_torch.configs import batchhl as bhl
    from repro_torch.configs import common as cc
    from repro_torch.core import batch as tbat
    from repro_torch.graphs import coo
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.coo import INF_D
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    c = bhl.model_config()
    if (c.n_vertices, 2 * c.edge_cap, c.n_landmarks) != (
            g0.n, g0.src.shape[0], lab0.dist.shape[0]):
        raise AssertionError(f"phase 14: {c} is not phase 3's width")
    g1, lab1, aff1 = full
    cells = {name: cc.build_cell("batchhl", name, pod=False)
             for name in bhl.SHAPES}

    def fields(x, names):
        return {f: getattr(x, f) for f in names}
    gf = ("src", "dst", "valid", "w")
    lf = ("landmarks", "dist", "hub", "highway")
    bf = ("src", "dst", "is_del", "valid", "w", "is_rew")
    rows = {}

    def check(name, a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 14 {name}: {what} differs")

    # construct: max_iters = 64 must not bind (6 waves on BA(2^20, 4)).
    out, rows["construct"] = bhl_cell_run(
        torch, cells["construct"], (fields(g0, gf), lab0.landmarks))
    for f in lf:
        check("construct", out[f], getattr(lab0, f), f"{f} against phase 3")
    waves = rows["construct"]["waves"].get("construct", 0)
    if waves >= 64:
        raise AssertionError(f"phase 14 construct: max_iters bound ({waves})")
    del out

    # update_1k: phase 3's 512 + 512 rows.
    out, rows["update_1k"] = bhl_cell_run(
        torch, cells["update_1k"],
        (fields(g0, gf), fields(batch, bf), fields(lab0, lf)))
    for f in gf:
        check("update_1k", out[0][f], getattr(g1, f), f"{f} against phase 3")
    for f in lf:
        check("update_1k", out[1][f], getattr(lab1, f), f"{f} against phase 3")
    if int(out[2]) != int(aff1.sum()):
        raise AssertionError("phase 14 update_1k: aff.sum() != phase 3's")
    rows["update_1k"]["affected"] = int(out[2])
    del out

    # update_10k: 5120 + 5120 rows by seed, against the COO path and BFS.
    ups = gen.random_batch_updates(edges, g0.n, n_ins=BHL_10K, n_del=BHL_10K,
                                   seed=4)
    b10 = coo.make_batch(ups, pad_to=2 * BHL_10K, device=dev)
    free = int((~g0.valid).sum()) // 2
    out, rows["update_10k"] = bhl_cell_run(
        torch, cells["update_10k"],
        (fields(g0, gf), fields(b10, bf), fields(lab0, lf)))
    t0 = time.perf_counter()
    g_ref, lab_ref, aff_ref = tbat.batchhl_update(g0, b10, lab0,
                                                  improved=c.improved,
                                                  plan=None)
    torch.cuda.synchronize()
    coo_s = time.perf_counter() - t0
    for f in gf:
        check("update_10k", out[0][f], getattr(g_ref, f), f"{f} against COO")
    for f in lf:
        check("update_10k", out[1][f], getattr(lab_ref, f),
              f"{f} against COO")
    if int(out[2]) != int(aff_ref.sum()):
        raise AssertionError("phase 14 update_10k: aff.sum() != COO path's")
    g10 = coo.Graph(n=g0.n, **out[0])
    t0 = time.perf_counter()
    lm = lab0.landmarks.cpu().numpy()
    want = bfs_dist(csr_of(g10, np), lm, np, INF_D)
    if not np.array_equal(out[1]["dist"].cpu().numpy(), want):
        raise AssertionError("phase 14 update_10k: dist != scipy BFS")
    rows["update_10k"].update(affected=int(out[2]), free_slots=free,
                              coo_s=coo_s,
                              bfs_s=time.perf_counter() - t0)
    del out, g_ref, lab_ref, aff_ref, g10, want

    # query_1k and query_1k_repl: phase 3's 1024 queries in one call.
    q = {"s": torch.from_numpy(qs).to(dev), "t": torch.from_numpy(qt).to(dev)}
    got = {}
    for name in ("query_1k", "query_1k_repl"):
        got[name], rows[name] = bhl_cell_run(
            torch, cells[name], (fields(g1, gf), fields(lab1, lf), q))
    check("query_1k_repl", got["query_1k_repl"], got["query_1k"],
          "answers against query_1k")
    exact = answers[:len(qs)]
    if exact.shape[0] != got["query_1k"].shape[0]:
        raise AssertionError("phase 14: phase 3 answered fewer queries "
                             f"({exact.shape[0]}) than the cell's 1024")
    if bool((got["query_1k"] < exact).any()):
        raise AssertionError("phase 14 query_1k: an answer below phase 3's")
    differ = int((got["query_1k"] != exact).sum())
    q_waves = rows["query_1k"]["waves"].get("bibfs", 0)
    if differ and q_waves < BHL_QUERY_STEPS:
        raise AssertionError(f"phase 14 query_1k: {differ} answers differ "
                             f"from phase 3's after {q_waves} waves")
    rows["query_1k"].update(differ=differ, bibfs_waves=q_waves)
    del got

    for name, row in rows.items():
        la = row["launches"]
        if la["relax_sweep"] <= 0 or (name.startswith("query")
                                      and la["minplus"] <= 0):
            raise AssertionError(f"phase 14 {name}: launches {la}")
        log(f"phase 14 {name} ({card}): step {row['step_s']:.3f} s, peak "
            f"{row['peak_gb']:.2f} GB, waves {row['waves']}, launches A "
            f"{la['relax_sweep']} B {la['minplus']}")
    log(f"phase 14: construct == phase 3's labelling in "
        f"{rows['construct']['waves'].get('construct')} waves (max_iters 64);"
        f" update_1k == phase 3's update (aff {rows['update_1k']['affected']})"
        f"; update_10k ({BHL_10K} + {BHL_10K} rows, {free} free slots) == "
        f"the COO path ({coo_s:.3f} s) and scipy BFS; query_1k == "
        f"query_1k_repl, {differ} of 1024 differ from phase 3's exact "
        f"answers after {q_waves} waves")

    # The dry run: bytes over every cell and mesh, FLOPs on one per family.
    t0 = time.perf_counter()
    dry, fails = [], []
    for arch in cc.ALL_ARCHS + ("batchhl",):
        for shape in cc.arch_shapes(arch):
            for multi in (False, True):
                try:
                    dry.append(dryrun.run_cell(arch, shape, multi,
                                               flops=False))
                except Exception as e:  # noqa: BLE001 — counted, then fatal
                    fails.append(f"{arch}/{shape}/{multi}: {e!r}")
    bytes_s = time.perf_counter() - t0
    if fails or len(dry) != 90:
        raise AssertionError(f"phase 14 dry run: {len(dry)} records, "
                             f"failures {fails}")
    flops = {}
    for arch, shape in DRYRUN_FLOPS_CELLS:
        rec = dryrun.run_cell(arch, shape, False)
        if not rec["cost"]["flops"]:
            raise AssertionError(f"phase 14 dry run: no FLOPs for {arch}/"
                                 f"{shape}")
        flops[f"{arch}/{shape}"] = dict(flops=rec["cost"]["flops"],
                                        seconds=rec["flops_pass_s"])
    upd = next(r for r in dry if (r["arch"], r["shape"], r["mesh"]) == (
        "batchhl", "update_1k", "16x16"))
    if upd["memory"]["argument_bytes"] != 14_306_432:
        raise AssertionError(f"phase 14 dry run: update_1k argument bytes "
                             f"{upd['memory']['argument_bytes']}")
    log(f"phase 14 dry run: {len(dry)} records (45 cells x 2 meshes), 0 "
        f"failures, bytes pass {bytes_s:.2f} s; FLOPs on meta {flops}")
    wall = time.perf_counter() - t_phase
    log(f"phase 14: {wall:.1f} s ({card})")
    return dict(cells=rows, dryrun_records=len(dry), dryrun_bytes_s=bytes_s,
                dryrun_flops=flops, wall_s=wall)


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
    clock = PhaseClock()
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
    clock.done("1")

    # --- 2. kernels against plain versions -----------------------------------
    cases = check_kernels_small(torch, np, dev)
    log(f"phase 2: {cases} kernel cases equal their plain versions (and "
        "the sorted impl equals kernel A on every relax-sweep case)")
    clock.done("2")

    # --- 11. MIND and the training substrate (first, on the empty card) ------
    reset_launches()
    mind_row = run_mind(torch, np, dev, card)
    mind_row["launches"] = read_launches()
    if any(mind_row["launches"].values()):
        raise AssertionError(f"phase 11: MIND launched a hand-written "
                             f"kernel: {mind_row['launches']}")
    clock.done("11")

    # --- 12a/b. the GNN family (next, while the card is empty) ---------------
    reset_launches()
    gnn_row = run_gnn(torch, np, dev, card)
    gnn_row["launches"] = read_launches()
    if any(gnn_row["launches"].values()):
        raise AssertionError(f"phase 12a/b: a GNN launched a hand-written "
                             f"kernel: {gnn_row['launches']}")
    clock.done("12a/b")

    # --- 13. the transformer LMs (next, while the card is empty) -------------
    reset_launches()
    lm_row = run_lm(torch, np, dev, card)
    lm_row["launches"] = read_launches()
    if any(lm_row["launches"].values()):
        raise AssertionError(f"phase 13: an LM launched a hand-written "
                             f"kernel: {lm_row['launches']}")
    clock.done("13")

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
                if k in ("relax_sweep", "minplus", "seed_match")}
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
    clock.done("3/4")

    # --- 3. the same update through one destination block (wide mode) -------
    wide_eng = teng.RelaxEngine(block_v=N, block_e=api.BLOCK_E, device=dev)
    wide_out, wide_s, wide_waves, wide_launches = timed_update(
        torch, wide_eng, g0, lab0, batch)
    assert_same_update(torch, wide_out, (g1, lab1, aff1),
                       f"update at block_v={N}")
    if wide_launches["relax_sweep"] <= 0:
        raise AssertionError(f"update at block_v={N} launched no kernel A: "
                             f"{wide_launches}")
    one_block = dict(block_v=N, block_e=api.BLOCK_E,
                     mode=rk.sweep_mode(N), update_s=wide_s,
                     waves=wide_waves, launches=wide_launches)
    del wide_out
    log(f"phase 3 at block_v={N} (one destination block, "
        f"{one_block['mode']} mode, block_e={api.BLOCK_E}): update "
        f"{wide_s:.3f} s, waves {wide_waves}, launches {wide_launches}; "
        f"== phase 3's update on slots, labelling and aff")
    clock.done("3 one-block")

    # --- 14. the BatchHL cells on phase 3's graph, and the dry run ----------
    bhl_row = run_batchhl_cells(torch, np, dev, card, edges, g0, lab0, batch,
                                (g1, lab1, aff1), answers, qs, qt)
    clock.done("14")

    # --- 12c. the neighbour sampler on phase 3's graph -----------------------
    reset_launches()
    sampler_row = run_sampler(torch, np, dev, card, edges, lab1)
    sampler_row["launches"] = read_launches()
    if any(sampler_row["launches"].values()):
        raise AssertionError(f"phase 12c: the sampler launched a hand-written"
                             f" kernel: {sampler_row['launches']}")
    clock.done("12c")

    # --- 3b. the same tick in the frontier mode ------------------------------
    trickle = coo.make_batch(gen.random_batch_updates(
        edges, N, n_ins=TRICKLE, n_del=TRICKLE, seed=3), pad_to=2 * TRICKLE,
        device=dev)
    frontier, fr_engine = run_frontier_update(torch, dev, g0, lab0, batch,
                                              (g1, lab1, aff1), trickle)
    clock.done("3b")

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
    sweep_rows, key2_out = [], None
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
        if name.startswith("construct/repair"):
            key2_out = got    # the key2 wave, for SWEEP_TILINGS
        ms, plain = paired_ms(lambda: rk.relax_sweep(*args),
                              lambda: rk.relax_sweep_plain(*args), 10, 3)
        parts = sweep_split(torch, lambda: rk.relax_sweep(*args),
                            mask.dim() == 2)
        p = keys.shape[0]
        b = sweep_bound(bg, keys, hub, mask, e2)
        sweep_rows.append(dict(wave=name, ms=ms, plain_ms=plain,
                               max_abs_err=err, planes=p, device_ms=parts,
                               **b))
        log(f"relax_sweep {name}: [{p}, {N}] keys, {bg.slots} slots "
            f"({b['live_slots']} live): kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{b['bytes']} needed bytes), padded-tile bound "
            f"{b['padded_bound_ms']:.4f} ms ({b['padded_bytes']} bytes), "
            f"max_abs_err {err}; device ms of one call {parts}")
    del bou_mask, int_mask
    # Kernel A's key2 wave at the wide tilings, held to the one above.
    sweep_tilings = time_sweep_tilings(torch, dev, g1, key2.contiguous(),
                                       hub_mask, wide_eng, key2_out)
    del key2_out, wide_eng

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

    er_row = time_edge_relax(torch, dev, g1, lab1, api.BLOCK_V)
    er_tilings = [time_edge_relax(torch, dev, g1, lab1, bv)
                  for bv in EDGE_RELAX_TILINGS]
    bag_rows = time_embed_bag(torch, dev, floor_us)
    seed_rows = time_seed_match(torch, dev)
    clock.done("5")

    # --- 6. the serving loop at full width ------------------------------------
    serve, serve_base, final_a = run_serve(
        torch, np, dev, g0, lab0, batch, (g1, lab1, aff1), trickle, fr_engine)
    clock.done("6")

    # --- 10. the sharded path on meshes of the one card ---------------------
    # (before phase 7 frees phase 3's state; run A's steps are still on
    # disk until phase 9)
    sharded = run_sharded(torch, np, dev, card, g0, lab0, batch,
                          (g1, lab1, aff1), answers, qs, qt, fr_engine,
                          serve_base)
    clock.done("10")

    # --- 7. directed BatchHL at full width -----------------------------------
    del g1, lab1, aff1, fr_engine, trickle, lab_eff, key2, hub_mask, ds
    directed = run_directed(torch, np, dev, edges)
    clock.done("7")

    # --- 8. the autotuner at full width ---------------------------------------
    autotune = run_autotune(torch, dev, serve_base, final_a)
    del final_a
    clock.done("8")

    # --- 9. the replica tier at full width --------------------------------------
    try:
        replica_tier = run_replica(torch, np, dev, serve_base)
    except BaseException:
        dump_role_logs(REPLICA_DIR / "logs")
        raise
    clock.done("9")

    # --- 15. the kernels line and the summary --------------------------------
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
        dict(name="seed_match", route="cuda",
             source="src/repro_torch/csrc/seed_match.cu",
             replaces=None,   # the reference matches in jnp
             launches=serve["pipeline"]["launches"]["seed_match"],
             max_abs_err=0, ms=seed_rows[0]["ms"],
             plain_ms=seed_rows[0]["plain_ms"],
             bound_ms=seed_rows[0]["bound_ms"],
             bound_by=seed_rows[0]["bound_by"], library_ms=None),
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
                   relax_sweep=sweep_rows, relax_sweep_tilings=sweep_tilings,
                   one_block_update=one_block, query_profile=q_prof,
                   minplus=mp_rows, frontier=frontier, edge_relax=er_row,
                   edge_relax_tilings=er_tilings, embed_bag=bag_rows,
                   seed_match=seed_rows,
                   serve=serve, directed=directed, autotune=autotune,
                   replica=replica_tier, sharded=sharded, mind=mind_row,
                   gnn=gnn_row, sampler=sampler_row, lm=lm_row,
                   batchhl_cells=bhl_row,
                   profiler_short_passes=short_passes, phase_s=clock.s,
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
