"""Kernel autotuner: pick the fastest sweep implementation per snapshot shape.

The port of `repro.core.autotune`. A relaxation wave can run two ways:

    impl="kernel"  kernel A (`csrc/relax_sweep.cu`) on a destination-block
                   tiling, whose launch shape has three knobs: `block_v`
                   (destination-block tile), `block_e` (tile-row width
                   cap; None pads every row to the widest block) and
                   `tile_shards` (the tiles' leading axis);
    impl="sorted"  `ops.relax_sweep_sorted`: PyTorch ops over the occupied
                   slots sorted by destination (gather, saturating add,
                   hub clear, mask, scatter-min).

Every candidate gives the same planes bit for bit
(`tests/test_torch_autotune.py` holds each config this module may emit
to the COO path and to `repro`), so the choice is one of speed
alone: measure each candidate's steady sweep time on the snapshot and
keep the fastest. Kernel candidates are measured only where the graph is
on a CUDA device; on the CPU the kernel's plain twin would be measured,
which says nothing of the kernel, and the only candidate is `sorted`.

Timing: the first call is timed apart as `compile_us` (on the card it may
include kernel A's lazy `nvcc` build), then `warmup` calls are discarded,
then `steady_us` is the min of `iters` calls, the device synchronised
around each timed call. The tiling is host work the tuner does not time,
as in the reference; each candidate's tiling is freed before the next is
built, so the tune holds one candidate's tiles at a time.

Winners are kept in a `TuneTable` keyed by `(n, slot count, shards)`:
the snapshot's shape, not its contents. Edge churn at a fixed shape
keeps the winner; growth changes the key and tunes again. The table is
the reference's JSON, byte for byte, so a table written by either
package loads in the other (`jnp_us` there is the COO path's time here).

    PYTHONPATH=src python -m repro_torch.core.autotune --device cpu \\
        --n 2000 --table /tmp/tuning.json

Without `--device` it tunes on the GPU and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.labelling import sat_add
from repro_torch.device import resolve_device
from repro_torch.graphs.segment import masked_segment_min
from repro_torch.kernels.edge_relax import ops as er_ops

INF32 = 1 << 29

#: Kernel-impl candidate grid (the reference's). Small on purpose: each
#: candidate costs a retile and k timed sweeps, and the table amortizes
#: them per shape.
KERNEL_BLOCK_V = (128, 256, 512)
KERNEL_BLOCK_E = (None, 1024)


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One point of the candidate space (hashable, JSON-able).

    `frontier_threshold` is the frontier mode's density knob, tuned apart
    by `tune_frontier_threshold`; None leaves the engine's as it is.
    """
    impl: str                 # "kernel" | "sorted"
    block_v: int              # destination-block tile (kernel impl)
    block_e: int | None       # tile-row width cap; None = widest block
    tile_shards: int          # leading axis of the tiling
    frontier_threshold: float | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.frontier_threshold is None:
            del d["frontier_threshold"]
        return d

    @staticmethod
    def from_dict(d: dict) -> "TuneConfig":
        ft = d.get("frontier_threshold")
        return TuneConfig(impl=d["impl"], block_v=int(d["block_v"]),
                          block_e=(None if d.get("block_e") is None
                                   else int(d["block_e"])),
                          tile_shards=int(d["tile_shards"]),
                          frontier_threshold=(None if ft is None
                                              else float(ft)))


@dataclasses.dataclass(frozen=True)
class TuneResult:
    config: TuneConfig
    steady_us: float          # winner's min-of-k steady latency
    compile_us: float         # winner's first-call latency
    jnp_us: float             # the COO path's steady latency, same wave
    candidates: tuple         # ((config, compile_us, steady_us), ...)
    wall_s: float = 0.0       # the whole tune, host tiling included


def table_key(n: int, capacity: int, shards: int) -> str:
    """Tuning-table key: the snapshot's shape. It leaves out the edge
    checksum the plan cache keys on, so a winner survives edge churn at a
    fixed shape, but never growth."""
    return f"n={n},cap={capacity},s={shards}"


def candidate_space(shards: int = 1, block_v: int = 512,
                    include_kernel: bool | None = None, *,
                    device: str | torch.device | None = None
                    ) -> list[TuneConfig]:
    """Every config the tuner may emit for an engine at (shards, block_v).

    `include_kernel=None` resolves to "`device` is a CUDA device" (None
    is the GPU, as everywhere in the port): on the CPU the kernel impl
    runs its plain twin, whose time says nothing of the kernel.
    """
    if include_kernel is None:
        include_kernel = resolve_device(device).type == "cuda"
    cands = [TuneConfig("sorted", block_v, None, shards)]
    if include_kernel:
        for bv in KERNEL_BLOCK_V:
            for be in KERNEL_BLOCK_E:
                for ts in sorted({1, shards}):
                    cands.append(TuneConfig("kernel", bv, be, ts))
    return cands


def _wait(x) -> None:
    """Synchronise the CUDA device of `x` (a tensor or a sequence of
    them), if it has one."""
    for t in (x if isinstance(x, (list, tuple)) else (x,)):
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def measure_compiled(fn, *args, warmup: int = 1,
                     iters: int = 5) -> tuple[float, float]:
    """(compile_us, steady_us) of fn(*args): the first call timed apart,
    then `warmup` discarded calls, then the min of `iters` timed calls;
    the device is synchronised before each clock is read."""
    _wait(args)
    t0 = time.perf_counter()
    _wait(fn(*args))
    compile_us = (time.perf_counter() - t0) * 1e6
    for _ in range(warmup):
        _wait(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return compile_us, best * 1e6


def _sweep_inputs(g, r_planes: int, seed: int = 0):
    """The measured wave's keys [r_planes, n] and hub [r_planes, n]: the
    reference's numpy draws, on g's device."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 * g.n, (r_planes, g.n), np.int64).astype(np.int32)
    hub = rng.random((r_planes, g.n)) < 0.02
    return (torch.from_numpy(keys).to(g.device),
            torch.from_numpy(hub).to(g.device))


def _coo_wave(g, inf: int):
    """The COO path's key2 wave (step 2, hub clear) of all planes."""
    src = g.src.to(torch.int64)
    dst = g.dst.to(torch.int64)

    def wave(ks, hb, m):
        cand = sat_add(ks[:, src], 2 * g.w, inf)
        cand = torch.where(hb[:, dst], cand & ~1, cand)
        return masked_segment_min(cand, g.dst, g.n, m, inf)
    return wave


def tune(g, *, shards: int = 1, block_v: int = 512, r_planes: int = 8,
         include_kernel: bool | None = None, warmup: int = 1,
         iters: int = 3, inf: int = INF32) -> TuneResult:
    """Measure every candidate on snapshot `g`; return the steady winner
    and the COO path's time for the same wave.

    The measured wave is the production one: a key2 sweep (step 2, hub
    clear) of `r_planes` landmark planes under the snapshot's live mask.
    """
    t_start = time.perf_counter()
    if include_kernel is None:
        include_kernel = g.device.type == "cuda"
    keys, hub = _sweep_inputs(g, r_planes)
    mask = g.valid
    _, jnp_us = measure_compiled(_coo_wave(g, inf), keys, hub, mask,
                                 warmup=warmup, iters=iters)

    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    keep = g.valid.cpu().numpy()
    measured = []
    for cfg in candidate_space(shards, block_v, include_kernel):
        if cfg.impl == "sorted":
            tiles = er_ops.prepare_sorted(src, dst, keep, g.n,
                                          device=g.device)

            def wave(ks, hb, m, sg=tiles):
                return er_ops.relax_sweep_sorted(ks, sg, m, 2, inf,
                                                 clear_bit=1, hub=hb, w=g.w)
        else:
            tiles = er_ops.prepare_topology(
                src, dst, keep, g.n, block_v=cfg.block_v,
                shards=cfg.tile_shards, block_e=cfg.block_e,
                device=g.device)

            def wave(ks, hb, m, bg=tiles):
                return er_ops.relax_sweep(ks, bg, m, 2, inf, clear_bit=1,
                                          hub=hb, w=g.w)
        compile_us, steady_us = measure_compiled(wave, keys, hub, mask,
                                                 warmup=warmup, iters=iters)
        measured.append((cfg, compile_us, steady_us))
        # Free this candidate's tiles before the next one is built.
        del tiles, wave

    best_cfg, best_compile, best_steady = min(measured, key=lambda t: t[2])
    return TuneResult(config=best_cfg, steady_us=best_steady,
                      compile_us=best_compile, jnp_us=jnp_us,
                      candidates=tuple(measured), wall_s=time.perf_counter() - t_start)


#: Candidate grid for the frontier mode's density-fallback knob.
FRONTIER_THRESHOLDS = (0.0625, 0.125, 0.25, 0.5)


def tune_frontier_threshold(g, *, fblock: int = 64, r_planes: int = 8,
                            warmup: int = 1, iters: int = 3,
                            inf: int = INF32,
                            thresholds=FRONTIER_THRESHOLDS) -> float:
    """Pick the frontier mode's density-fallback threshold for g's shape.

    Measures the full COO wave against the masked wave over the gathered
    rows at each candidate fraction (rows_cap = ceil(threshold · NR)
    rows) and returns the largest candidate whose masked wave is still
    faster; the smallest when masking never wins. The math is
    `engine.relax_rows`, written out here: this module must not import
    the engine, which imports it.
    """
    keys, hub = _sweep_inputs(g, r_planes)
    mask = g.valid
    _, full_us = measure_compiled(_coo_wave(g, inf), keys, hub, mask,
                                  warmup=warmup, iters=iters)

    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    keep = g.valid.cpu().numpy()
    p = keys.shape[0]
    best = min(thresholds)
    for th in sorted(thresholds):
        ft = er_ops.prepare_frontier(src, dst, keep, g.n, fblock,
                                     threshold=th, device=g.device)
        # The budget spent in full on real rows: the worst case at the
        # threshold.
        ridx = torch.arange(ft.rows_cap, device=g.device) % max(ft.nrows, 1)

        def masked_wave(ks, hb, m, ft=ft, ridx=ridx):
            src_g, dstg, perm_g, slot_g = ft.gather(ridx)
            src_g, dstg = src_g.to(torch.int64), dstg.to(torch.int64)
            perm_g = perm_g.to(torch.int64)
            emask = slot_g & m[perm_g]
            w_g = torch.where(slot_g, g.w[perm_g], 0)
            cand = sat_add(ks[:, src_g], 2 * w_g, inf)
            cand = torch.where(hb[:, dstg], cand & ~1, cand)
            cand = torch.where(emask, cand, inf)
            return ks.scatter_reduce(1, dstg.reshape(1, -1).expand(p, -1),
                                     cand.reshape(p, -1), "amin")

        _, masked_us = measure_compiled(masked_wave, keys, hub, mask,
                                        warmup=warmup, iters=iters)
        if masked_us < full_us:
            best = max(best, th)
    return best


class TuneTable:
    """On-disk (n, slot count, shards) → winning TuneConfig map.

    `path=None` keeps the table in memory only. Every `put` rewrites the
    whole JSON file (the reference's format: version 1, the same entry
    fields and rounding) to a temporary name and renames it, so a crash
    never leaves a truncated table.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        if path and os.path.exists(path):
            self.load(path)

    def load(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        self.entries = dict(doc.get("entries", {}))

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if not path:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": self.entries}, f, indent=1)
        os.replace(tmp, path)

    def get(self, key: str) -> TuneConfig | None:
        ent = self.entries.get(key)
        return TuneConfig.from_dict(ent["config"]) if ent else None

    def put(self, key: str, result: TuneResult) -> None:
        self.entries[key] = {
            "config": result.config.to_dict(),
            "steady_us": round(result.steady_us, 1),
            "compile_us": round(result.compile_us, 1),
            "jnp_us": round(result.jnp_us, 1),
        }
        self.save()

    def __len__(self) -> int:
        return len(self.entries)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Tune the sweep on a synthetic BA snapshot and persist "
                    "the winner.")
    ap.add_argument("--n", type=int, default=2_000)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--extra-capacity", type=int, default=448)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--block-v", type=int, default=256)
    ap.add_argument("--r-planes", type=int, default=8)
    ap.add_argument("--table", default="experiments/tuning.json")
    ap.add_argument("--tune-frontier", action="store_true",
                    help="also tune the frontier mode's density-fallback "
                         "threshold and persist it with the winner")
    ap.add_argument("--device", default=None,
                    help="torch device to tune on (default: the GPU; "
                         "'cpu' measures the sorted impl alone)")
    args = ap.parse_args(argv)

    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.coo import from_edges

    device = resolve_device(args.device)
    edges = gen.barabasi_albert(args.n, args.deg, seed=0)
    g = from_edges(args.n, edges, edges.shape[0] + args.extra_capacity,
                   device=device)
    res = tune(g, shards=args.shards, block_v=args.block_v,
               r_planes=args.r_planes)
    if args.tune_frontier:
        th = tune_frontier_threshold(g, r_planes=args.r_planes)
        res = dataclasses.replace(
            res, config=dataclasses.replace(res.config,
                                            frontier_threshold=th))
        print(f"frontier_threshold={th}")
    table = TuneTable(args.table)
    key = table_key(g.n, int(g.src.shape[0]), args.shards)
    table.put(key, res)
    speedup = res.jnp_us / res.steady_us if res.steady_us else float("inf")
    print(f"{key} [{device}]: winner={res.config.to_dict()} "
          f"steady={res.steady_us:.1f}us coo={res.jnp_us:.1f}us "
          f"({speedup:.2f}x) -> {args.table}")
    for cfg, cus, sus in res.candidates:
        print(f"  cand impl={cfg.impl} bv={cfg.block_v} be={cfg.block_e} "
              f"ts={cfg.tile_shards}: steady={sus:.1f}us "
              f"compile={cus:.1f}us")


if __name__ == "__main__":
    main()
