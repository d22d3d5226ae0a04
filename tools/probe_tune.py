#!/usr/bin/env python3
"""What each autotuner candidate costs at full width, on one GPU.

    python3 tools/probe_tune.py [--log2n 20] [--iters 3]

The serve loop's tuner (`repro_torch.core.autotune`) measures kernel A
under each launch shape of the reference's grid (block_v 128, 256, 512 ×
block_e None, 1024) against the `sorted` impl. With block_e None a tiling
pads every row to the widest destination block, which on a power-law
graph is most of the tile. This probe takes the graph chip_smoke's serve
loop runs (Barabási–Albert(2^log2n, m=4, seed 0), capacity edges + 64 +
1536 slot pairs) and, for each candidate in turn:

  host_s            the host tiling and its copy to the card (what a
                    retile of the serve loop costs under that winner)
  host_peak_bytes   the peak of numpy's allocations during it (tracemalloc)
  tile_slots        the tiling's slots, padding included
  device_bytes      the tiling's bytes on the card
  device_peak_bytes peak device memory over the tiling and the timed waves
  compile_us        the first wave (the kernel is built before the loop)
  steady_us         the min of `--iters` waves after one warm-up

each candidate's tiling freed before the next is built. Then it runs
`autotune.tune` itself once: its winner, wall seconds and peak device
memory. Prints the card's name and power limit first, one JSON line per
candidate and one for the tune. Exits nonzero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
import tracemalloc
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_tune: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    from repro_torch.core import autotune as at
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.coo import from_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_relax import ops as er_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << args.log2n
    t0 = time.perf_counter()
    edges = gen.barabasi_albert(n, 4, seed=0)
    g = from_edges(n, edges, len(edges) + 64 + 1536, device=dev)
    print(f"graph: BA({n}, 4) {len(edges)} edges, {g.src.shape[0]} slots "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    keys, hub = at._sweep_inputs(g, 8)
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    keep = g.valid.cpu().numpy()

    for cfg in at.candidate_space(1, 512, include_kernel=True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tracemalloc.start()
        t0 = time.perf_counter()
        if cfg.impl == "sorted":
            tiles = er_ops.prepare_sorted(src, dst, keep, n, device=dev)
            parts = (tiles.src_s, tiles.dst_s, tiles.perm_s)
            slots = tiles.src_s.numel()

            def wave(ks, hb, m, sg=tiles):
                return er_ops.relax_sweep_sorted(ks, sg, m, 2, at.INF32,
                                                 clear_bit=1, hub=hb, w=g.w)
        else:
            tiles = er_ops.prepare_topology(src, dst, keep, n, cfg.block_v,
                                            cfg.tile_shards, cfg.block_e,
                                            device=dev)
            parts = (tiles.src_t, tiles.dstloc_t, tiles.perm_t,
                     tiles.slot_t, tiles.rowblk_t)
            slots = tiles.slots

            def wave(ks, hb, m, bg=tiles):
                return er_ops.relax_sweep(ks, bg, m, 2, at.INF32,
                                          clear_bit=1, hub=hb, w=g.w)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in parts)
        host_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        compile_us, steady_us = at.measure_compiled(
            wave, keys, hub, g.valid, warmup=1, iters=args.iters)
        row = dict(impl=cfg.impl, block_v=cfg.block_v, block_e=cfg.block_e,
                   tile_shards=cfg.tile_shards, host_s=host_s,
                   host_peak_bytes=host_peak, tile_slots=slots,
                   device_bytes=nbytes,
                   device_peak_bytes=torch.cuda.max_memory_allocated(dev)
                   - base, compile_us=compile_us, steady_us=steady_us)
        print(json.dumps(row), flush=True)
        del tiles, parts, wave
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res = at.tune(g, shards=1, block_v=512)
    print(json.dumps(dict(
        tune_winner=res.config.to_dict(), steady_us=res.steady_us,
        coo_us=res.jnp_us, wall_s=res.wall_s,
        device_peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
        host_maxrss_kb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        candidates=[(c.to_dict(), cu, su) for c, cu, su in res.candidates])),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
