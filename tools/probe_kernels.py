#!/usr/bin/env python3
"""Where kernels B and C spend their time, on one GPU.

    python3 tools/probe_kernels.py

Kernel C (`csrc/edge_relax.cu`): builds variants of the source with nvcc
into `build/probe/` and times each with CUDA events (the better of two
runs of 20 calls; every variant is then timed again in reverse order) on
the tiling that `chip_smoke.py` phase 5 times: `ops.prepare` of every
slot of BA(2^20, m=4) at capacity 2^23, block_v 512, block_e 4096. The
variants change one thing each: 1 or 4 quads of slots per thread instead
of 2, 128 or 512 threads per CTA instead of 256, no key gather (the key
is taken from the source id), every gather from the first 16 KB of keys
(L1-resident) or the first 512 KB (L2-resident, past L1), no shared
atomicMin (the tile is left as filled). The last four compute something
else; they show what the part they change costs.

Kernel B (`minplus`): the host microseconds per call of the wrapper and
of its parts (`torch.empty`, the stream lookup, the launch geometry, the
argument checks), timed over 2000 calls at B = 32, P = R = 32, beside a
one-element `fill_`.

Prints the card's name and power limit first. Exits nonzero without a
CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 20
CAPACITY = 1 << 23
BLOCK_V, BLOCK_E = 512, 4096


def variants(src: str) -> dict[str, str]:
    def sub(old: str, new: str, text: str = src) -> str:
        if old not in text:
            raise RuntimeError(f"edge_relax.cu no longer holds {old!r}")
        return text.replace(old, new)
    gather = "key[q][k] = lane_of(vq[q], k) ? keys[lane_of(sq[q], k)] : 0;"
    atomic = "atomicMin(&tile[lane_of(dq[q], k)], cand);"
    return {
        "as built": src,
        "1 quad": sub("kQuads = 2;", "kQuads = 1;"),
        "4 quads": sub("kQuads = 2;", "kQuads = 4;"),
        "128 threads": sub("kThreads = 256;", "kThreads = 128;"),
        "512 threads": sub("kThreads = 256;", "kThreads = 512;"),
        "no key gather": sub(gather, "key[q][k] = lane_of(sq[q], k) & 7;"),
        "keys from 16 KB": sub(gather, gather.replace(
            "keys[lane_of(sq[q], k)]", "keys[lane_of(sq[q], k) & 4095]")),
        "keys from 512 KB": sub(gather, gather.replace(
            "keys[lane_of(sq[q], k)]", "keys[lane_of(sq[q], k) & 131071]")),
        "no shared atomic": sub(atomic, "if (cand == n) tile[0] = cand;"),
    }


def event_ms(torch, fn, reps: int = 20) -> float:
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(torch, fn, reps: int = 2000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return dt


def probe_edge_relax(torch, dev) -> None:
    from repro_torch.graphs import coo, generators
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.edge_relax import ops as rops

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "edge_relax.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        cu = out_dir / f"edge_relax_{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        regs = [ln.split(":")[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(f"C build {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(so)).edge_relax_launch
        fn.argtypes = rk._EDGE_RELAX_ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn

    edges = generators.barabasi_albert(N, 4, seed=0)
    g = coo.from_edges(N, edges, CAPACITY, device=dev)
    bg = rops.prepare(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                      g.valid.cpu().numpy(), N, BLOCK_V, 1, BLOCK_E,
                      device=dev)
    keys = torch.randint(0, 64, (N,), dtype=torch.int32, device=dev)
    args = (keys, bg.src_t, bg.dstloc_t, bg.valid_t, bg.rowblk_t, 1, N,
            bg.block_v, bg.nb)
    want = rk.edge_relax_plain(*args)
    s, nr, be = bg.src_t.shape
    print(f"C tiling: {s * nr} rows, {bg.slots} slots, "
          f"{int((bg.valid_t != 0).sum())} valid", flush=True)
    out = torch.empty(N, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn):
        return lambda: fn(keys.data_ptr(), bg.src_t.data_ptr(),
                          bg.dstloc_t.data_ptr(), bg.valid_t.data_ptr(),
                          bg.rowblk_t.data_ptr(), out.data_ptr(), N, s * nr,
                          nr, be, bg.block_v, bg.nb, 1, stream)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            fn = libs[name]
            if call(fn)() != 0:
                raise RuntimeError(f"launch failed: {name}")
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            ms = min(event_ms(torch, call(fn)), event_ms(torch, call(fn)))
            print(f"C {name}: {ms:.4f} ms (equal to plain: {same})",
                  flush=True)
    ms = min(event_ms(torch, lambda: rk.edge_relax(*args)) for _ in range(2))
    print(f"C wrapper rk.edge_relax: {ms:.4f} ms", flush=True)


def probe_minplus_host(torch, dev) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.minplus import kernel as mk

    b = r = 32
    s, h, t = (torch.randint(0, 64, shape, dtype=torch.int32, device=dev)
               for shape in ((b, r), (r, r), (b, r)))
    one = torch.empty(1, dtype=torch.int32, device=dev)
    parts = {
        "minplus wrapper": lambda: mk.minplus(s, h, t),
        "torch.empty": lambda: torch.empty(b, dtype=torch.int32, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "minplus_geometry": lambda: mk.minplus_geometry(r, r),
        "checks": lambda: [(x.dtype != torch.int32, x.device != s.device,
                            x.is_contiguous()) for x in (s, h, t)],
        "build.function": lambda: build.function(
            "minplus", "minplus_launch", mk._ARGTYPES),
        "minplus_plain": lambda: mk.minplus_plain(s, h, t),
        "one-element fill_": lambda: one.fill_(0),
    }
    for name, fn in parts.items():
        print(f"B host us {name}: {host_us(torch, fn):.2f}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    probe_minplus_host(torch, dev)
    probe_edge_relax(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
