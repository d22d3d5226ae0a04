#!/usr/bin/env python3
"""Kernel D (`csrc/embed_bag.cu`) at the MIND widths, on one GPU.

    python3 tools/probe_embed_bag.py [--src DIR]... [--rounds K]

For each `--src` (a `src/` directory holding `repro_torch`; default this
checkout's), in that order, a child process builds kernel D from that
tree and times its wrapper `kernels.embed_bag.kernel.embed_bag` on the
inputs `chip_smoke.py` phase 5 times (table 10,485,760 × 64 float32 from
`torch.Generator(device).manual_seed(0)`, bags of 50, batches of 512 and
65,536, ~80 % of the slots kept with mean weights, as `ops.embed_bag`
hands them to the kernel). Per batch it prints one JSON line:

- `ms`: CUDA events over a run of calls (the better of two runs, timed
  in turns with the plain version: plain, kernel, kernel, plain), and
  `plain_ms`, `library_ms` (`F.embedding_bag` on the same weights);
- `device_us`: the kernel's own device time per call from
  `torch.profiler`, with the gathered rows warm in L2 (as the event
  loop leaves them) and `cold_device_us` after a 128 MB write between
  calls evicts them; `library_device_us` the same for `F.embedding_bag`;
- `floor_us`: the launch floor, a one-element fill profiled the same
  way; `host_us` (B = 512 only, where the device keeps up): the host µs
  per wrapper call over 2000 calls with no synchronise between them;
- `bound_ms`: bytes this run's data needs (each distinct gathered row
  once, idx and w of every slot, out once) over 3.35 TB/s;
- `geometry`: the launch the wrapper chose, where it has
  `embed_bag_geometry`; `ptxas`: nvcc's register and spill lines.

With `--variants` (this checkout's tree only) each batch also times, by
the same device µs, each pair of a launch geometry (the wrapper's, and
1, 2, 4, 5, 7 or 8 warps a bag) and a build: kernel D as it is, with
another `kUnroll` (row loads a lane issues before its FMAs: 2, 4, 6 or
8), and `tools/probe_embed_bag_ring.cu` (the rows through a cp.async
ring in shared memory, 2, 3 or 4 stages), each held to the plain
version too.

Each child holds the kernel to `embed_bag_plain` at rtol = atol = 1e-5
and two calls to equal bits, and fails otherwise; a variant that differs
from the plain version is reported as such and not timed. `--rounds 2` runs the
list twice, the second time in reverse (A, B, B, A for two trees). Prints
the card's name and power limit first. Exits nonzero without a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITEMS, DIM, HIST = 10_485_760, 64, 50
BATCHES = (512, 65_536)
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12


def event_ms(torch, fn, reps: int) -> float:
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(torch, fn, reps: int = 2000) -> float:
    """Host µs per call of `fn()` over `reps` calls with no synchronise
    between them (what the wrapper costs the CPU, where the device keeps
    up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return dt


def device_us(torch, fn, match: str, reps: int = 20,
              between=None) -> float:
    """Mean device µs per call of the kernels whose name holds `match`,
    over `reps` calls under the profiler; `between()` runs before each
    call and is not counted unless its kernels match. The profiler now
    and then loses device records, so a pass that recorded fewer than
    `reps` matching kernels is run again (three tries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name]
        if len(times) >= reps:
            return sum(times) / reps
    raise RuntimeError(f"profiler lost records of {match!r} three times")


def build_variants(build) -> dict:
    """Kernel D's launch function built with each other `kUnroll`, and the
    cp.async ring of `tools/probe_embed_bag_ring.cu` with 2, 3 and 4
    stages, by nvcc into build/probe/ (all at once): {label: function}."""
    import ctypes
    import re
    from repro_torch.kernels.embed_bag import kernel as ek
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernel_src = (build.CSRC / "embed_bag.cu").read_text()
    ring_src = (ROOT / "tools" / "probe_embed_bag_ring.cu").read_text()
    specs = {f"kUnroll {u}": (kernel_src, "kUnroll", u)
             for u in (2, 4, 6, 8) if u != ek.EMBED_BAG_UNROLL}
    specs.update({f"ring kStages {st}": (ring_src, "kStages", st)
                  for st in (2, 3, 4)})
    procs = {}
    for i, (label, (text, name, value)) in enumerate(specs.items()):
        pat = rf"constexpr int {name} = \d+;"
        if not re.search(pat, text):
            raise RuntimeError(f"no {pat!r} to vary for {label}")
        cu = out_dir / f"embed_bag_v{i}.cu"
        cu.write_text(re.sub(pat, f"constexpr int {name} = {value};", text))
        procs[label] = (cu.with_suffix(".so"), subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        print(f"{label}: " + "; ".join(
            ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        fn = ctypes.CDLL(str(so)).embed_bag_launch
        fn.argtypes = ek._ARGTYPES
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def time_variants(torch, build, ek, table, idx, w, want, variant_fns):
    """Device µs (warm, cold) of kernel D and its variants under each
    geometry, on the wrapper's inputs."""
    b, l = idx.shape
    n, d = table.shape
    sms = torch.cuda.get_device_properties(table.device) \
        .multi_processor_count
    geo = ek.embed_bag_geometry(b, l, d, sms)
    base = build.function("embed_bag", "embed_bag_launch", ek._ARGTYPES)
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    flush = torch.empty(32 << 20, dtype=torch.float32, device=table.device)
    geos = {geo}
    for warps in (1, 2, 4, 5, 7, 8):
        per = -(-l // warps)
        geos.add(dataclasses.replace(geo, warps=-(-l // per), per_warp=per,
                                     bags=max(1, 8 // -(-l // per))))
    fns = {f"kUnroll {ek.EMBED_BAG_UNROLL}": base, **variant_fns}
    cands = [(f"{label} warps {g.warps} bags {g.bags}"
              + (" (as chosen)" if fn is base and g == geo else ""), fn, g)
             for label, fn in fns.items()
             for g in sorted(geos, key=lambda g: g.warps)]
    rows = []
    for label, fn, g in cands:
        def call(fn=fn, g=g):
            err = fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                     out.data_ptr(), n, d, b, l, g.vec, g.lanes, g.groups,
                     g.warps, g.bags, g.per_warp, stream)
            if err:
                raise RuntimeError(f"{label}: CUDA error {err}")
        out.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        if not torch.allclose(out, want, rtol=TOL, atol=TOL):
            rows.append(dict(variant=label, error="differs from plain"))
            continue
        rows.append(dict(variant=label, device_us=device_us(
            torch, call, "embed_bag"), cold_device_us=device_us(
            torch, call, "embed_bag", between=lambda: flush.fill_(1.0))))
    return rows


def child(src: str, variants: bool) -> int:
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.embed_bag import kernel as ek

    dev = torch.device("cuda", torch.cuda.current_device())
    build.build(("embed_bag",))
    ptxas = [ln.strip() for ln in build.build_log.get("embed_bag", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(ITEMS, DIM, generator=gen, device=dev)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    one = torch.empty(1, dtype=torch.int32, device=dev)
    floor = device_us(torch, lambda: one.fill_(0), "")
    variant_fns = build_variants(build) if variants else {}
    for b in BATCHES:
        idx = torch.randint(0, ITEMS, (b, HIST), generator=gen, device=dev,
                            dtype=torch.int32)
        mask = torch.rand(b, HIST, generator=gen, device=dev) < 0.8
        w = mask.to(torch.float32)
        w = w / w.sum(1, keepdim=True).clamp_min(1.0)
        idx = torch.where(mask, idx, 0)
        idx64 = idx.long()
        got = ek.embed_bag(table, idx, w)
        again = ek.embed_bag(table, idx, w)
        want = ek.embed_bag_plain(table, idx, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        if not torch.equal(got, again):
            raise AssertionError(f"B={b}: two calls differ")
        reps = 50 if b <= 512 else 10

        def kern():
            return ek.embed_bag(table, idx, w)

        def plain():
            return ek.embed_bag_plain(table, idx, w)

        def lib():
            return F.embedding_bag(idx64, table, per_sample_weights=w,
                                   mode="sum")
        p1, k1, k2, p2 = (event_ms(torch, plain, 3), event_ms(torch, kern,
                                                                reps),
                          event_ms(torch, kern, reps),
                          event_ms(torch, plain, 3))
        lib_ms = min(event_ms(torch, lib, reps) for _ in range(2))
        distinct = int(torch.unique(idx).numel())
        nbytes = distinct * 4 * DIM + b * HIST * 8 + 4 * b * DIM
        geo = getattr(ek, "embed_bag_geometry", None)
        row = dict(
            src=src, batch=b, ms=min(k1, k2), plain_ms=min(p1, p2),
            library_ms=lib_ms,
            device_us=device_us(torch, kern, "embed_bag"),
            cold_device_us=device_us(torch, kern, "embed_bag",
                                     between=lambda: flush.fill_(1.0)),
            library_device_us=device_us(torch, lib, ""),
            host_us=host_us(torch, kern) if b <= 512 else None,
            floor_us=floor, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bytes=nbytes, distinct_rows=distinct,
            max_abs_err=float((got - want).abs().max()),
            geometry=dataclasses.asdict(geo(
                b, HIST, DIM, torch.cuda.get_device_properties(dev)
                .multi_processor_count)) if geo else None,
            ptxas=ptxas)
        print(json.dumps(row), flush=True)
        if variants:
            for v in time_variants(torch, build, ek, table, idx, w, want,
                                   variant_fns):
                print(json.dumps(dict(batch=b, **v)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_embed_bag: no CUDA device", file=sys.stderr)
        return 1
    if args.child is not None:
        return child(args.child, args.variants)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    srcs = [str(Path(s).resolve()) for s in args.src or [ROOT / "src"]]
    order = []
    for k in range(args.rounds):
        order += srcs if k % 2 == 0 else srcs[::-1]
    for src in order:
        here = Path(src) == (ROOT / "src").resolve()
        rc = subprocess.run([sys.executable, __file__, "--child", src] + (
            ["--variants"] if args.variants and here else [])).returncode
        if rc != 0:
            print(f"probe_embed_bag: {src} failed (exit {rc})",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
