#!/usr/bin/env python3
"""Where kernel A's wide mode spends its time, on one GPU.

    python3 tools/probe_wide.py

Builds variants of `csrc/relax_sweep.cu` with nvcc into `build/probe/`
and times each with CUDA events (the better of two runs of 10 calls;
every variant is then timed again in reverse order) through the
wrapper `kernel.relax_sweep`, on the key2 wave that `chip_smoke.py`
phase 5 times: keys [32, 2^20] of the labelling of BA(2^20, m=4) at
capacity 2^23 with 32 landmarks by degree, the landmarks' hub, the live
edges, block_e 4096, at block_v 65,536 and 2^20 (the wide mode) and 512
(the tiled mode, as built only). The variants change one thing each in
the wide fold, which as built skips a candidate at or above the value
`out` holds (read from L2 before the atomic; exact): no skip (every
candidate below `inf` is atomicMin'ed), the atomics on a vertex-major
[n, 32] layout of `out` (the 32 planes of a vertex in one 128-byte
line) without and with the skip, or no fold (the candidates are
computed and dropped). The last three compute something else; they
show what the part they change costs.

Prints the card's name and power limit first. Exits nonzero without a
CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 20
CAPACITY = 1 << 23
LANDMARKS = 32
BLOCK_E = 4096
BLOCK_VS = (512, 65_536, 1 << 20)


def variants(src: str) -> dict[str, str]:
    def sub(old: str, new: str) -> str:
        if old not in src:
            raise RuntimeError(f"relax_sweep.cu no longer holds {old!r}")
        return src.replace(old, new)
    fold = """              int* o = out_g + static_cast<long long>(q) * n + v;
              if (cand < inf && cand < __ldcg(o)) atomicMin(o, cand);"""
    vertex = """              int* o = out + v * 32 + c0 + q;"""
    return {
        "as built": src,
        "no skip": sub(fold, """              int* o = out_g + static_cast<long long>(q) * n + v;
              if (cand < inf) atomicMin(o, cand);"""),
        "vertex-major atomics": sub(fold, vertex + """
              if (cand < inf) atomicMin(o, cand);"""),
        "vertex-major atomics, skip": sub(fold, vertex + """
              if (cand < inf && cand < __ldcg(o)) atomicMin(o, cand);"""),
        "no fold": sub(fold, """              if (cand == -7) out_g[0] = cand;"""),
    }


def event_ms(torch, fn, reps: int = 10) -> float:
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_wide: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())

    from repro_torch import api
    from repro_torch.core.engine import RelaxEngine
    from repro_torch.core.labelling import INF_KEY2, per_plane_hub_mask
    from repro_torch.graphs import generators
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_relax import kernel as rk

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "relax_sweep.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        cu = out_dir / f"relax_sweep_{i}.cu"
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
        print(f"A build {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(so)).relax_sweep_launch
        fn.argtypes = rk._ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn
    # The wrapper launches whichever variant `current` names.
    current = ["as built"]
    build.function = lambda *_: libs[current[0]]

    edges = generators.barabasi_albert(N, 4, seed=0)
    g, lab = api.build(N, edges, num_landmarks=LANDMARKS,
                       capacity=CAPACITY, device=dev)
    keys = lab.key2().contiguous()
    hub = per_plane_hub_mask(lab.landmarks, lab.landmarks, N)
    want = None
    for block_v in BLOCK_VS:
        bg = RelaxEngine(block_v=block_v, block_e=BLOCK_E,
                         device=dev).prepare(g).tiles
        args = (keys, hub, bg.src_t, bg.dstloc_t, bg.perm_t, bg.slot_t,
                bg.rowblk_t, g.valid, g.w, 2, INF_KEY2, 1, N, bg.block_v,
                bg.nb)
        if want is None:
            want = rk.relax_sweep_plain(*args)
        mode = rk.sweep_mode(block_v)
        print(f"A block_v={block_v} ({mode} mode): {bg.rowblk_t.numel()} "
              f"rows, {bg.slots} slots", flush=True)
        names = list(libs) if mode == "wide" else ["as built"]
        for order in (names, names[::-1]):
            for name in order:
                current[0] = name
                got = rk.relax_sweep(*args)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                ms = min(event_ms(torch, lambda: rk.relax_sweep(*args))
                         for _ in range(2))
                print(f"A block_v={block_v} {name}: {ms:.4f} ms (equal to "
                      f"plain: {same})", flush=True)
        del bg, args
    return 0


if __name__ == "__main__":
    sys.exit(main())
