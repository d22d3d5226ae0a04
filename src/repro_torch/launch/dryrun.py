"""Dry run of every (arch × shape × mesh) cell: bytes per device, FLOPs.

The port of `repro.launch.dryrun`. The reference lowers and compiles
each cell on a forced 512-device host mesh and reads XLA's memory
analysis, its cost analysis and the bytes of each collective parsed from
the post-SPMD HLO. Torch has no SPMD partitioner and no HLO, so a record
here holds:

- `memory.argument_bytes` / `output_bytes`: per device, exact arithmetic
  on shapes. Each leaf's dims are divided by the product of the sizes of
  the mesh axes its spec names (`launch.mesh.P`), rounded up, times its
  item size. The outputs' shapes are the cell's `out_shapes`; only for a
  cell that states none does the step run, once, on the meta
  `arg_specs`, to give them.
- `cost.flops`: the matrix-product FLOPs of the whole step (not per
  device), counted by `torch.utils.flop_counter.FlopCounterMode` over
  the step run on meta tensors. The BatchHL steps end their wave loops
  on values read to the host, which meta tensors do not hold: null, with
  the reason under `null_reasons`.
- null, with the reason, where the port has no counterpart: XLA's
  temp, peak and generated-code bytes (its buffer assignment), the
  collectives (no partitioned program exists), and the cost analysis's
  "bytes accessed" and "transcendentals".
- `bytes_pass_s` and `flops_pass_s`, the seconds of the two passes, in
  place of the reference's lower and compile seconds.

`_shape_bytes` and `parse_collective_bytes` are the reference's readers
of HLO text, in plain Python. Unlike the reference's module, importing
this one sets no environment variable.

    python -m repro_torch.launch.dryrun --arch minitron-4b \\
        --shape decode_32k --mesh single

writes one JSON record per cell under `--out` (default `build/dryrun`).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import common
from repro_torch.launch.mesh import P, MeshShape, make_production_mesh

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

NULL_REASONS = {
    "temp_bytes": "XLA buffer assignment; torch has no compiled program",
    "peak_bytes": "XLA buffer assignment; torch has no compiled program",
    "generated_code_bytes": "XLA executable size; no compiled program",
    "collectives": "no SPMD partitioner: no partitioned program to parse",
    "bytes accessed": "XLA cost analysis; not counted by the port",
    "transcendentals": "XLA cost analysis; not counted by the port",
}
HOST_READ_REASON = ("the step reads values on the host (its wave loops end "
                    "on a host sync), which meta tensors do not hold")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collective_bytes(hlo_text: str) -> dict:
    """Sum result-shape bytes of every collective op in per-device HLO."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # result = shape op-name(...)
        for coll in _COLLECTIVES:
            if f" {coll}(" in stripped or f" {coll}-start(" in stripped:
                m = _SHAPE_RE.search(stripped.split("=", 1)[-1])
                if m:
                    out[coll] += _shape_bytes(m.group(1), m.group(2))
                    counts[coll] += 1
                break
    return {"per_type_bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def leaf_bytes(t: torch.Tensor, spec: P, mesh: MeshShape) -> int:
    """Bytes of one device's block of `t` placed by `spec` on `mesh`."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{t.dim()} dims of a {tuple(t.shape)} leaf")
    sizes = mesh.shape
    n = 1
    for d, size in enumerate(t.shape):
        div = math.prod(sizes[a] for a in spec.axes(d))
        n *= -(-size // div)
    return n * t.element_size()


def tree_bytes(shapes, specs, mesh: MeshShape) -> int:
    """Per-device bytes of a tree of meta tensors placed by a spec tree
    of its structure (a `P` also places every leaf of a subtree)."""
    if isinstance(specs, P):
        if isinstance(shapes, torch.Tensor):
            return leaf_bytes(shapes, specs, mesh)
        subs = shapes.values() if isinstance(shapes, dict) else shapes
        return sum(tree_bytes(s, specs, mesh) for s in subs)
    if isinstance(specs, dict):
        if set(specs) != set(shapes):
            raise ValueError(f"spec keys {sorted(specs)} != shape keys "
                             f"{sorted(shapes)}")
        return sum(tree_bytes(shapes[k], specs[k], mesh) for k in specs)
    if len(specs) != len(shapes):
        raise ValueError(f"{len(specs)} specs for {len(shapes)} parts")
    return sum(tree_bytes(a, s, mesh) for a, s in zip(shapes, specs))


def output_bytes(cell: common.Cell, mesh: MeshShape) -> int:
    """Per-device bytes of the cell's outputs as `out_specs` places
    them; a cell without `out_shapes` runs its step on meta tensors."""
    shapes = cell.out_shapes
    if shapes is None:
        shapes = cell.step_fn(*cell.arg_specs)
    return tree_bytes(shapes, cell.out_specs, mesh)


def step_flops(cell: common.Cell) -> int:
    """Matrix-product FLOPs of one call of the cell's step on meta
    tensors (the whole program)."""
    with FlopCounterMode(display=False) as counter:
        cell.step_fn(*cell.arg_specs)
    return counter.get_total_flops()


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             flops: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    cell = common.build_cell(arch, shape, pod=multi_pod)
    arg_bytes = tree_bytes(cell.arg_specs, cell.in_specs, mesh)
    out_bytes = output_bytes(cell, mesh)
    bytes_s = time.perf_counter() - t0

    reasons = dict(NULL_REASONS)
    n_flops = flops_s = None
    if not flops:
        reasons["flops"] = "FLOPs pass not run"
    elif common.get_arch(arch).FAMILY == "batchhl":
        reasons["flops"] = HOST_READ_REASON
    else:
        t0 = time.perf_counter()
        n_flops = step_flops(cell)
        flops_s = time.perf_counter() - t0
    return {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": mesh.size,
        "bytes_pass_s": bytes_s, "flops_pass_s": flops_s,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": None, "peak_bytes": None,
                   "generated_code_bytes": None},
        "cost": {"flops": n_flops, "bytes accessed": None,
                 "transcendentals": None},
        "collectives": None,
        "flops_note": cell.flops_note,
        "null_reasons": reasons,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id; default = all assigned archs")
    ap.add_argument("--shape", default=None,
                    help="shape name; default = all shapes of the arch")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--include-batchhl", action="store_true",
                    help="also dry-run the paper's own BatchHL service")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(common.ALL_ARCHS)
    if args.include_batchhl and "batchhl" not in archs:
        archs.append("batchhl")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = 0
    for arch in archs:
        shapes = [args.shape] if args.shape else \
            list(common.arch_shapes(arch))
        for shape in shapes:
            for multi_pod in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch, shape, multi_pod)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    n_ok += 1
                    mem = rec["memory"]
                    print(f"OK   {tag}: bytes/device args="
                          f"{mem['argument_bytes']} out="
                          f"{mem['output_bytes']} flops="
                          f"{rec['cost']['flops']} ({rec['flops_pass_s']} s)")
                # A failed cell is reported and counted; the run goes on.
                except Exception as e:  # noqa: BLE001
                    n_fail += 1
                    print(f"FAIL {tag}: {e}")
                    traceback.print_exc()
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
