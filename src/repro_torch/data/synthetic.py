"""Stateless-seeded synthetic data: batch = f(layout, seed).

The port of `repro.data.synthetic`'s `materialize` and MIND layouts. A
layout is a dict name -> (shape tuple, torch dtype, kind), kind in
{"tokens:<vocab>", "ids:<max>", "float", "bool", "pos", "angle",
"zeros"}. `materialize` draws with the reference's
`numpy.random.default_rng(seed)` calls in the reference's order, so its
arrays equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def materialize(layout: dict, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Real tensors for `layout`, on the GPU unless `device` says
    otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype, kind) in layout.items():
        if kind.startswith("tokens:") or kind.startswith("ids:"):
            hi = int(kind.split(":")[1])
            a = torch.from_numpy(
                rng.integers(0, hi, size=shape).astype(np.int32))
        elif kind == "bool":
            a = torch.ones(shape, dtype=torch.bool)
        elif kind == "pos":
            a = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32) * 2.0)
        elif kind == "angle":
            a = torch.from_numpy(
                rng.uniform(0, np.pi, size=shape).astype(np.float32))
        elif kind == "zeros":
            a = torch.zeros(shape, dtype=dtype)
        else:
            a = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(dtype)
        out[k] = a.to(dev)
    return out


# ---------------------------------------------------------------------------
# MIND layouts
# ---------------------------------------------------------------------------

def mind_train_layout(batch: int, hist_len: int, n_items: int) -> dict:
    return {
        "hist": ((batch, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((batch, hist_len), torch.bool, "bool"),
        "target": ((batch,), torch.int32, f"ids:{n_items}"),
    }


def mind_serve_layout(batch: int, hist_len: int, n_items: int,
                      n_cands: int) -> dict:
    return {
        "hist": ((batch, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((batch, hist_len), torch.bool, "bool"),
        "cands": ((batch, n_cands), torch.int32, f"ids:{n_items}"),
    }


def mind_retrieval_layout(hist_len: int, n_items: int,
                          n_cands: int) -> dict:
    return {
        "hist": ((1, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((1, hist_len), torch.bool, "bool"),
        "cands": ((n_cands,), torch.int32, f"ids:{n_items}"),
    }
