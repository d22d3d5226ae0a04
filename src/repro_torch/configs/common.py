"""Config plumbing: the arch registry and the per-shape input sizes.

The part of `repro.configs.common` that the ported archs need: the MIND
shapes and `get_arch`.
"""
from __future__ import annotations

import importlib

MIND_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512, n_cands=1000),
    "serve_bulk": dict(kind="serve", batch=262144, n_cands=1),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cands=1_000_000),
}


def get_arch(arch_id: str):
    """Import the arch's config module by id."""
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))
