"""Config plumbing: the arch registry and the per-shape input sizes.

The part of `repro.configs.common` that the ported archs need: the LM,
GNN and MIND shapes and `get_arch` (`Cell`, the `*_cell` builders and
`build_cell` are still to be ported).
"""
from __future__ import annotations

import importlib

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# n_pad/e2_pad: node/edge arrays padded to multiples of 512 so every mesh
# (256 or 512 devices) shards them evenly; validity masks carry true sizes.
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_pad=3072, e2_pad=21504),
    "minibatch_lg": dict(kind="train", n_nodes=169984, n_edges=168960,
                         d_feat=602, sampled=True, n_pad=169984,
                         e2_pad=337920),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_pad=2449408, e2_pad=123719680),
    "molecule": dict(kind="train", n_nodes=3840, n_edges=8192, d_feat=16,
                     n_graphs=128, n_pad=4096, e2_pad=16384),
}

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
