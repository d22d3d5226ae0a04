"""Config plumbing: the arch registry, per-cell input layouts, step
builders and placement specs.

The port of `repro.configs.common`. One place owns the (arch × shape ×
mesh) → (step_fn, input meta tensors, in/out placement specs) mapping
that the dry run (`launch/dryrun.py`) and chip_smoke read. A cell's
`arg_specs` are meta tensors (the reference's ShapeDtypeStructs), its
`in_specs`/`out_specs` trees of `launch.mesh.P` (its PartitionSpecs),
and `out_shapes` the meta tensors its step returns, which the reference
reads off the compiled program and the port states beside `out_specs`
(None, as in a cell made with the reference's eight fields: the dry run
runs the step on the meta `arg_specs` to get them).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch.data import synthetic as synth
from repro_torch.launch.mesh import P
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.tree import tree_map

# --------------------------------------------------------------------------
# Cell description
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (arch × input-shape) dry-run cell."""
    arch_id: str
    shape_name: str
    kind: str          # train | prefill | decode | serve | retrieval |
    #                    update | query | construct
    step_fn: Callable  # step_fn(*args) on tensors shaped as arg_specs
    arg_specs: tuple   # meta-tensor trees (positional)
    in_specs: tuple    # P trees (positional)
    out_specs: Any     # P tree
    flops_note: dict   # {model_flops, tokens, ...} for §Roofline
    out_shapes: Any = None  # meta-tensor tree of what step_fn returns


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


def batch_axes(pod: bool):
    return ("pod", "data") if pod else ("data",)


def meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_cell(arch_id: str, shape_name: str, step, pshapes, pspecs,
                opt_cfg, layout: dict, batch_specs: dict,
                note: dict) -> Cell:
    """A train cell: step(state, batch) -> (state, {"loss"})."""
    state_shapes = ts_lib.train_state_shapes(pshapes, opt_cfg)
    state_specs = {"params": pspecs,
                   "opt": {"m": pspecs, "v": pspecs, "step": P()}}
    return Cell(arch_id, shape_name, "train", step,
                (state_shapes, synth.as_specs(layout)),
                (state_specs, batch_specs), (state_specs, {"loss": P()}),
                note, (state_shapes, {"loss": meta((), torch.float32)}))


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def lm_cell(cfg, shape_name: str, pod: bool,
            opt_cfg: opt_lib.AdamWConfig | None = None,
            scheme: str | None = None) -> Cell:
    from repro_torch.models import transformer as tfm
    sh = LM_SHAPES[shape_name]
    bax = batch_axes(pod)
    if scheme is None:
        # The reference's finding: v2 wins for train/prefill but costs
        # decode weight gathers for one token, so decode keeps v1.
        scheme = "v1" if sh["kind"] == "decode" else "v2"
    pspecs = tfm.param_specs(cfg, pod, scheme=scheme)
    pshapes = tfm.param_shapes(cfg)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()

    if sh["kind"] == "train":
        if sh["batch"] % 256 == 0:
            cfg = dataclasses.replace(cfg, attn_2d_batch=True)
        layout = synth.lm_train_layout(sh["batch"], sh["seq"], cfg.vocab)
        return _train_cell(
            cfg.name, shape_name, ts_lib.make_lm_train_step(cfg, opt_cfg),
            pshapes, pspecs, opt_cfg, layout,
            {k: P(bax, None) for k in layout},
            dict(tokens=sh["batch"] * sh["seq"], train=True))

    # serving cells share the decode_step entry (prefill = multi-token)
    b = sh["batch"]
    if sh["kind"] == "prefill":
        q_tokens, cache_len0, max_len = sh["seq"], 0, sh["seq"]
        seq_axis = "model"
    elif shape_name == "decode_32k":
        q_tokens, cache_len0, max_len = 1, sh["seq"], sh["seq"] + 512
        seq_axis = "model"
    else:  # long_500k: batch=1 → shard the cache sequence across everything
        q_tokens, cache_len0, max_len = 1, sh["seq"], sh["seq"] + 512
        seq_axis = ("pod", "data", "model") if pod else ("data", "model")
    cshapes = tfm.cache_shapes(cfg, b, max_len)
    cache_sp = _lm_cache_specs(cfg, pod, seq_axis, cshapes)
    layout = synth.lm_prefill_layout(b, q_tokens, cfg.vocab)
    tok_spec = {"tokens": P(bax if b > 1 else None, None)}

    def serve_step(params, cache, batch):
        return tfm.decode_step(params, cache, batch["tokens"], cache_len0,
                               cfg)

    logits_spec = P(bax if b > 1 else None, "model")
    return Cell(cfg.name, shape_name, sh["kind"], serve_step,
                (pshapes, cshapes, synth.as_specs(layout)),
                (pspecs, cache_sp, tok_spec),
                (logits_spec, cache_sp),
                dict(tokens=b * q_tokens, kv_len=max_len, train=False),
                (meta((b, cfg.vocab), cfg.dtype), cshapes))


def _lm_cache_specs(cfg, pod: bool, seq_axis, cshapes: dict) -> dict:
    """Specs mirroring the cache_shapes tree: [L, B, S, ...] leaves get
    batch over the data axes (when the cell shards its batch) and S over
    seq_axis."""
    bax = batch_axes(pod)
    b_ax = bax if seq_axis == "model" else None

    def leaf_spec(leaf):
        if leaf.dim() == 4:    # MLA c_kv [L, B, S, r]
            return P(None, b_ax, seq_axis, None)
        return P(None, b_ax, seq_axis, None, None)
    return tree_map(leaf_spec, cshapes)


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------

def gnn_cell(cfg, shape_name: str, pod: bool,
             opt_cfg: opt_lib.AdamWConfig | None = None) -> Cell:
    from repro_torch.models import gnn as gnn_lib
    sh = GNN_SHAPES[shape_name]
    bax = batch_axes(pod)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()

    d_feat = sh["d_feat"]
    n_graphs = sh.get("n_graphs")
    cfg = dataclasses.replace(cfg, d_in=d_feat)
    n_pad, e2 = sh["n_pad"], sh["e2_pad"]
    tri_cap = min(4 * e2, 1 << 27)
    layout = synth.gnn_layout(cfg.arch, n_pad, e2, d_feat,
                              cfg.d_out, n_graphs=n_graphs, tri_cap=tri_cap)

    # nodes/edges sharded over data(+pod); params replicated (small).
    def spec_for(k, v):
        shape = v[0]
        if k in ("targets",) and n_graphs is not None:
            return P(bax, None)
        row = bax if shape[0] % 512 == 0 else None
        return P(row, *([None] * (len(shape) - 1)))

    batch_specs = {k: spec_for(k, v) for k, v in layout.items()}
    pshapes = gnn_lib.init_params(cfg, device="meta")
    pspecs = tree_map(lambda _: P(), pshapes)

    def loss(p, b):
        return gnn_lib.loss_fn(p, b, cfg)
    return _train_cell(cfg.name, shape_name,
                       ts_lib.make_generic_train_step(loss, opt_cfg),
                       pshapes, pspecs, opt_cfg, layout, batch_specs,
                       dict(nodes=sh["n_nodes"], edges=e2, train=True))


# --------------------------------------------------------------------------
# MIND cells
# --------------------------------------------------------------------------

def mind_cell(cfg, shape_name: str, pod: bool,
              opt_cfg: opt_lib.AdamWConfig | None = None) -> Cell:
    from repro_torch.models import mind as mind_lib
    sh = MIND_SHAPES[shape_name]
    bax = batch_axes(pod)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    pshapes = {k: meta(s, d) for k, (s, d)
               in mind_lib.param_shapes(cfg).items()}
    pspecs = mind_lib.param_specs(cfg, pod)

    def row_specs(layout):
        return {k: P(bax, *([None] * (len(v[0]) - 1)))
                for k, v in layout.items()}

    if sh["kind"] == "train":
        layout = synth.mind_train_layout(sh["batch"], cfg.hist_len,
                                         cfg.n_items)

        def loss(p, b):
            return mind_lib.train_loss(p, b, cfg)
        return _train_cell(cfg.name, shape_name,
                           ts_lib.make_generic_train_step(loss, opt_cfg),
                           pshapes, pspecs, opt_cfg, layout,
                           row_specs(layout),
                           dict(batch=sh["batch"], train=True))

    if sh["kind"] == "serve":
        layout = synth.mind_serve_layout(sh["batch"], cfg.hist_len,
                                         cfg.n_items, sh["n_cands"])

        def step(params, batch):
            return mind_lib.serve_scores(params, batch, cfg)
        return Cell(cfg.name, shape_name, "serve", step,
                    (pshapes, synth.as_specs(layout)),
                    (pspecs, row_specs(layout)), P(bax, None),
                    dict(batch=sh["batch"], train=False),
                    meta((sh["batch"], sh["n_cands"]), torch.float32))

    # retrieval: candidates sharded over the batch axes (10⁶ is not
    # divisible by 256, so the model axis stays off this dim)
    layout = synth.mind_retrieval_layout(cfg.hist_len, cfg.n_items,
                                         sh["n_cands"])
    batch_specs = {"hist": P(None, None), "hist_mask": P(None, None),
                   "cands": P(bax)}

    def step(params, batch):
        return mind_lib.retrieval_scores(params, batch, cfg)
    return Cell(cfg.name, shape_name, "retrieval", step,
                (pshapes, synth.as_specs(layout)),
                (pspecs, batch_specs), P(None, bax),
                dict(batch=sh["n_cands"], train=False),
                meta((1, sh["n_cands"]), torch.float32))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

def get_arch(arch_id: str):
    """Import the arch's config module by id."""
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


ALL_ARCHS = (
    "gemma2-9b", "minitron-4b", "granite-8b", "deepseek-v2-lite-16b",
    "mixtral-8x22b",
    "schnet", "dimenet", "mace", "graphcast",
    "mind",
)


def build_cell(arch_id: str, shape_name: str, pod: bool) -> Cell:
    mod = get_arch(arch_id)
    cfg = mod.model_config()
    if mod.FAMILY == "lm":
        return lm_cell(cfg, shape_name, pod)
    if mod.FAMILY == "gnn":
        return gnn_cell(cfg, shape_name, pod)
    if mod.FAMILY == "recsys":
        return mind_cell(cfg, shape_name, pod)
    if mod.FAMILY == "batchhl":
        return mod.build_cell(shape_name, pod)
    raise ValueError(mod.FAMILY)


def arch_shapes(arch_id: str) -> tuple[str, ...]:
    return get_arch(arch_id).SHAPES
