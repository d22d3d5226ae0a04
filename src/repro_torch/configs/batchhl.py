"""batchhl [paper]: the distance-query service itself as a dry-run config.

The port of `repro.configs.batchhl`. Production-scale posture: |V| =
2²⁰ vertices, edge capacity 2²³ (16.7M directed slots), R = 32
landmarks, batches of 1024 updates, query batches of 1024. Placement:
landmark planes [R, V] split (model → R, data → V); edges over data;
updates replicated (tiny).

The steps compute what the reference's steps compute, through the
port's verbs (`api.update`, `api.query`, `build_labelling` with
`api.default_plan`): on a CUDA device every sweep tiles through the
card's default engine (kernel A each wave, kernel B for the Eq.-3
bound); on the CPU they run the COO path. Both give the same outputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import common as cc
from repro_torch.configs.common import meta
from repro_torch.launch.mesh import P

ARCH_ID = "batchhl"
FAMILY = "batchhl"
# query_1k_repl is the reference's optimized query layout: graph +
# labelling replicated per device, queries sharded over *all* mesh axes,
# so the BiBFS frontier expansion needs no collective.
SHAPES = ("update_1k", "update_10k", "query_1k", "query_1k_repl",
          "construct")

N_VERTICES = 1 << 20
EDGE_CAP = 1 << 23          # undirected capacity; 2x directed slots
N_LANDMARKS = 32


@dataclasses.dataclass(frozen=True)
class BatchHLConfig:
    name: str = ARCH_ID
    n_vertices: int = N_VERTICES
    edge_cap: int = EDGE_CAP
    n_landmarks: int = N_LANDMARKS
    improved: bool = True        # BHL+ (Algo 3) by default


def model_config() -> BatchHLConfig:
    return BatchHLConfig()


def reduced_config() -> BatchHLConfig:
    return BatchHLConfig(name=ARCH_ID + "-smoke", n_vertices=256,
                         edge_cap=1024, n_landmarks=4)


def _graph_shapes(c: BatchHLConfig) -> dict:
    e2 = 2 * c.edge_cap
    return {"src": meta((e2,), torch.int32),
            "dst": meta((e2,), torch.int32),
            "valid": meta((e2,), torch.bool),
            "w": meta((e2,), torch.int32)}


def _labelling_shapes(c: BatchHLConfig) -> dict:
    r, v = c.n_landmarks, c.n_vertices
    return {"landmarks": meta((r,), torch.int32),
            "dist": meta((r, v), torch.int32),
            "hub": meta((r, v), torch.bool),
            "highway": meta((r, r), torch.int32)}


def _graph_fields(g) -> dict:
    return {"src": g.src, "dst": g.dst, "valid": g.valid, "w": g.w}


def _labelling_fields(lab) -> dict:
    return {"landmarks": lab.landmarks, "dist": lab.dist, "hub": lab.hub,
            "highway": lab.highway}


def build_cell(shape_name: str, pod: bool) -> cc.Cell:
    from repro_torch import api
    from repro_torch.core.construct import build_labelling
    from repro_torch.core.labelling import HighwayLabelling
    from repro_torch.graphs.coo import BatchUpdate, Graph

    c = model_config()
    bax = cc.batch_axes(pod)
    gsh = _graph_shapes(c)
    lsh = _labelling_shapes(c)
    g_spec = {"src": P(bax), "dst": P(bax), "valid": P(bax), "w": P(bax)}
    lab_spec = {"landmarks": P(None), "dist": P("model", bax),
                "hub": P("model", bax), "highway": P(None, None)}

    if shape_name.startswith("update"):
        u = 1024 if shape_name == "update_1k" else 10240
        ush = {"src": meta((u,), torch.int32),
               "dst": meta((u,), torch.int32),
               "is_del": meta((u,), torch.bool),
               "valid": meta((u,), torch.bool),
               "w": meta((u,), torch.int32),
               "is_rew": meta((u,), torch.bool)}
        u_spec = {k: P(None) for k in ush}

        def step(g, batch, lab):
            g2, lab2, aff = api.update(
                Graph(**g, n=c.n_vertices), HighwayLabelling(**lab),
                BatchUpdate(**batch), improved=c.improved)
            return (_graph_fields(g2), _labelling_fields(lab2),
                    aff.sum(dtype=torch.int32))
        return cc.Cell(ARCH_ID, shape_name, "update", step,
                       (gsh, ush, lsh), (g_spec, u_spec, lab_spec),
                       (g_spec, lab_spec, P()),
                       dict(updates=u, edges=2 * c.edge_cap,
                            landmarks=c.n_landmarks, train=False),
                       (gsh, lsh, meta((), torch.int32)))

    if shape_name.startswith("query_1k"):
        b = 1024
        qsh = {"s": meta((b,), torch.int32), "t": meta((b,), torch.int32)}
        if shape_name == "query_1k_repl":
            # Queries over every axis, graph + labelling replicated: the
            # frontier waves need no collective; only the answers gather.
            q_ax = ("pod", "data", "model") if pod else ("data", "model")
            q_spec = {"s": P(q_ax), "t": P(q_ax)}
            g_spec_q = {"src": P(None), "dst": P(None), "valid": P(None),
                        "w": P(None)}
            lab_spec_q = {"landmarks": P(None), "dist": P(None, None),
                          "hub": P(None, None), "highway": P(None, None)}
            out_spec = P(q_ax)
        else:
            q_spec = {"s": P(bax), "t": P(bax)}
            g_spec_q, lab_spec_q, out_spec = g_spec, lab_spec, P(bax)

        def step(g, lab, q):
            return api.query(Graph(**g, n=c.n_vertices),
                             HighwayLabelling(**lab), q["s"], q["t"],
                             max_steps=16)
        return cc.Cell(ARCH_ID, shape_name, "query", step,
                       (gsh, lsh, qsh), (g_spec_q, lab_spec_q, q_spec),
                       out_spec,
                       dict(queries=b, landmarks=c.n_landmarks,
                            train=False),
                       meta((b,), torch.int32))

    if shape_name != "construct":
        raise KeyError(f"batchhl has no shape {shape_name!r}")

    def step(g, landmarks):
        g = Graph(**g, n=c.n_vertices)
        lab = build_labelling(g, landmarks, 64, plan=api.default_plan(g))
        return _labelling_fields(lab)
    return cc.Cell(ARCH_ID, shape_name, "construct", step,
                   (gsh, meta((c.n_landmarks,), torch.int32)),
                   (g_spec, P(None)), lab_spec,
                   dict(landmarks=c.n_landmarks, edges=2 * c.edge_cap,
                        train=False),
                   lsh)
