"""The public face of the port: build / update / query / serve.

    >>> from repro_torch import api
    >>> g, lab = api.build(n, edges, num_landmarks=16)
    >>> g, lab, affected = api.update(g, lab, updates)
    >>> dist = api.query(g, lab, sources, targets)
    >>> report = api.serve(n=5000, batches=3, pipeline=True)
    >>> report = api.serve(n=5000, readers=2, publish_dir="pub")

The same verbs as `repro.api`, on one GPU. `build` runs on the GPU unless
it is given `device="cpu"`, and raises when there is no GPU and no device
was given; `update` and `query` run where the graph lives.

On the GPU every sweep goes through the relax-sweep kernel: the verbs
hold a `RelaxEngine(block_v=512, block_e=4096)` per card, prepare its
plan from the current snapshot (the post-update one for `update`) and
pass it down; the engine's cache keeps one tiling per snapshot, so a run
of queries on one snapshot tiles it once. `block_e` caps tile rows: on
power-law graphs the block that holds the hubs has far more edge slots
than the rest, and one row per block pads every row to it. Pass `engine=`
to use another engine, on the CPU too (the tiled plain path); on the CPU
the default is the COO reference (`plan=None`), as in `repro.api`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.batch import batchhl_update
from repro_torch.core.construct import (build_labelling,
                                        select_landmarks_by_degree)
from repro_torch.core.engine import RelaxEngine, RelaxPlan
from repro_torch.core.labelling import HighwayLabelling
from repro_torch.core.query import batched_query
from repro_torch.device import resolve_device
from repro_torch.graphs.coo import (BatchUpdate, Graph, apply_batch,
                                    from_edges, make_batch)
from repro_torch.launch.config import SPEC_GROUPS, ServeSpec

__all__ = ["build", "update", "query", "serve", "Graph", "BatchUpdate",
           "HighwayLabelling", "RelaxEngine", "ServeSpec"]

BLOCK_V = 512
BLOCK_E = 4096

_engines: dict[torch.device, RelaxEngine] = {}


def default_engine(device: torch.device) -> RelaxEngine | None:
    """The engine the verbs use on `device` when none is passed: one
    shared per card, and None (the COO reference) on the CPU."""
    if device.type != "cuda":
        return None
    if device not in _engines:
        _engines[device] = RelaxEngine(block_v=BLOCK_V, block_e=BLOCK_E,
                                       device=device)
    return _engines[device]


def _plan(g: Graph, engine: RelaxEngine | None) -> RelaxPlan | None:
    engine = engine if engine is not None else default_engine(g.device)
    return engine.prepare(g) if engine is not None else None


def build(n: int, edges: np.ndarray, *, num_landmarks: int = 16,
          landmarks=None, capacity: int | None = None, slack: int = 256,
          device: str | torch.device | None = None,
          engine: RelaxEngine | None = None
          ) -> tuple[Graph, HighwayLabelling]:
    """Construct a dynamic graph and its highway-cover labelling.

    `edges` is an (E, 2) or (E, 3) int array of undirected edges
    (optional third column: positive integer weights). `capacity`
    reserves COO slots for future insertions (default: E + `slack`).
    Landmarks default to the `num_landmarks` highest-degree vertices.
    """
    device = resolve_device(device)
    edges = np.asarray(edges)
    g = from_edges(n, edges, capacity=capacity or edges.shape[0] + slack,
                   device=device)
    if landmarks is None:
        landmarks = select_landmarks_by_degree(g, k=num_landmarks)
    else:
        landmarks = torch.as_tensor(np.asarray(landmarks, np.int32),
                                    device=device)
    return g, build_labelling(g, landmarks, plan=_plan(g, engine))


def update(g: Graph, lab: HighwayLabelling, updates, *,
           improved: bool = True, pad_to: int | None = None,
           engine: RelaxEngine | None = None
           ) -> tuple[Graph, HighwayLabelling, torch.Tensor]:
    """Apply one batch of edge updates and repair the labelling (BatchHL).

    `updates` is a sequence of `(u, v, op)` or `(u, v, op, w)` rows (see
    `make_batch`) or a `BatchUpdate`. `improved=True` is BHL⁺, False the
    basic BHL. Returns `(graph', labelling', affected)` — `affected` is
    the bool [R, n] plane of (landmark, vertex) pairs the repair
    recomputed.
    """
    batch = updates if isinstance(updates, BatchUpdate) \
        else make_batch(updates, pad_to=pad_to, device=g.device)
    g_new = apply_batch(g, batch)
    return batchhl_update(g, batch, lab, improved=improved,
                          plan=_plan(g_new, engine), g_new=g_new)


def query(g: Graph, lab: HighwayLabelling, s, t, *, max_steps: int = 64,
          engine: RelaxEngine | None = None) -> torch.Tensor:
    """Exact batched distances d_G(s, t), INF_D where unreachable.

    `s`/`t` are equal-length int vertex arrays or tensors.
    """
    s = torch.as_tensor(np.asarray(s, np.int32) if not torch.is_tensor(s)
                        else s, device=g.device)
    t = torch.as_tensor(np.asarray(t, np.int32) if not torch.is_tensor(t)
                        else t, device=g.device)
    return batched_query(g, lab, s, t, max_steps=max_steps,
                         plan=_plan(g, engine))


def serve(spec: ServeSpec | None = None, *, publish_dir: str | None = None,
          device: str | torch.device | None = None, **overrides):
    """Serve a `ServeSpec`: the single-process serving loop, returning its
    `ServeReport`, or with `publish_dir` the replica tier (one updater
    publishing into `publish_dir`, `topology.readers` reader processes and
    a router, driven by an open-loop client stream), returning its
    `ReplicaReport`.

    `overrides` are `ServeSpec` group fields by name (`n=5000`,
    `pipeline=True`, `readers=2`, ...) applied over `spec` (or over the
    defaults). `device=None` is the GPU, in every process of the tier.
    """
    from repro_torch.launch import replica
    from repro_torch.launch.serve import ServeLoop

    spec = spec or ServeSpec()
    groups = {}
    for gname, cls in SPEC_GROUPS:
        fields = {f.name for f in dataclasses.fields(cls)}
        got = {k: overrides.pop(k) for k in list(overrides) if k in fields}
        if got:
            groups[gname] = dataclasses.replace(getattr(spec, gname), **got)
    if overrides:
        raise TypeError(f"unknown serve() overrides: {sorted(overrides)}")
    spec = dataclasses.replace(spec, **groups)
    if publish_dir is not None:
        return replica.serve_main(spec, publish_dir, verify_limit=None,
                                  device=device)
    return ServeLoop(spec.to_serve_config(), device=device).run()
