"""Carry state between the JAX package and the port, as numpy arrays.

The reference's state is `Graph(src, dst, valid, w, n)`, the six fields of
`BatchUpdate` and `HighwayLabelling(landmarks, dist, hub, highway)`, and
for the directed variant `DirectedGraph(src, dst, valid, w, n)` and
`DirectedLabelling(fwd, bwd)` of two such labellings. Each
`*_from_numpy` takes those fields (any array-likes; `np.asarray` pulls a
JAX array to the host) and builds the port's tensors on `device`; each
`*_to_numpy` returns the fields in the same order as numpy arrays. Dtypes
are the reference's: int32 ids, distances and weights, bool flags.

For the models, `params_*` carry any nested dict or list of arrays (a JAX
params tree; `repro_torch.tree` says which nodes there are) leaf by leaf
with its dtype (bfloat16 by its 16-bit patterns, without `ml_dtypes`),
and `train_state_*` a train state
`{"params", "opt": {"m", "v", "step"[, "ef"]}}` (`step` an int32 scalar).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.directed import DirectedGraph, DirectedLabelling
from repro_torch.core.labelling import HighwayLabelling
from repro_torch.graphs.coo import BatchUpdate, Graph
from repro_torch.tree import tree_map


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def graph_from_numpy(src, dst, valid, w, n: int, *,
                     device: str | torch.device) -> Graph:
    return Graph(_t(src, np.int32, device), _t(dst, np.int32, device),
                 _t(valid, bool, device), _t(w, np.int32, device), int(n))


def graph_to_numpy(g: Graph) -> tuple:
    """(src, dst, valid, w, n)."""
    return _np(g.src), _np(g.dst), _np(g.valid), _np(g.w), g.n


def batch_from_numpy(src, dst, is_del, valid, w, is_rew, *,
                     device: str | torch.device) -> BatchUpdate:
    return BatchUpdate(_t(src, np.int32, device), _t(dst, np.int32, device),
                       _t(is_del, bool, device), _t(valid, bool, device),
                       _t(w, np.int32, device), _t(is_rew, bool, device))


def batch_to_numpy(b: BatchUpdate) -> tuple:
    """(src, dst, is_del, valid, w, is_rew)."""
    return tuple(_np(x) for x in (b.src, b.dst, b.is_del, b.valid, b.w,
                                  b.is_rew))


def labelling_from_numpy(landmarks, dist, hub, highway, *,
                         device: str | torch.device) -> HighwayLabelling:
    return HighwayLabelling(_t(landmarks, np.int32, device),
                            _t(dist, np.int32, device),
                            _t(hub, bool, device),
                            _t(highway, np.int32, device))


def labelling_to_numpy(lab: HighwayLabelling) -> tuple:
    """(landmarks, dist, hub, highway)."""
    return tuple(_np(x) for x in (lab.landmarks, lab.dist, lab.hub,
                                  lab.highway))


def directed_graph_from_numpy(src, dst, valid, w, n: int, *,
                              device: str | torch.device) -> DirectedGraph:
    return DirectedGraph(_t(src, np.int32, device), _t(dst, np.int32, device),
                         _t(valid, bool, device), _t(w, np.int32, device),
                         int(n))


def directed_graph_to_numpy(g: DirectedGraph) -> tuple:
    """(src, dst, valid, w, n)."""
    return graph_to_numpy(g)


def directed_labelling_from_numpy(fwd, bwd, *, device: str | torch.device
                                  ) -> DirectedLabelling:
    """`fwd` and `bwd` are each (landmarks, dist, hub, highway)."""
    return DirectedLabelling(labelling_from_numpy(*fwd, device=device),
                             labelling_from_numpy(*bwd, device=device))


def directed_labelling_to_numpy(lab: DirectedLabelling) -> tuple:
    """((landmarks, dist, hub, highway) of fwd, the same of bwd)."""
    return labelling_to_numpy(lab.fwd), labelling_to_numpy(lab.bwd)


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # a copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, *, device: str | torch.device):
    """Nested dicts and lists of array-likes → the same tree of tensors
    on `device`, each leaf with its own dtype. A bfloat16 leaf (dtype
    name "bfloat16", as JAX's arrays give it through `ml_dtypes`) is
    taken by its 16-bit patterns."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return _np(t.view(torch.uint16))
    return _np(t)


def params_to_numpy(tree):
    """Nested dicts and lists of tensors → the same tree of numpy
    arrays. A bfloat16 leaf comes back as its 16-bit patterns, dtype
    uint16 (numpy has no bfloat16 without `ml_dtypes`): a JAX caller
    takes it as `jnp.asarray(bits).view(jnp.bfloat16)`."""
    return tree_map(_leaf_to_numpy, tree)


def _check_train_state(state) -> None:
    opt = state["opt"]
    if set(state) != {"params", "opt"} or not {"m", "v", "step"} <= set(
            opt) or not set(opt) <= {"m", "v", "step", "ef"}:
        raise ValueError("a train state is {'params', 'opt': {'m', 'v', "
                         "'step'[, 'ef']}}")


def train_state_from_numpy(state, *, device: str | torch.device) -> dict:
    """A train state of array-likes (a JAX train state) → the port's."""
    _check_train_state(state)
    out = params_from_numpy(state, device=device)
    out["opt"]["step"] = out["opt"]["step"].to(torch.int32).reshape(())
    return out


def train_state_to_numpy(state) -> dict:
    """The port's train state → the same dict of numpy arrays."""
    _check_train_state(state)
    return params_to_numpy(state)
