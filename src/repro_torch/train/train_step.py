"""Train-step factories: loss → grad → clip → AdamW.

The port of `repro.train.train_step`'s generic step. A step is a plain
function `train_step(state, batch) -> (state, {"loss": loss})` over the
state `{"params", "opt"}`; it takes the gradients of every param leaf
with `torch.autograd.grad` and hands them to `optimizer.adamw_update`.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_generic_train_step(loss_fn: Callable,
                            opt_cfg: opt_lib.AdamWConfig) -> Callable:
    """Train step for any (params, batch) → scalar loss function."""

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        params = state["params"]
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss = loss_fn(leaves, batch)
            # A param the loss does not reach gets zeros, as under JAX.
            grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                        allow_unused=True,
                                        materialize_grads=True)
        del leaves
        new_params, new_opt = opt_lib.adamw_update(
            params, tree_unflatten(params, grads), state["opt"], opt_cfg)
        return {"params": new_params, "opt": new_opt}, \
            {"loss": loss.detach()}

    return train_step


def init_train_state(params: Any, opt_cfg: opt_lib.AdamWConfig) -> dict:
    return {"params": params, "opt": opt_lib.init_opt_state(params, opt_cfg)}
