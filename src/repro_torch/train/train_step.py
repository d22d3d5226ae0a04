"""Train-step factories: loss → grad → clip → AdamW.

The port of `repro.train.train_step`. A step is a plain function
`train_step(state, batch) -> (state, {"loss": loss})` over the state
`{"params", "opt"}`; it takes the gradients of every param leaf with
`torch.autograd.grad` and hands them to the optimiser. The generic step
returns a new state (`optimizer.adamw_update`); the LM step updates its
state in place (`optimizer.adamw_update_`) and returns it, since a
full-width LM's state does not fit on one card twice.
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


def make_lm_train_step(cfg, opt_cfg: opt_lib.AdamWConfig,
                       microbatch: int | None = None) -> Callable:
    """Language-model train step over {tokens, targets} [B, S] int32.

    The step updates `state`'s tensors in place and returns it. Without
    `microbatch` the gradients have the params' dtypes (bfloat16 for a
    bfloat16 model); with it the batch is cut into B / microbatch
    consecutive slices whose gradients and losses are summed in float32
    and divided by their count, as the reference's scan does.
    """
    from repro_torch.models import transformer as tfm

    def loss_grads(leaves, tokens, targets):
        loss = tfm.chunked_loss(leaves, tokens, targets, cfg)
        return loss.detach(), torch.autograd.grad(
            loss, tree_leaves(leaves), allow_unused=True,
            materialize_grads=True)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        tokens, targets = batch["tokens"], batch["targets"]
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            if microbatch:
                nm = tokens.shape[0] // microbatch
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         for p in tree_leaves(params)]
                for i in range(0, nm * microbatch, microbatch):
                    part, g = loss_grads(leaves, tokens[i:i + microbatch],
                                         targets[i:i + microbatch])
                    loss = loss + part
                    for acc, gi in zip(grads, g):
                        acc.add_(gi)
                    del g
                loss = loss / nm
                grads = [acc.div_(nm) for acc in grads]
            else:
                loss, grads = loss_grads(leaves, tokens, targets)
        del leaves
        opt_lib.adamw_update_(params, tree_unflatten(params, grads),
                              state["opt"], opt_cfg)
        return state, {"loss": loss}

    return train_step


def init_train_state(params: Any, opt_cfg: opt_lib.AdamWConfig) -> dict:
    return {"params": params, "opt": opt_lib.init_opt_state(params, opt_cfg)}


def train_state_shapes(params_shapes: Any,
                       opt_cfg: opt_lib.AdamWConfig) -> dict:
    """The train state's tree as meta tensors, from the params' (e.g.
    `transformer.param_shapes`)."""
    return {"params": params_shapes,
            "opt": opt_lib.opt_state_shapes(params_shapes, opt_cfg)}
