"""The reference's two row gathers, which treat out-of-range ids apart.

`take_rows` is `jnp.take(table, idx, axis=0)`: an index with
-N <= idx < 0 wraps to idx + N; any other index outside [0, N) gives a
NaN row and, in the backward pass, no gradient (JAX's `take` fills
out-of-range rows with NaN and drops their scatter).

`index_rows` is `x[idx]`, JAX's plain indexing: every negative index
wraps to idx + N, and what is still outside [0, N) is clamped to the
nearest row. Its backward pass scatters only the rows whose wrapped
index lies in [0, N): the clamped ones get no gradient, as XLA's scatter
drops out-of-range updates. So `arange(5.)[[-1, -6, 5, 7]]` is
`[4, 0, 4, 4]`, and only the first of the four passes a gradient back.

Torch's own indexing raises on the CPU, and asserts on the card, for
either kind of id.
"""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, ...] → [*idx.shape, ...] under `jnp.take`'s rule."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    outside = (idx < 0) | (idx >= n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    outside = outside.reshape(outside.shape + (1,) * (table.dim() - 1))
    return torch.where(outside, torch.nan, rows)


class _IndexRows(torch.autograd.Function):
    """Forward: the clamped rows. Backward: a scatter-add whose
    out-of-range rows go to a scratch row past the end, cut away."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        idx = idx.to(torch.int64)
        idx = torch.where(idx < 0, idx + n, idx)
        ctx.n, ctx.idx_shape = n, idx.shape
        if ctx.needs_input_grad[0]:
            inside = (idx >= 0) & (idx < n)
            ctx.save_for_backward(torch.where(inside, idx, n).reshape(-1))
        return x.index_select(0, idx.clamp(0, n - 1).reshape(-1)) \
            .reshape(idx.shape + x.shape[1:])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (scatter,) = ctx.saved_tensors
        g = grad.reshape((scatter.shape[0],) + grad.shape[len(ctx.idx_shape):])
        out = torch.zeros((ctx.n + 1,) + g.shape[1:], dtype=g.dtype,
                          device=g.device)
        return out.index_add_(0, scatter, g)[:ctx.n], None


def index_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, ...] → [*idx.shape, ...] under the rule of JAX's `x[idx]`."""
    return _IndexRows.apply(x, idx)
