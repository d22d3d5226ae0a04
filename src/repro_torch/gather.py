"""The reference's row gather, `jnp.take(table, idx, axis=0)`.

An index with -N <= idx < 0 wraps to idx + N. Any other index outside
[0, N) gives a NaN row and, in the backward pass, no gradient (JAX's
`take` fills out-of-range rows with NaN and drops their scatter).
"""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, ...] → [*idx.shape, ...] under the rule above."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    outside = (idx < 0) | (idx >= n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    outside = outside.reshape(outside.shape + (1,) * (table.dim() - 1))
    return torch.where(outside, torch.nan, rows)
