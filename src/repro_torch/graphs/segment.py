"""Masked segment ops: the message-passing substrate.

The port of `repro.graphs.segment`. `masked_segment_min` is the
reduction behind the COO reference sweep and takes its planes on the
leading axes. The other four keep the reference's layout, the segment
axis first, and its rule for ids outside [0, num_segments): like
`jax.ops.segment_sum`, they drop them, negative ids included (torch's
scatters would raise on the CPU and assert on the card). A dropped or
masked-out entry is sent to a scratch segment past the end, which is cut
away, so no masked copy of `data` is made. Sum and mean are
differentiable; a dropped entry gets no gradient, as under JAX.
"""
from __future__ import annotations

import torch

from repro_torch.gather import index_rows


def masked_segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, mask: torch.Tensor,
                       fill: int) -> torch.Tensor:
    """segment_min over masked entries of `data` [..., E]; empty segments
    get `fill`. Leading axes are planes: the result is [..., num_segments].

    `segment_ids` is [E] (shared by every plane); `mask` is [E] or
    [..., E].
    """
    data = torch.where(mask, data, fill)
    out = torch.full(data.shape[:-1] + (num_segments,), fill,
                     dtype=data.dtype, device=data.device)
    index = segment_ids.to(torch.int64).expand(data.shape)
    return out.scatter_reduce_(-1, index, data, "amin", include_self=True)


def _scratch_ids(segment_ids: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None) -> torch.Tensor:
    """int64 ids with every dropped or masked-out entry at num_segments."""
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask
    return torch.where(keep, ids, num_segments)


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: torch.Tensor | None) -> torch.Tensor:
    """data [E, ...] → [num_segments, ...]: the sum of each segment's
    entries whose `mask` [E] is set (all of them when `mask` is None)."""
    ids = _scratch_ids(segment_ids, num_segments, mask)
    out = torch.zeros((num_segments + 1,) + data.shape[1:],
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, mask: torch.Tensor,
                       fill) -> torch.Tensor:
    """data [E, ...] → [num_segments, ...]: the max of each segment's
    masked-in entries and `fill`, so an empty segment gets `fill`."""
    ids = _scratch_ids(segment_ids, num_segments, mask)
    out = torch.full((num_segments + 1,) + data.shape[1:], fill,
                     dtype=data.dtype, device=data.device)
    index = ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand(
        data.shape)
    return out.scatter_reduce_(0, index, data, "amax",
                               include_self=True)[:num_segments]


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int,
                        mask: torch.Tensor) -> torch.Tensor:
    """The mean of each segment's masked-in entries; 0 where none."""
    s = masked_segment_sum(data, segment_ids, num_segments, mask)
    cnt = masked_segment_sum(mask.to(data.dtype), segment_ids, num_segments,
                             None).clamp_min(1)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - cnt.dim()))


def edge_relax_sweep(keys: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, edge_mask: torch.Tensor,
                     step, n: int, inf) -> torch.Tensor:
    """One relaxation wave: cand[v] = min over valid edges (u, v) of
    keys[u] + step, saturated at `inf`; `inf` where v has none.

    The reference's minimal form of the sweep (the BatchHL paths go
    through `core.engine.relax_sweep`). `keys` is [V] or [..., V], whose
    leading axes are planes; `keys[u]` follows JAX's indexing rule
    (`gather.index_rows`).
    """
    gathered = index_rows(keys.movedim(-1, 0), src).movedim(0, -1)
    cand = torch.clamp_max(gathered + step, inf)
    return masked_segment_min(cand, dst, n, edge_mask, inf)
