"""Masked segment-min: the reduction behind the COO reference sweep."""
from __future__ import annotations

import torch


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
