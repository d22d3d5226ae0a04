"""Embedding bag with a validity mask and sum / mean modes."""
from __future__ import annotations

import torch

from repro_torch.kernels.embed_bag import kernel


def embed_bag(table: torch.Tensor, idx: torch.Tensor,
              mask: torch.Tensor | None = None,
              mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag(table, idx) over the slots `mask` keeps.

    table [N, D]; idx [B, L] int32; mask [B, L] bool. Masked-off slots
    read row 0 with weight 0; `mean` divides by max(kept slots, 1). The
    device of `table` picks the kernel or its plain version.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    if mask is not None:
        w = w * mask.to(torch.float32)
        idx = torch.where(mask, idx, 0)
    if mode == "mean":
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1.0)
    return kernel.embed_bag(table, idx, w)
