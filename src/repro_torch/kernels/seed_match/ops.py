"""The public entry of the seed weights' slot match: the kernel or its
plain twin, behind the sorted-key bins it folds into."""
from __future__ import annotations

import torch

from repro_torch.kernels.seed_match import kernel


def max_live_weight(src: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor, w: torch.Tensor,
                    row_keys: torch.Tensor, key: str) -> torch.Tensor:
    """For each of U >= 1 row keys (int64 [U], `kernel.slot_key` of kind
    `key`), the maximum of w over the live slots whose key equals it, and 0
    where none does: int32 [U].

    Sorts the row keys on their device, folds every slot into the bin of
    its key's first sorted position (`kernel.seed_match`: the CUDA kernel
    for CUDA tensors, `seed_match_plain` for CPU tensors), and reads each
    row's bin back.
    """
    sorted_keys, _ = torch.sort(row_keys)
    acc = kernel.seed_match(src, dst, valid, w, sorted_keys, key)
    return acc[torch.searchsorted(sorted_keys, row_keys)]
