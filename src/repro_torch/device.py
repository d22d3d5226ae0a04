"""The device rule shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on.

    `None` means the GPU: it raises when no CUDA device is present rather
    than falling back to the CPU. Callers that want the CPU (the tests,
    which use the kernels' plain versions) pass `device="cpu"`.

    It also turns off cuBLAS's reduced-precision reduction of bfloat16
    products (on by default in PyTorch), so that the split-K partial
    sums of the port's bfloat16 GEMMs add in float32, as the reference's
    `preferred_element_type=float32` products do.
    """
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # Name the card as tensors do, so device checks compare equal.
        device = torch.device("cuda", torch.cuda.current_device())
    return device
