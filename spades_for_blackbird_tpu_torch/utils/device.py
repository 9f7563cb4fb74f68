"""Which device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None, codes=None) -> torch.device:
    """Where an assembly runs. By default the card: the device of
    ``codes`` when that is a tensor on a card, else ``cuda``; without a
    card this raises. The CPU is taken only on request (``"cpu"``)."""
    if device is None:
        on_card = isinstance(codes, torch.Tensor) and codes.is_cuda
        device = codes.device if on_card else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the assembler runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" (--device cpu on the command "
            "line) to run on the CPU")
    return device
