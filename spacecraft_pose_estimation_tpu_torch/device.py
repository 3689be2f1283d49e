"""Device policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no CUDA device this raises for CUDA, named or by default, instead of
    silently running on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu on the "
            "command line) to run the plain PyTorch versions on the CPU"
        )
    return device
