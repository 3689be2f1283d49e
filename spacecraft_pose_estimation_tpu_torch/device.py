"""Device policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no CUDA device and no explicit ``device`` this raises instead of
    silently running on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")
