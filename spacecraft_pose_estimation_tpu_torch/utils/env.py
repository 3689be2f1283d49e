"""Environment helpers: seeding and an environment report (port of
``utils/env.py``, detectron2's ``utils/env.py`` ``seed_all_rng`` and
``collect_env.py``)."""

from __future__ import annotations

import datetime
import os
import random
import sys

import numpy as np
import torch


def seed_all_rng(seed: int | None = None) -> int:
    """Seed Python, numpy and torch's global generator, and return the seed.

    Python and numpy are seeded as the JAX package seeds them, so the same
    draws follow the same seed. The port's own code draws from explicit
    ``torch.Generator``s, which this leaves alone."""
    if seed is None:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        ) % (2**31)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def collect_env_info() -> str:
    """Versions, devices and the process group, one ``key: value`` a line
    (the JAX package's rows with torch's counterparts: torch, CUDA and
    cuDNN for jax; the CUDA devices for jax's; rank / world size for
    process index / count)."""
    import torch.distributed as dist

    cuda = torch.cuda.is_available()
    lines = [
        f"python: {sys.version.split()[0]}",
        f"torch: {torch.__version__}",
        f"cuda: {torch.version.cuda}",
        f"cudnn: {torch.backends.cudnn.version() if cuda else None}",
        f"numpy: {np.__version__}",
        f"backend: {'cuda' if cuda else 'cpu'}",
        f"device_count: {torch.cuda.device_count() if cuda else 0}",
        f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else ['cpu']}",
    ]
    if cuda:
        lines.append(f"capability: {'.'.join(map(str, torch.cuda.get_device_capability()))}")
    if dist.is_available() and dist.is_initialized():
        lines.append(f"process: {dist.get_rank()}/{dist.get_world_size()}")
    return "\n".join(lines)
