"""Multi-process coordination: object and metric gathers across processes (port of ``parallel/multihost.py``).

detectron2's ``utils/comm.py:19-170`` (``get_world_size``, ``get_rank``,
``all_gather``, ``reduce_dict``, used by evaluators to merge per-rank
predictions) over the ``torch.distributed`` process group. Without a
group, or in a group of one, each degrades to the world-size-1 no-op, as
the reference and the JAX package do.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _group_up() else 1


def get_rank() -> int:
    return dist.get_rank() if _group_up() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def all_gather_objects(obj: Any) -> list[Any]:
    """Gather arbitrary picklable objects from every process, in rank order (comm.py all_gather)."""
    if get_world_size() == 1:
        return [obj]
    out: list[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _collective_device() -> torch.device:
    """Where the default group's collectives take tensors: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(metrics: dict[str, float], average: bool = True) -> dict[str, float]:
    """Average (or sum) scalar metrics across processes (comm.reduce_dict):
    the values, sorted by key, in one float64 all-reduce."""
    if get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=_collective_device())
    dist.all_reduce(vec)
    if average:
        vec /= get_world_size()
    return {k: float(v) for k, v in zip(keys, vec.cpu().tolist())}
