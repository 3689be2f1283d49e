"""Mesh construction, sharding rules and data parallelism (port of ``parallel/mesh.py``).

The reference's parallelism inventory (SURVEY.md §2.7) is data-parallel
only (torch DataParallel / DDP + NCCL all-reduce). The JAX package maps it
onto a compiled mesh; the port maps it back onto ``torch.distributed``:

* a 2-D ``DeviceMesh`` ``(data, model)`` over the process group's ranks,
  a rank a device; the model axis is 1 for the small CNNs of this domain
  but kept first-class, as in the JAX package;
* batches split over ``data`` (each rank holds its slice of the leading
  axis), parameters replicated from rank 0;
* :func:`data_parallel`: DDP's gradient all-reduce over ``data`` (the psum
  XLA inserts) and every ``BatchNorm`` of the port switched to the global
  batch's statistics, which the JAX package's ``jit`` over a sharded batch
  computes and DDP alone would not (NaiveSyncBatchNorm, detectron2
  ``layers/batch_norm.py:152-212``, made exact).

The backend is NCCL on CUDA and gloo on the CPU. Without a process group,
:func:`make_mesh` starts one from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or, where
those are not set, a group of one process.
"""

from __future__ import annotations

import inspect
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _start_process_group(device: torch.device) -> None:
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if all(v in os.environ for v in _TORCHRUN_VARS):
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(device_type: str | None = None, model_parallel: int = 1):
    """(data, model) ``DeviceMesh`` over every rank of the process group
    (started if none is up), on ``device_type``: CUDA unless the caller
    names another (e.g. "cpu"), raising where the card is missing."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device_type)
    _start_process_group(device)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(device.type, (n // model_parallel, model_parallel), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh, ndim: int = 4) -> tuple:
    """The placements of a batch on ``mesh``, one a mesh axis: its leading
    (batch) axis sharded over ``data``, replicated over the rest
    (``P('data', None, ...)``; ``ndim`` is the batch's rank, whose other
    axes are whole on every rank)."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError(f"a batch has a leading axis to shard, got ndim={ndim}")
    return tuple(Shard(0) if name == DATA_AXIS else Replicate() for name in mesh.mesh_dim_names)


def _device(mesh) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's slice of every leaf's leading axis (tensors or arrays),
    as a tensor on the rank's device: the rank's shard of ``batch_sharding``.
    The leading axis must divide by the data axis's size."""
    size, index = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)), mesh.get_local_rank(DATA_AXIS)
    device = _device(mesh)

    def shard(x):
        x = torch.as_tensor(x)
        if x.shape[0] % size:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {size} data shards")
        k = x.shape[0] // size
        return x[index * k:(index + 1) * k].to(device).contiguous()

    return _tree_map(shard, batch)


def replicate(tree: Any, mesh) -> Any:
    """Every tensor or array leaf of ``tree`` as rank 0 holds it, broadcast
    to every rank and put on the rank's device (copies: the caller's
    tensors are left as they were)."""
    device = _device(mesh)

    def rep(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        t = torch.as_tensor(x).to(device).clone()
        dist.broadcast(t, src=0)
        return t

    return _tree_map(rep, tree)


def data_parallel(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``model`` in DDP over the mesh's data axis, every port ``BatchNorm``
    in it taking its train-mode statistics over the global batch
    (``layers.BatchNorm.process_group``). DDP broadcasts rank 0's
    parameters and buffers once; the running statistics then stay equal on
    every rank, so they are not broadcast again at each forward."""
    from torch.nn.parallel import DistributedDataParallel

    from ..models.layers import BatchNorm

    group = mesh.get_group(DATA_AXIS)
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.process_group = group
    device_ids = [torch.cuda.current_device()] if mesh.device_type == "cuda" else None
    # newer PyTorch names the per-forward buffer sync apart from the sync at construction
    no_forward_sync = ({"forward_sync_buffers": False}
                       if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                       else {"broadcast_buffers": False})
    return DistributedDataParallel(model, device_ids=device_ids, process_group=group, **no_forward_sync)
