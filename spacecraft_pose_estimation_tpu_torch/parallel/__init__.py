"""Device mesh, sharding helpers and data parallelism over ``torch.distributed`` (port of ``parallel/``).

The JAX package's parallelism is compiled: a mesh, sharding annotations,
and XLA inserts the collectives. Here it is the reference's own route
(detectron2 ``engine/launch.py:27-126``, ``utils/comm.py``): a process a
device, a process group (NCCL on CUDA, gloo on the CPU), DDP's gradient
all-reduce, and BatchNorm statistics over the global batch, which the
JAX package's ``jit`` over a sharded batch computes.
"""

from .mesh import (
    batch_sharding,
    data_parallel,
    make_mesh,
    replicate,
    shard_batch,
)
