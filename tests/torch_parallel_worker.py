"""One rank of ``tests/test_torch_parallel.py``'s data-parallel checks (not a test module).

    python torch_parallel_worker.py RANK WORLD INIT_FILE WORK_DIR

joins a gloo group through ``file://INIT_FILE`` and runs, on the CPU with
one thread, the checks whose inputs the test wrote into ``WORK_DIR``
(``hrnet.pt``, ``batch.npz``, ``images.npy``): the mesh's layout, the data-
parallel train step of ``HRNET_TINY`` with global-batch BatchNorm and, as
a control, with rank-local BatchNorm, the data-parallel detection forward
of ``RCNN_TINY``, and the gathers. It writes ``rank{RANK}.json`` and the
trained parameters ``{global,local}_{RANK}.pt``; it imports no JAX.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def detector():
    """``RCNN_TINY`` from seed 0, its stem scaled down so that raw 0-255 pixels do not saturate the logits."""
    from spacecraft_pose_estimation_tpu_torch.models.rcnn import RCNN_TINY, GeneralizedRCNN

    det = GeneralizedRCNN(RCNN_TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        det.backbone.stem.conv.weight.mul_(1e-2)
    return det


def landmark_model(work_dir):
    from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet

    model = HRNet(HRNET_TINY.with_joints(3), device="cpu")
    model.load_state_dict(torch.load(os.path.join(work_dir, "hrnet.pt"), weights_only=True))
    return model


def main(rank: int, world: int, init_file: str, work_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    from spacecraft_pose_estimation_tpu_torch.models.layers import BatchNorm
    from spacecraft_pose_estimation_tpu_torch.parallel import (
        batch_sharding, data_parallel, make_mesh, multihost, replicate, shard_batch,
    )
    from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer
    from spacecraft_pose_estimation_tpu_torch.train.state import TrainState, make_train_step

    out = {"world_size": multihost.get_world_size(), "rank": multihost.get_rank(),
           "is_main": multihost.is_main_process()}
    mesh = make_mesh("cpu")
    out["mesh"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names), "device": mesh.device_type}
    try:
        make_mesh("cpu", model_parallel=3)
        out["mp3"] = "built"
    except ValueError as e:
        out["mp3"] = str(e)
    out["placements"] = [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
                         for p in batch_sharding(mesh, 4)]
    with np.load(os.path.join(work_dir, "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    shard = shard_batch(batch, mesh)
    k = 16 // world
    out["shard_shapes"] = {key: list(v.shape) for key, v in shard.items()}
    out["shard_is_slice"] = all(np.array_equal(v.numpy(), batch[key][rank * k:(rank + 1) * k])
                                for key, v in shard.items())
    rep = replicate({"w": torch.full((4, 4), float(rank)), "n": np.arange(3) + rank, "tag": "kept"}, mesh)
    out["replicated"] = {"w": rep["w"].tolist(), "n": rep["n"].tolist(), "tag": rep["tag"]}

    for mode in ("global", "local"):
        model = landmark_model(work_dir)
        ddp = data_parallel(model, mesh)
        n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
        if mode == "local":  # the control: DDP alone, each rank normalizing by its own shard
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.process_group = None
        state = TrainState(ddp, build_optimizer("sgd", model.parameters(), 1e-2))
        metrics = make_train_step()(state, shard)
        out[mode] = {"loss": multihost.reduce_dict({"loss": float(metrics["loss"])})["loss"],
                     "loss_sum": multihost.reduce_dict({"loss": float(metrics["loss"])}, average=False)["loss"],
                     "batchnorms": n_bn, "no_grad": [n for n, p in model.named_parameters() if p.grad is None]}
        torch.save(model.state_dict(), os.path.join(work_dir, f"{mode}_{rank}.pt"))

    images = np.load(os.path.join(work_dir, "images.npy"))
    det = data_parallel(detector(), mesh)
    with torch.no_grad():
        res = det(shard_batch(images, mesh))
    gathered = multihost.all_gather_objects({key: v.numpy() for key, v in res.items()})
    if multihost.is_main_process():
        np.savez(os.path.join(work_dir, "detections.npz"),
                 **{key: np.concatenate([g[key] for g in gathered]) for key in gathered[0]})
    out["gather"] = multihost.all_gather_objects({"rank": rank, "sq": rank * rank})
    out["mean"] = multihost.reduce_dict({"b": 2.0, "a": float(rank + 1)})
    out["sum"] = multihost.reduce_dict({"b": 2.0, "a": float(rank + 1)}, average=False)
    with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
