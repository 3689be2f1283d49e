"""Throughput benchmarks: data loader / train step / detector train step / eval step
(port of ``tools/benchmark.py``, detectron2's ``tools/benchmark.py:69-134``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.benchmark --task data|train|train-det|eval \\
        [--train-json T.json --image-dir D] [--model pose_hrnet] [--num-joints 11] [--input-size 512] \\
        [--batch-size 32] [--device cpu]

A step's time is the JAX tool's marginal cost between two loop lengths:
the best of 3 runs of n2 steps less the best of 3 runs of n1, over
n2 - n1 (after one warm-up run of each), each run ending in a readback of
its last loss and ``torch.cuda.synchronize()``. The loop lengths are the
JAX tool's: (2, 8) train steps, (1, 4) detector train steps, (2, 10) eval
steps; the data loader times 20 batches after a warm one. The models run
in bf16 over float32 weights from seed 0, as the JAX tool's do.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def marginal_seconds(run: Callable[[int], float], n1: int, n2: int, device: torch.device) -> float:
    """(best of 3 runs of ``n2`` - best of 3 runs of ``n1``) / (n2 - n1)
    seconds, after a warm-up run of each; ``run(n)`` does n steps and
    returns a float read back from the last."""

    def timed(n: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        run(n)
        _sync(device)
        return time.perf_counter() - t0

    timed(n1)
    timed(n2)
    t1 = min(timed(n1) for _ in range(3))
    t2 = min(timed(n2) for _ in range(3))
    return (t2 - t1) / (n2 - n1)


def train_batch(batch_size: int, size: int, num_joints: int, device) -> dict:
    """The JAX tool's landmark batch from ``np.random.default_rng(0)``:
    joints uniform in the input, targets (sigma 2 at a quarter of the size)
    from ``ops.heatmap.generate_target``, N(0, 1) images."""
    from ..ops import heatmap

    rng = np.random.default_rng(0)
    joints = rng.uniform(0, size, (batch_size, num_joints, 2)).astype(np.float32)
    hm = size // 4
    target, weight = heatmap.generate_target(torch.from_numpy(joints), torch.ones(batch_size, num_joints),
                                             (size, size), (hm, hm), 2.0)
    image = rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return {"image": torch.from_numpy(image).to(device), "target": target.to(device),
            "target_weight": weight.to(device)}


def detection_batch(batch_size: int, size: int, device) -> dict:
    """The JAX tool's detector batch from ``np.random.default_rng(0)``: one
    box an image spread over the frame (the spacecraft contract), images
    N(120, 60)."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, size * 0.6, (batch_size, 1))
    y0 = rng.uniform(0, size * 0.6, (batch_size, 1))
    wh = rng.uniform(size * 0.15, size * 0.35, (batch_size, 2))
    image = rng.normal(0, 60, (batch_size, size, size, 3)).astype(np.float32) + 120
    boxes = np.concatenate([x0, y0, x0 + wh[:, :1], y0 + wh[:, 1:]], 1)[:, None, :].astype(np.float32)
    return {"image": torch.from_numpy(image).to(device), "gt_boxes": torch.from_numpy(boxes).to(device),
            "gt_classes": torch.zeros(batch_size, 1, dtype=torch.int32, device=device),
            "gt_valid": torch.ones(batch_size, 1, dtype=torch.bool, device=device)}


def eval_batch(batch_size: int, size: int, device) -> torch.Tensor:
    """The JAX tool's N(0, 1) eval images from ``np.random.default_rng(0)``."""
    x = np.random.default_rng(0).normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def landmark_state(model):
    """The train task's state: Adam at 1e-3."""
    from ..train.optim import build_optimizer
    from ..train.state import TrainState

    return TrainState(model, build_optimizer("adam", model.parameters(), 1e-3))


def detector_state(model):
    """The train-det task's state: SGD at 1e-3, momentum 0.9."""
    from ..train.detection_state import DetTrainState
    from ..train.optim import build_optimizer

    return DetTrainState(model, build_optimizer("sgd", model.parameters(), 1e-3, momentum=0.9))


def detector_config(name: str):
    """A ``models.zoo.DETECTOR_PRESETS`` name's config, else an attribute of ``models.rcnn`` (``RCNN_TINY``)."""
    from ..models import rcnn
    from ..models.zoo import DETECTOR_PRESETS

    return DETECTOR_PRESETS[name].config if name in DETECTOR_PRESETS else getattr(rcnn, name)


def benchmark_data(args, device) -> dict:
    from ..data.landmark_dataset import LandmarkExamples, batch_iterator

    examples = LandmarkExamples(args.train_json, args.image_dir)
    it = batch_iterator(examples, args.batch_size, seed=0)
    next(it)  # warm
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        next(it)
    dt = time.perf_counter() - t0
    print(f"data loader: {n * args.batch_size / dt:.1f} images/s")
    return {"images_per_s": n * args.batch_size / dt}


def benchmark_train(args, device) -> dict:
    from ..models import build_landmark_model
    from ..train.state import make_train_step

    size, b = args.input_size, args.batch_size
    model = build_landmark_model(args.model, args.num_joints, device=device, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
    state = landmark_state(model)
    batch = train_batch(b, size, args.num_joints, device)
    step = make_train_step()

    def run(n: int) -> float:
        for _ in range(n):
            loss = step(state, batch)["loss"]
        return float(loss)

    dt = marginal_seconds(run, 2, 8, device)
    print(f"train step ({args.model} {size}^2 b{b}): "
          f"{dt * 1e3:.1f} ms/step, {b / dt:.1f} images/s")
    return {"ms_per_step": dt * 1e3, "images_per_s": b / dt}


def benchmark_train_det(args, device) -> dict:
    """Detector train-step throughput (the BASELINE row's counterpart:
    Faster R-CNN X101-FPN 3x trains at 0.638 s/iter at batch 16 on
    8x V100, MODEL_ZOO.md:192-199 — i.e. 25.1 images/s cluster-wide).
    Step i's sampling draws come from ``landmark_loop.step_generator(0, i)``."""
    from ..models.rcnn import GeneralizedRCNN
    from ..train.detection_state import make_detection_train_step
    from ..train.landmark_loop import step_generator

    size, b = args.input_size, args.batch_size
    model = GeneralizedRCNN(detector_config(args.model), dtype=torch.bfloat16, device=device,
                            generator=torch.Generator().manual_seed(0))
    state = detector_state(model)
    batch = detection_batch(b, size, device)
    step = make_detection_train_step()

    def run(n: int) -> float:
        for i in range(n):
            loss = step(state, batch, generator=step_generator(0, i))["loss_total"]
        return float(loss)

    dt = marginal_seconds(run, 1, 4, device)
    print(f"detector train step ({args.model} {size}^2 b{b}): "
          f"{dt * 1e3:.1f} ms/step ({dt:.3f} s/iter), {b / dt:.1f} images/s")
    return {"ms_per_step": dt * 1e3, "images_per_s": b / dt}


def benchmark_eval(args, device) -> dict:
    from ..models import build_landmark_model

    size, b = args.input_size, args.batch_size
    model = build_landmark_model(args.model, args.num_joints, device=device, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
    model.eval()
    x = eval_batch(b, size, device)

    @torch.inference_mode()
    def run(n: int) -> float:
        # each forward depends on the last, as the JAX tool's scan carry
        c = torch.zeros((), device=device)
        for _ in range(n):
            c = c + torch.sum(model(x + c * 1e-20).float()) * 1e-20
        return float(c)

    dt = marginal_seconds(run, 2, 10, device)
    print(f"eval step ({args.model} {size}^2 b{b}): "
          f"{dt * 1e3:.1f} ms/step, {b / dt:.1f} images/s")
    return {"ms_per_step": dt * 1e3, "images_per_s": b / dt}


TASKS = {"data": benchmark_data, "train": benchmark_train, "train-det": benchmark_train_det, "eval": benchmark_eval}


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=list(TASKS), required=True)
    ap.add_argument("--train-json")
    ap.add_argument("--image-dir")
    ap.add_argument("--model", default="pose_hrnet")
    ap.add_argument("--num-joints", type=int, default=11)
    ap.add_argument("--input-size", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return TASKS[args.task](args, resolve_device(args.device))


if __name__ == "__main__":
    main()
