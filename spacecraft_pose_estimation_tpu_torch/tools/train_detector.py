"""Train the spacecraft detector: the reference's ``train_object_detection.py`` (port of ``tools/train_detector.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.train_detector --preset config_1 \\
        --train-json train.json --image-dir DIR [--val-json val.json] --output OUT [--device cpu] [--tiny ...]

The detector of a ``--preset`` (the Faster R-CNN of ``config_1``-
``config_4`` or the R101 RetinaNet of ``config_20``: the reference
registry's model, input size, flip and SOLVER schedule; any explicit flag
overrides its field) or, without one, the X101-FPN of ``config_4`` (the
R101 RetinaNet with ``--arch retinanet``; ``--tiny`` takes ``RCNN_TINY``
or ``RETINANET_TINY``); bf16 activations over float32 weights; SGD with momentum 0.9
and weight decay 1e-4 on every parameter under detectron2's multistep
schedule with warmup; the hook-driven trainer with periodic checkpoints
and, with ``--val-json``, box AP at one detection an image every
``--eval-period`` updates and at the end (``train_object_detection.py:56``).
``OUT/checkpoints/<step>/model.npz`` is what ``evaluate
--detector-checkpoint`` and ``tools.export_boxes --checkpoint`` read; a run
restarted on the same ``OUT`` resumes from the latest checkpoint and goes
on with the batch after its last one. RetinaNet draws nothing for
sampling; its step normalizes the losses by the EMA of the foreground
count (``train/detection_state``), which the checkpoints keep.

``--photometric-augs event|speedplus`` runs the event or SPEED+ stack
(``data/augment.EVENT_STACK`` / ``SPEEDPLUS_STACK``) on each training
batch's letterboxed float32 BGR images before the step, with the draws of
a generator on the device seeded from (42, step). It runs on CUDA unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

import numpy as np
import torch

from ..data import augment
from ..data.coco_eval import evaluate_detections, padded_detections_to_list
from ..data.detection_dataset import DetectionExamples, detection_batches
from ..device import resolve_device
from ..models.rcnn import FASTER_RCNN_X101_SPACECRAFT, RCNN_TINY, GeneralizedRCNN
from ..models.retinanet import RETINANET_TINY, RetinaNet, RetinaNetConfig
from ..models.zoo import build_detector_config, get_detector_preset
from ..train.checkpoint import CheckpointManager
from ..train.detection_state import DetTrainState, make_detection_train_step
from ..train.landmark_loop import step_generator
from ..train.metrics import JSONWriter, MetricStorage, TerminalPrinter
from ..train.optim import build_optimizer, multistep_schedule
from ..train.trainer import EvalHook, IterationTimer, PeriodicCheckpointer, PeriodicWriter, Trainer

logger = logging.getLogger("train_detector")

SAMPLING_SEED = 42  # the JAX tool's jax.random.key(42), folded with the step


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    """The JAX tool's flags, and ``--device``, with the preset's fields
    filled in where a flag is not given (``args.solver`` holds the preset's
    schedule, or None)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-json", required=True)
    ap.add_argument("--val-json", default=None)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--output", default="output/detector")
    ap.add_argument("--preset", default=None,
                    help="reference registry config name (config_1..config_4, config_20): the model, input size, "
                         "flip and SOLVER schedule; an explicit flag overrides its field. config_4 pins the input "
                         "size to the frame height: pass --input-size")
    ap.add_argument("--arch", choices=["faster_rcnn", "retinanet"], default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--eval-period", type=int, default=None)
    ap.add_argument("--checkpoint-period", type=int, default=None)
    ap.add_argument("--flip", action="store_true", help="horizontal flip with p=0.5 (config_1-style)")
    ap.add_argument("--photometric-augs", choices=["none", "event", "speedplus"], default="none",
                    help="the device-side photometric stack run on each training batch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    preset = solver = None
    if args.preset:
        preset = get_detector_preset(args.preset, image_height=args.input_size)
        solver = preset.solver
    if args.arch is None:
        args.arch = preset.arch if preset else "faster_rcnn"
    elif preset and args.arch != preset.arch:
        ap.error(f"--arch {args.arch} conflicts with --preset {args.preset} ({preset.arch}); drop one of the flags")
    if args.input_size is None:
        args.input_size = preset.input_size if preset else 768
    if args.batch_size is None:
        args.batch_size = solver.ims_per_batch if solver else 4
    if args.max_iter is None:
        args.max_iter = solver.max_iter if solver else 6000
    if args.lr is None:
        args.lr = solver.base_lr if solver else 0.00025
    if args.eval_period is None:
        args.eval_period = solver.eval_period if solver else 1000
    if args.checkpoint_period is None:
        args.checkpoint_period = solver.checkpoint_period if solver else 1000
    if preset and not args.flip:
        args.flip = preset.flip
    args.preset_config, args.solver = preset, solver
    return args


def model_config(args: argparse.Namespace):
    """The ``RCNNConfig`` or ``RetinaNetConfig`` of ``args``: the tiny one
    with ``--tiny``, else the preset's, else ``config_4``'s X101-FPN or the
    one-class R101 RetinaNet."""
    retina = args.arch == "retinanet"
    if args.tiny:
        return RETINANET_TINY if retina else RCNN_TINY
    if args.preset_config is not None:
        return build_detector_config(args.preset_config)
    return RetinaNetConfig(num_classes=1) if retina else FASTER_RCNN_X101_SPACECRAFT


def build_model(args: argparse.Namespace, device) -> GeneralizedRCNN | RetinaNet:
    """The detector of ``args`` from seed 0, bf16 activations over float32 weights."""
    arch = RetinaNet if args.arch == "retinanet" else GeneralizedRCNN
    return arch(model_config(args), dtype=torch.bfloat16, device=device, generator=torch.Generator().manual_seed(0))


def build_schedule(args: argparse.Namespace):
    if args.solver is not None:  # the reference registry's exact schedule
        milestones = [s for s in args.solver.steps if s < args.max_iter]
        gamma, warmup = args.solver.gamma, args.solver.warmup_iters
    else:  # detectron2's 3x-style schedule scaled to max_iter
        milestones = [int(args.max_iter * 0.67), int(args.max_iter * 0.89)]
        gamma, warmup = 0.1, min(1000, args.max_iter // 10)
    return multistep_schedule(args.lr, milestones, gamma, warmup_steps=warmup)


PHOTOMETRIC_STACKS = {"none": None, "event": augment.EVENT_STACK, "speedplus": augment.SPEEDPLUS_STACK}


def photometric_augment(images: torch.Tensor, names, step: int, draws=None) -> torch.Tensor:
    """Update ``step``'s photometric stack ``names`` on the (B, H, W, 3)
    float32 batch, with ``draws`` (one dict a stage) or the step's own from
    ``augment.stack_generator(SAMPLING_SEED, step)`` on the images' device."""
    if draws is None:
        gen = augment.stack_generator(SAMPLING_SEED, step, images.device)
        draws = augment.sample_stack(gen, images.shape[0], images.shape[1], images.shape[2], names)
    return augment.apply_stack(images, names, draws)


def evaluate(model: GeneralizedRCNN | RetinaNet, examples: DetectionExamples, batch_size: int, size: int,
             device=None) -> dict[str, float]:
    """Box AP at one detection an image over ``examples``, letterboxed without
    augmentation (the reference's COCOEvaluator(max_dets_per_image=1))."""
    dets_all, gts_all = [], []
    with torch.no_grad():
        for batch in detection_batches(examples, batch_size, (size, size), train=False, augment=False,
                                       device=device):
            count = batch["count"]
            dets_all.extend(padded_detections_to_list(model(batch["image"]))[:count])
            boxes, valid = batch["gt_boxes"].cpu().numpy(), batch["gt_valid"].cpu().numpy()
            gts_all.extend({"boxes": boxes[i][valid[i]]} for i in range(count))
    return evaluate_detections(dets_all, gts_all, max_dets=1)


def train(args: argparse.Namespace, train_examples: DetectionExamples,
          val_examples: DetectionExamples | None = None, device=None) -> Trainer:
    """Train the detector of ``args`` (from :func:`parse_args`) on
    ``train_examples``, checkpoints and metrics under ``args.output``;
    returns the trainer (its ``state`` and ``storage``)."""
    device = resolve_device(device if device is not None else args.device)
    model = build_model(args, device)
    logger.info("model params: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer = build_optimizer("sgd", model.parameters(), build_schedule(args), weight_decay=1e-4, momentum=0.9)
    state = DetTrainState(model, optimizer)
    mgr = CheckpointManager(os.path.join(args.output, "checkpoints"))
    if mgr.restore(state):
        logger.info("resumed at update %d", state.step)
    size = args.input_size
    data = detection_batches(train_examples, args.batch_size, (size, size), train=True, flip=args.flip,
                             device=device, start=state.step)
    retina = args.arch == "retinanet"
    raw_step = make_detection_train_step(needs_sampling_rng=not retina, ema_loss_normalizer=retina)
    stack = PHOTOMETRIC_STACKS[args.photometric_augs]

    def step_fn(state, batch):
        if stack is not None:
            batch = dict(batch, image=photometric_augment(batch["image"], stack, state.step))
        return raw_step(state, batch, generator=step_generator(SAMPLING_SEED, state.step))

    storage = MetricStorage()
    hooks = [
        IterationTimer(),
        PeriodicWriter([JSONWriter(os.path.join(args.output, "metrics.json")), TerminalPrinter(args.max_iter)],
                       period=20),
        PeriodicCheckpointer(mgr, args.checkpoint_period),
    ]
    trainer = Trainer(step_fn, state, data, hooks, storage)
    if val_examples is not None:
        def run_eval(tr):
            res = evaluate(tr.state.model, val_examples, args.batch_size, size, device)
            logger.info("eval: %s", res)
            return {f"bbox/{k}": v for k, v in res.items() if np.isfinite(v)}

        trainer.hooks.append(EvalHook(args.eval_period, run_eval))
    trainer.train(state.step, args.max_iter)
    mgr.save(state.step, state, {"final": True})
    logger.info("done")
    return trainer


def main(argv: Sequence[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    val = DetectionExamples(args.val_json, args.image_dir) if args.val_json else None
    train(args, DetectionExamples(args.train_json, args.image_dir), val, device)


if __name__ == "__main__":
    main()
