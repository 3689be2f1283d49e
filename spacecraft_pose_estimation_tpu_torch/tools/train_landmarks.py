"""Train a landmark model: the reference's ``tools/train.py`` (port of ``tools/train_landmarks.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.train_landmarks --preset events \\
        --train-json train.json --image-dir DIR [--val-json validation.json] --output OUT \\
        [--device cpu] [KEY VALUE ...]

The config (preset, then ``--cfg`` YAML, then overrides) -> the model from
``build_landmark_model`` -> the optimizer with the per-epoch LR milestones
turned into steps -> the epoch loop: the training transform and train step
on every batch, periodic checkpoints, and with ``--val-json`` the
validation pass after every epoch (``pred_val.mat``, ``val_mean_conf``, the
best checkpoint) -> the final checkpoint. ``TRAIN.AUTO_RESUME`` restores
the latest checkpoint in ``OUT/checkpoints``. Each checkpoint's
``model.npz`` is what ``tools/test_landmarks --checkpoint`` reads.

The frames are uploaded once to the device and batches gathered there
when the split fits ``SPE_DEVICE_CACHE_CAP_GB`` (default 2.0) of uint8;
``SPE_DEVICE_CACHE=0`` turns that off. It runs on CUDA unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

import torch

from .. import config as C
from ..data.landmark_dataset import DeviceDatasetCache, LandmarkExamples, batch_iterator, index_iterator
from ..device import resolve_device
from ..models import build_landmark_model
from ..train import landmark_loop
from ..train.checkpoint import CheckpointManager
from ..train.metrics import JSONWriter, MetricStorage, TensorboardWriter
from ..train.optim import build_optimizer, multistep_schedule
from ..train.state import TrainState, make_train_step

logger = logging.getLogger("train_landmarks")


def device_cache(examples: LandmarkExamples, device) -> DeviceDatasetCache | None:
    """The device-resident dataset when ``SPE_DEVICE_CACHE`` is not ``0`` and
    the split's uint8 frames fit ``SPE_DEVICE_CACHE_CAP_GB``."""
    if os.environ.get("SPE_DEVICE_CACHE", "1") == "0":
        return None
    cap = float(os.environ.get("SPE_DEVICE_CACHE_CAP_GB", "2.0"))
    first = examples.load_image(0)
    est = len(examples) * first.numel() * first.element_size() if isinstance(first, torch.Tensor) \
        else len(examples) * first.nbytes
    if est > cap * 1e9:
        logger.info("device dataset cache off: %.1f GB > cap %.1f GB", est / 1e9, cap)
        return None
    cache = DeviceDatasetCache(examples, device)
    logger.info("device dataset cache: %d frames, %.0f MB uint8 on %s", len(examples), cache.nbytes / 1e6, device)
    return cache


def train(cfg: C.ExperimentConfig, train_examples: LandmarkExamples, output: str, device=None,
          val_examples: LandmarkExamples | None = None) -> TrainState:
    """Train ``cfg.model`` on ``train_examples``, checkpoints and metrics
    under ``output``; returns the final state."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    model = build_landmark_model(cfg.model.name, train_examples.num_joints, device=device, dtype=dtype,
                                 generator=torch.Generator().manual_seed(cfg.seed))
    batch = cfg.train.batch_size_per_chip
    steps_per_epoch = max(len(train_examples) // batch, 1)
    milestones = [m * steps_per_epoch for m in cfg.train.lr_step]  # MultiStepLR per epoch -> per step
    optimizer = build_optimizer(cfg.train.optimizer, model.parameters(),
                                multistep_schedule(cfg.train.lr, milestones, cfg.train.lr_factor),
                                weight_decay=cfg.train.wd, momentum=cfg.train.momentum,
                                nesterov=cfg.train.nesterov)
    state = TrainState(model, optimizer)

    mgr = CheckpointManager(os.path.join(output, "checkpoints"))
    begin_epoch = cfg.train.begin_epoch
    if cfg.train.auto_resume:
        restored = mgr.restore(state)
        if restored:
            _, meta, step_no = restored
            begin_epoch = meta.get("epoch", 0) + 1
            logger.info("resumed from step %d (epoch %d)", step_no, begin_epoch)

    step_fn = make_train_step(cfg.loss.use_target_weight)
    storage = MetricStorage()
    writers = [JSONWriter(os.path.join(output, "metrics.json")), TensorboardWriter(os.path.join(output, "tb"))]
    cache = device_cache(train_examples, device)
    # a resumed run goes on with the batch after the last one it took
    if cache is not None:
        data_iter = index_iterator(len(train_examples), batch, shuffle=cfg.train.shuffle, seed=cfg.seed,
                                   start=state.step)
    else:
        data_iter = batch_iterator(train_examples, batch, shuffle=cfg.train.shuffle, seed=cfg.seed,
                                   start=state.step)
    transform_kwargs = dict(
        image_size=tuple(cfg.model.image_size), heatmap_size=tuple(cfg.model.heatmap_size),
        sigma=cfg.model.sigma, train=True, scale_factor=cfg.dataset.scale_factor,
        rot_factor=cfg.dataset.rot_factor, upper_body_ids=tuple(cfg.dataset.upper_body_ids),
        num_joints_half_body=cfg.dataset.num_joints_half_body, prob_half_body=cfg.dataset.prob_half_body,
    )
    try:
        for epoch in range(begin_epoch, cfg.train.end_epoch):
            landmark_loop.train_epoch(step_fn, state, data_iter, steps_per_epoch, storage, transform_kwargs,
                                      cfg.seed + 1, print_freq=cfg.print_freq, cache=cache)
            for w in writers:
                w.write(storage)
            if (epoch + 1) % max(cfg.train.checkpoint_period, 1) == 0 or epoch == cfg.train.end_epoch - 1:
                mgr.save(state.step, state, {"epoch": epoch})
            if val_examples is not None:
                preds = landmark_loop.validate(
                    model, val_examples, cfg.test.batch_size_per_chip, tuple(cfg.model.image_size),
                    output_path=os.path.join(output, "pred_val.mat"), flip_test=cfg.test.flip_test,
                    post_process=cfg.test.post_process, shift_heatmap=cfg.test.shift_heatmap)
                mean_conf = float(preds[:, :, 2].mean())
                storage.put_scalar("val_mean_conf", mean_conf)
                if mgr.save_best(state.step, mean_conf, state=state):
                    logger.info("new best at epoch %d", epoch)
            logger.info("epoch %d done (step %d)", epoch, state.step)
        mgr.save(state.step, state, {"epoch": cfg.train.end_epoch - 1, "final": True})
    finally:
        for w in writers:
            w.close()
    logger.info("training complete")
    return state


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="events")
    ap.add_argument("--cfg", default=None, help="a YAML file of config keys (needs PyYAML)")
    ap.add_argument("--train-json", required=True)
    ap.add_argument("--val-json", default=None)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--val-image-dir", default=None, help="validation frames dir (defaults to --image-dir)")
    ap.add_argument("--output", default="output")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = C.get_preset(args.preset)
    if args.cfg:
        cfg = C.load_yaml(cfg, args.cfg)
    cfg = C.apply_overrides(cfg, args.opts)
    logger.info("config: %s", cfg)
    val = LandmarkExamples(args.val_json, args.val_image_dir or args.image_dir) if args.val_json else None
    train(cfg, LandmarkExamples(args.train_json, args.image_dir), args.output, device, val)


if __name__ == "__main__":
    main()
