"""Landmark model over the boxes of a COCO json -> pred.mat, the second stage of the staged evaluation.

Port of ``tools/test_landmarks.py`` (the reference's ``tools/test.py``):
``train.landmark_loop.validate`` over the json's annotations, with the
config's flip test, or, with several checkpoints, the mean of their
heatmaps (``train.ensemble``; no flip test, as the JAX tool); the
keypoint-OKS AP is printed when the json carries labeled keypoints.

    python -m spacecraft_pose_estimation_tpu_torch.tools.test_landmarks \\
        --test-json real_test.json --image-dir DIR --checkpoint hrnet.npz [more.npz ...] \\
        --output OUT --pred-name pred [--device cpu] [KEY VALUE ...]

Checkpoints are ``.npz`` files of the landmark model's Flax variables with
``/``-joined keys (the port's format, see ``evaluate.py``), not the JAX
tool's orbax directories.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

import numpy as np
import torch

from .. import config as C
from ..data.landmark_dataset import LandmarkExamples
from ..device import resolve_device
from ..train import landmark_loop
from ..train.ensemble import EnsembleModel


def predict_landmarks(models: Sequence, examples: LandmarkExamples, cfg: C.ExperimentConfig,
                      output_path: str | None = None) -> np.ndarray:
    """(N, J, 3) [x, y, maxval] for ``examples`` in their order, written to
    ``output_path`` as pred.mat when given: one model with the config's
    flip test, or the mean of several models' heatmaps without it."""
    model = models[0] if len(models) == 1 else EnsembleModel(models)
    return landmark_loop.validate(
        model, examples, cfg.test.batch_size_per_chip, tuple(cfg.model.image_size), output_path=output_path,
        flip_test=cfg.test.flip_test and len(models) == 1, post_process=cfg.test.post_process,
        shift_heatmap=cfg.test.shift_heatmap,
    )


def has_labeled_keypoints(examples: LandmarkExamples) -> bool:
    """False for a json of dummy all-2.0 keypoints (real_test.json), whose OKS says nothing."""
    joints = np.stack([rec["joints"].astype(np.float32) for rec in examples.records])
    return bool(len(joints)) and not np.allclose(joints[..., :2], 2.0)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="events")
    ap.add_argument("--cfg", default=None, help="a YAML file of config keys (needs PyYAML)")
    ap.add_argument("--test-json", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--checkpoint", required=True, nargs="+",
                    help=".npz of the landmark model's Flax variables ('/'-joined keys; not an orbax "
                         "directory); more than one is an ensemble")
    ap.add_argument("--output", default="output")
    ap.add_argument("--pred-name", default="pred_test")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..evaluate import load_landmark_model

    device = resolve_device(args.device)
    cfg = C.get_preset(args.preset)
    if args.cfg:
        cfg = C.load_yaml(cfg, args.cfg)
    cfg = C.apply_overrides(cfg, args.opts)
    examples = LandmarkExamples(args.test_json, args.image_dir)
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    models = [load_landmark_model(path, cfg.model.name, examples.num_joints, dtype, device)
              for path in args.checkpoint]
    preds = predict_landmarks(models, examples, cfg, os.path.join(args.output, f"{args.pred_name}.mat"))
    print(f"wrote {args.output}/{args.pred_name}.mat preds shape {preds.shape}")
    if has_labeled_keypoints(examples):
        res = landmark_loop.oks_metrics(preds, examples)
        print("keypoint OKS AP {AP:.2f} AP50 {AP50:.2f} AP75 {AP75:.2f}".format(**res))


if __name__ == "__main__":
    main()
