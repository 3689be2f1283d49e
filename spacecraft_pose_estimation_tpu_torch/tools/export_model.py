"""Serialize the pose pipeline with ``torch.export`` (port of ``tools/export_model.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.export_model --checkpoint DIR \\
        --landmarks-file landmarks.csv --calibration-file calibration.json --output pose.pt2 \\
        [--model pose_hrnet] [--image-size 512 512] [--frame-size 1920 1200] [--batch-size 8] [--device cpu]

The latest step of a landmark checkpoint directory (``train/checkpoint``)
in the bf16 landmark model, and ``pipeline.PoseProgram`` with
``PipelineConfig(image_size, solver="gn")`` around it: the JAX tool's
``serving_fn``. The program takes ``frames`` (B, H, W, 3) uint8 (the port's
served input; the JAX artifact takes float32 frames) and ``boxes`` (B, 4)
float32 xywh at the shapes of ``--batch-size`` and ``--frame-size``
(width, height), and returns ``(keypoints, confidence, R, t, quat)``. The
crop is K1 as the registered operator ``torch.ops.spe_port.crop_bilinear``
(``ops/warp.py``), so a loader imports that module first::

    import torch
    import spacecraft_pose_estimation_tpu_torch.ops.warp  # registers spe_port::crop_bilinear
    program = torch.export.load("pose.pt2").module()
    keypoints, confidence, R, t, quat = program(frames, boxes)

It runs on CUDA unless given ``--device cpu``; the program is exported on
that device and runs there.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np
import torch

from ..data import coco_io
from ..data.camera import CameraModel
from ..device import resolve_device
from ..models import build_landmark_model
from ..pipeline import PipelineConfig, PoseProgram
from ..train.checkpoint import CheckpointManager
from ..train.optim import build_optimizer
from ..train.state import TrainState


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Export the pose pipeline as a torch.export program.")
    ap.add_argument("--checkpoint", required=True, help="landmark checkpoint directory")
    ap.add_argument("--landmarks-file", required=True)
    ap.add_argument("--calibration-file", required=True)
    ap.add_argument("--model", default="pose_hrnet")
    ap.add_argument("--image-size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--frame-size", type=int, nargs=2, default=[1920, 1200])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--output", required=True, help="output .pt2 path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_program(args: argparse.Namespace, device) -> PoseProgram:
    """The bf16 landmark model of ``args.checkpoint`` inside ``PoseProgram``, on ``device``."""
    landmarks = coco_io.load_landmarks_csv(args.landmarks_file)
    cam = CameraModel.from_calibration_json(args.calibration_file)
    model = build_landmark_model(args.model, landmarks.shape[0], device=device, dtype=torch.bfloat16)
    state = TrainState(model, build_optimizer("adam", model.parameters(), 1e-3))
    if not os.path.isdir(args.checkpoint) or CheckpointManager(args.checkpoint).restore(state) is None:
        raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
    model.eval()
    w, h = args.image_size
    return PoseProgram(model, landmarks.astype(np.float32), cam.K.astype(np.float32), cam.dist.astype(np.float32),
                       PipelineConfig(image_size=(w, h), solver="gn"))


def main(argv: Sequence[str] | None = None) -> torch.export.ExportedProgram:
    """The command; returns the exported program it saved."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    program = build_program(args, device)
    fw, fh = args.frame_size
    example = (torch.zeros((args.batch_size, fh, fw, 3), dtype=torch.uint8, device=device),
               torch.zeros((args.batch_size, 4), dtype=torch.float32, device=device))
    exported = torch.export.export(program, example, strict=False)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    torch.export.save(exported, args.output)
    print(f"exported {os.path.getsize(args.output) / 1e6:.1f} MB serving program -> {args.output}")
    return exported


if __name__ == "__main__":
    main()
