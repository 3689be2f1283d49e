"""Single-image landmark + pose demo (port of ``tools/demo.py``, landmark_regression/demo parity).

Given an image, a bounding box (the whole frame when omitted) and a
landmark checkpoint, runs the crop (kernel K1) -> HRNet -> decode path and
writes an overlay; with a landmark CSV and a calibration it also solves
the pose by RANSAC PnP and draws the projected landmarks.

    python -m spacecraft_pose_estimation_tpu_torch.tools.demo --image FRAME.png \\
        --checkpoint OUT/checkpoints [--box X Y W H] [--model pose_hrnet] [--image-size 512 512] \\
        [--landmarks-file landmarks.csv --calibration-file calibration.json] [--output demo_out.jpg] [--device cpu]

``--checkpoint`` is a directory of the port's landmark checkpoints
(``train.checkpoint.CheckpointManager``, as ``tools.train_landmarks``
writes them under ``OUT/checkpoints``); its latest step is restored. The
JAX tool's orbax directories are refused. The model runs in bf16, as the
JAX tool's does.
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
from ..pipeline import PipelineConfig, make_landmark_stage, make_pose_pipeline


def _drawable(x, y) -> bool:
    """A point cv2 can take: finite and within its int range. A pose far off
    (untrained weights) projects landmarks where the JAX tool's cv2 call
    raises; they are left out of the overlay instead."""
    return bool(np.isfinite(x) and np.isfinite(y) and abs(x) < 2**30 and abs(y) < 2**30)


def run(image_bgr: np.ndarray, model, box: Sequence[float] | None = None, landmarks: np.ndarray | None = None,
        cam: CameraModel | None = None, image_size: tuple[int, int] = (512, 512), gumbel: torch.Tensor | None = None,
        generator: torch.Generator | None = None) -> tuple[dict, np.ndarray]:
    """One (H, W, 3) uint8 BGR image through the demo's path on the model's
    device -> (the pipeline's outputs, the overlay drawn on a copy).

    ``box`` is x y w h (the whole frame when None); ``image_size`` is the
    model's (width, height). With ``landmarks`` (J, 3) and ``cam`` the pose
    comes from ``make_pose_pipeline`` with ``solver="ransac"``, its noise
    ``gumbel`` (1, 256, J) or drawn from ``generator`` (a generator on the
    model's device seeded 0 when both are None); else the landmark stage
    runs alone (``solver="none"``). The crop goes through K1 either way.
    The overlay is the JAX tool's: the box, the keypoints (green above 0.5
    confidence, orange below) and the projected landmarks (blue).
    """
    import cv2

    device = next(model.parameters()).device
    h, w = image_bgr.shape[:2]
    box = list(box) if box is not None else [0.0, 0.0, float(w), float(h)]
    frames = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1]))[None].to(device)
    boxes = torch.tensor([box], dtype=torch.float32, device=device)
    img = image_bgr.copy()
    if landmarks is not None and cam is not None:
        pose = make_pose_pipeline(model, landmarks.astype(np.float32), cam.K.astype(np.float32),
                                  cam.dist.astype(np.float32), PipelineConfig(image_size=image_size, solver="ransac"))
        if gumbel is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        out = pose(frames, boxes, gumbel=gumbel, generator=generator)
        R, t = out["R"][0].cpu().numpy(), out["t"][0].cpu().numpy()
        for x, y in coco_io.project_landmarks(landmarks, R, t, cam.K, cam.dist):
            if _drawable(x, y):
                cv2.circle(img, (int(x), int(y)), 5, (255, 0, 0), -1)
    else:
        out = make_landmark_stage(model, PipelineConfig(image_size=image_size, solver="none"))(frames, boxes)
    kps = out["keypoints"][0].cpu().numpy()
    conf = out["confidence"][0].cpu().numpy()
    for (x, y), c in zip(kps, conf):
        if not _drawable(x, y):
            continue
        color = (0, 255, 0) if c > 0.5 else (0, 165, 255)
        cv2.circle(img, (int(x), int(y)), 3, color, -1)
    x0, y0, bw, bh = [int(v) for v in box]
    cv2.rectangle(img, (x0, y0), (x0 + bw, y0 + bh), (0, 255, 0), 2)
    return out, img


def load_model(checkpoint: str, name: str, num_joints: int, device):
    """``build_landmark_model(name)`` in bf16 with the latest step of a
    landmark checkpoint directory (restored into a ``TrainState`` with Adam
    1e-3, as the JAX tool's template)."""
    from ..evaluate import orbax_directory_error
    from ..models import build_landmark_model
    from ..train.checkpoint import CheckpointManager
    from ..train.optim import build_optimizer
    from ..train.state import TrainState

    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(checkpoint)
    model = build_landmark_model(name, num_joints, device=device, dtype=torch.bfloat16)
    mgr = CheckpointManager(checkpoint)
    if mgr.latest_step() is None:
        if any(d.isdigit() for d in os.listdir(checkpoint)):  # step directories without the port's state.pt
            raise orbax_directory_error(checkpoint)
        raise FileNotFoundError(checkpoint)
    mgr.restore(TrainState(model, build_optimizer("adam", model.parameters(), 1e-3)))
    return model


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--box", type=float, nargs=4, default=None,
                    help="x y w h (omit to use the full frame)")
    ap.add_argument("--checkpoint", required=True, help="landmark ckpt dir")
    ap.add_argument("--model", default="pose_hrnet")
    ap.add_argument("--image-size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--landmarks-file", default=None)
    ap.add_argument("--calibration-file", default=None)
    ap.add_argument("--output", default="demo_out.jpg")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..evaluate import require_cv2

    device = resolve_device(args.device)
    cv2 = require_cv2()
    img = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(args.image)
    h, w = img.shape[:2]
    lm3d = coco_io.load_landmarks_csv(args.landmarks_file) if args.landmarks_file else None
    num_joints = lm3d.shape[0] if lm3d is not None else 11
    model = load_model(args.checkpoint, args.model, num_joints, device)
    cam = CameraModel.from_calibration_json(args.calibration_file, w, h) \
        if lm3d is not None and args.calibration_file else None
    out, drawn = run(img, model, args.box, lm3d if cam is not None else None, cam, tuple(args.image_size))
    if "R" in out:
        print("R=\n", out["R"][0].cpu().numpy(), "\nt=", out["t"][0].cpu().numpy())
    cv2.imwrite(args.output, drawn)
    conf = out["confidence"][0].cpu().numpy()
    print(f"wrote {args.output}; mean confidence {conf.mean():.3f}")
    return out


if __name__ == "__main__":
    main()
