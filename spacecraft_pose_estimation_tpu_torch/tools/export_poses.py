"""Keypoints + calibration -> 6-DoF poses, the third stage of the staged evaluation.

Port of ``tools/export_poses.py`` (the reference's
``export_predicted_poses_real.py``): the 3-D landmark CSV, the camera
calibration, the detections' COCO json and the pred.mat keypoints in; per
frame RANSAC PnP (``ops.pnp.pnp_ransac``, 512 hypotheses) or EPnP plus
Gauss-Newton on the adaptive confidence gate; a finiteness audit that
refuses to write a non-finite pose; ``opencv_poses.json`` and, unless
``--no-render``, reprojection overlays.

    python -m spacecraft_pose_estimation_tpu_torch.tools.export_poses \\
        --frames-dir DIR --detection-annotations real_test.json --pose-annotations pred.mat \\
        --landmarks-file landmarks.csv --calibration-file calibration.json --output-dir OUT [--device cpu]

RANSAC's noise comes from a ``torch.Generator`` seeded with 0 on the
device (the JAX tool splits ``jax.random.key(0)`` over the frames; the
two give different draws).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

import numpy as np
import torch

from ..data import coco_io
from ..data.camera import CameraModel
from ..device import resolve_device
from ..ops import pnp


def solve_poses(preds: np.ndarray, landmarks: np.ndarray, cam: CameraModel, solver: str = "ransac",
                hypotheses: int = 512, device=None, gumbel: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(N, J, 3) [x, y, conf] keypoints -> R (N, 3, 3), t (N, 3) float64,
    solved on ``device`` (CUDA unless named).

    ``solver`` "ransac": ``pnp_ransac`` over all frames at once, its noise
    ``gumbel`` (N, hypotheses, J) or drawn from ``generator`` (seed 0 when
    None); "gn": EPnP + Gauss-Newton on ``adaptive_confidence_mask``.
    """
    device = resolve_device(device)
    lm, K, dist = (torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)
                   for a in (landmarks, cam.K, cam.dist))
    kp = torch.as_tensor(np.asarray(preds[:, :, :2], np.float32)).to(device)
    conf = torch.as_tensor(np.asarray(preds[:, :, 2], np.float32)).to(device)
    with torch.inference_mode():
        if solver == "ransac":
            out = pnp.pnp_ransac(lm, kp, K, dist, conf, gumbel=gumbel, generator=generator,
                                 num_hypotheses=hypotheses)
            R, t = out["R"], out["t"]
        elif solver == "gn":
            R, t = pnp.solve_pnp(lm, kp, K, dist, pnp.adaptive_confidence_mask(conf).to(torch.float32))
        else:
            raise ValueError(f"solver must be 'ransac' or 'gn', got {solver!r}")
    return R.cpu().double().numpy(), t.cpu().double().numpy()


def audit_finite(Rs: np.ndarray, ts: np.ndarray, names: Sequence[str]) -> None:
    """Raise SystemExit when any pose is not finite: the solver's
    finite-fallback contract is broken and opencv_poses.json must not be
    written (the reference stage never emits a NaN pose)."""
    finite = np.isfinite(Rs).all(axis=(1, 2)) & np.isfinite(ts).all(axis=1)
    n_bad = int((~finite).sum())
    if n_bad:
        bad_names = [names[i] for i in np.flatnonzero(~finite)[:10]]
        raise SystemExit(f"export_poses: {n_bad}/{len(finite)} non-finite poses (first: {bad_names}): the "
                         "solver's finite-fallback contract is broken; refusing to write opencv_poses.json")
    logging.info("all %d poses finite", len(finite))


def export_poses(preds: np.ndarray, coco: dict, landmarks: np.ndarray, cam: CameraModel, output_dir: str,
                 **solve_kwargs) -> tuple[list[str], np.ndarray, np.ndarray]:
    """:func:`solve_poses`, the audit, then ``opencv_poses.json`` in
    ``output_dir``, frames named in the json's image order."""
    image_names = {im["id"]: im["file_name"] for im in coco["images"]}
    image_ids = [im["id"] for im in coco["images"]]
    names = [image_names[i] for i in image_ids[:len(preds)]]
    Rs, ts = solve_poses(preds, landmarks, cam, **solve_kwargs)
    audit_finite(Rs, ts, names)
    coco_io.save_opencv_poses(names, Rs, ts, os.path.join(output_dir, "opencv_poses.json"))
    return names, Rs, ts


def write_overlays(cv2, frames_dir: str, output_dir: str, names, Rs, ts, coco, landmarks, cam) -> None:
    """Each frame with its detection box and the landmarks projected at its pose, as JPEG."""
    anns = coco["annotations"]
    for i, name in enumerate(names):
        img = cv2.imread(os.path.join(frames_dir, name))
        if img is None:
            continue
        uv = coco_io.project_landmarks(landmarks, Rs[i], ts[i], cam.K, cam.dist)
        if i < len(anns):
            b = [int(v) for v in anns[i]["bbox"]]
            cv2.rectangle(img, (b[0], b[1]), (b[0] + b[2], b[1] + b[3]), (0, 255, 0), 2)
        for x, y in uv:
            cv2.circle(img, (int(x), int(y)), 5, (255, 0, 0), -1)
        cv2.imwrite(os.path.join(output_dir, os.path.basename(name).split(".")[0] + ".jpg"), img)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames-dir", required=True)
    ap.add_argument("--detection-annotations", required=True)
    ap.add_argument("--pose-annotations", required=True, help="pred.mat keypoints")
    ap.add_argument("--landmarks-file", required=True)
    ap.add_argument("--calibration-file", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--solver", choices=["ransac", "gn"], default="ransac")
    ap.add_argument("--hypotheses", type=int, default=512)
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..evaluate import require_cv2

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    landmarks = coco_io.load_landmarks_csv(args.landmarks_file)
    cam = CameraModel.from_calibration_json(args.calibration_file)
    coco = coco_io.load_coco(args.detection_annotations)
    preds = coco_io.load_pred_mat(args.pose_annotations)
    names, Rs, ts = export_poses(preds, coco, landmarks, cam, args.output_dir, solver=args.solver,
                                 hypotheses=args.hypotheses, device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
    if not args.no_render:
        write_overlays(require_cv2(), args.frames_dir, args.output_dir, names, Rs, ts, coco, landmarks, cam)
    print(f"wrote {args.output_dir}/opencv_poses.json ({len(names)} poses)")


if __name__ == "__main__":
    main()
