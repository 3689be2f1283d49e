"""Detector over frames -> real_test.json, the first stage of the staged evaluation.

Port of ``tools/export_boxes.py``. Per batch of frames: the BGR letterbox
(``serving.letterbox_linear``, cv2's ``INTER_LINEAR``), the detector, and
per frame the valid box with the highest score, or the whole frame when
nothing is valid; ``real_test.json`` carries one annotation a frame with
all-visible dummy keypoints.

    python -m spacecraft_pose_estimation_tpu_torch.tools.export_boxes \\
        --image-dir DIR --checkpoint det.npz --output-dir OUT [--device cpu]

The checkpoint is a ``.npz`` of the detector's Flax variables with
``/``-joined keys (the port's format, see ``evaluate.py``), not the JAX
tool's orbax directory.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

import numpy as np
import torch

from ..data import coco_io
from ..device import resolve_device
from ..models.rcnn import select_best_box
from ..serving import letterbox_linear

FRAME_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def best_boxes(frames_bgr, detector, input_size: int = 768, batch_size: int = 8,
               width: int | None = None, height: int | None = None) -> tuple[np.ndarray, list]:
    """The detector's best box per frame, in frame pixels.

    ``frames_bgr`` (N, H, W, 3) uint8 BGR frames: anything whose slices give
    an array or a tensor (on any device). The last batch is padded by
    repeating its last frame. A frame with no valid detection gets the full
    frame of ``width`` x ``height`` (by default the frames' own).

    Returns the (N, 4) XYXY float32 boxes and, per frame, its valid
    detections (boxes (D, 4) in frame pixels, scores (D,)) as numpy.
    """
    device = next(detector.parameters()).device
    best_all, dets_all = [], []
    for start in range(0, len(frames_bgr), batch_size):
        chunk = torch.as_tensor(frames_bgr[start:start + batch_size]).to(device)
        k = chunk.shape[0]
        frames = torch.cat([chunk, chunk[-1:].expand(batch_size - k, *chunk.shape[1:])])
        h, w = (height or frames.shape[1]), (width or frames.shape[2])
        with torch.inference_mode():
            lb, scale = letterbox_linear(frames, input_size)
            dets = detector(lb)
            best = select_best_box(dets, (input_size, input_size)) / scale
            fallback = torch.as_tensor(coco_io.fallback_full_frame_box(w, h), dtype=best.dtype, device=device)
            best = torch.where(dets["valid"].any(1, keepdim=True), best, fallback)
        best_all.append(best[:k].cpu().numpy())
        valid, boxes, scores = (dets[key][:k].cpu() for key in ("valid", "boxes", "scores"))
        dets_all += [((boxes[i][valid[i]] / scale).numpy(), scores[i][valid[i]].numpy()) for i in range(k)]
    return np.concatenate(best_all), dets_all


def export_boxes(frames_bgr, names: Sequence[str], detector, output_dir: str, num_keypoints: int,
                 input_size: int = 768, batch_size: int = 8, width: int | None = None,
                 height: int | None = None) -> tuple[np.ndarray, list]:
    """:func:`best_boxes`, then ``real_test.json`` in ``output_dir``."""
    height, width = int(height or frames_bgr[0].shape[0]), int(width or frames_bgr[0].shape[1])
    boxes, dets = best_boxes(frames_bgr, detector, input_size, batch_size, width, height)
    coco = coco_io.detections_to_coco(names, boxes, num_keypoints, width, height)
    coco_io.save_coco(coco, os.path.join(output_dir, "real_test.json"))
    return boxes, dets


def write_overlays(cv2, image_dir: str, output_dir: str, names: Sequence[str], dets: list) -> None:
    """Each frame with its valid boxes and scores, under ``{0,1,2}_boxes/``
    by its number of detections (2 for two or more)."""
    for name, (boxes, scores) in zip(names, dets):
        im = cv2.imread(os.path.join(image_dir, name))
        for b, s in zip(boxes, scores):
            cv2.rectangle(im, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), (0, 255, 0), 2)
            cv2.putText(im, f"{s:.2f}", (int(b[0]), int(b[1]) - 4), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 1)
        cv2.imwrite(os.path.join(output_dir, f"{min(len(boxes), 2)}_boxes", name), im)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--checkpoint", required=True, help=".npz of the detector's Flax variables ('/'-joined keys; "
                                                        "not an orbax directory)")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--image-width", type=int, default=1920)
    ap.add_argument("--image-height", type=int, default=1200)
    ap.add_argument("--input-size", type=int, default=768, help="letterbox size")
    ap.add_argument("--landmarks-count", type=int, default=11)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--tiny", action="store_true", help="the tiny detector (RCNN_TINY)")
    ap.add_argument("--no-debug-images", action="store_true")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..evaluate import SceneFrames, load_detector, require_cv2

    cv2 = require_cv2()
    device = resolve_device(args.device)
    detector = load_detector(args.checkpoint, args.tiny, False, getattr(torch, args.dtype), device)
    names = sorted(f for f in os.listdir(args.image_dir) if f.lower().endswith(FRAME_EXTENSIONS))
    _, dets = export_boxes(SceneFrames(cv2, args.image_dir, names), names, detector, args.output_dir,
                           args.landmarks_count, args.input_size, args.batch_size, args.image_width,
                           args.image_height)
    if not args.no_debug_images:
        for sub in ("0_boxes", "1_boxes", "2_boxes"):
            os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)
        write_overlays(cv2, args.image_dir, args.output_dir, names, dets)
    print(f"wrote {args.output_dir}/real_test.json ({len(names)} images)")


if __name__ == "__main__":
    main()
