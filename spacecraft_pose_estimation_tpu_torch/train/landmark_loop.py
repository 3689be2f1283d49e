"""The landmark stage's validation pass: crops -> heatmaps -> keypoints -> pred.mat.

Port of ``make_validate_step``, ``validate`` and ``oks_metrics`` of the
JAX package's ``train/landmark_loop.py`` (the reference's
``lib/core/function.py`` validate): batches of a fixed size with the tail
padded by its last example, the full-frame crop of each box (kernel K1,
``ops/warp.crop_and_resize``, the JAX package's exact mode), an optional
flip test, the sub-pixel decode back to frame pixels, and ``pred.mat``.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from ..data import coco_io
from ..data.landmark_dataset import LandmarkExamples
from ..ops import geometry, heatmap, warp
from ..pipeline import normalize_crops

logger = logging.getLogger(__name__)
Tensor = torch.Tensor


def make_validate_step(model, post_process: bool = True, flip_test: bool = False,
                       shift_heatmap: bool = True) -> Callable:
    """Returns fn(images, centers, scales) -> (preds (B, J, 2), maxvals (B, J),
    heatmaps (B, h, w, J)) for normalized (B, H, W, 3) crops.

    The flip test runs the model on the crops flipped in width, flips its
    heatmaps back and, with ``shift_heatmap``, shifts them right by one
    pixel (column 0 repeated, not rolled), then averages them with the
    unflipped heatmaps. Spacecraft landmarks have no left/right pairs to
    swap.
    """

    @torch.inference_mode()
    def step(images: Tensor, centers: Tensor, scales: Tensor):
        hm = model(images)
        if flip_test:
            hm_f = model(images.flip(2)).flip(2)
            if shift_heatmap:
                hm_f = torch.cat([hm_f[:, :, :1], hm_f[:, :, :-1]], dim=2)
            hm = (hm + hm_f) * 0.5
        preds, maxvals = heatmap.decode_heatmaps(hm, centers, scales, post_process)
        return preds, maxvals, hm

    return step


def _device(model) -> torch.device:
    return getattr(model, "device", None) or next(model.parameters()).device


def validate(model, examples: LandmarkExamples, batch_size: int, image_size: tuple[int, int],
             output_path: str | None = None, flip_test: bool = False, post_process: bool = True,
             shift_heatmap: bool = True) -> np.ndarray:
    """The validation pass over ``examples`` in their order -> (N, J, 3)
    [x, y, maxval] float32, written to ``output_path`` as pred.mat when
    given. The frames go to K1 as uint8 on the model's device."""
    step = make_validate_step(model, post_process, flip_test, shift_heatmap)
    device = _device(model)
    n = len(examples)
    all_preds = np.zeros((n, examples.num_joints, 3), np.float32)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        exs = [examples.example(i) for i in idx]
        exs += [exs[-1]] * (batch_size - len(idx))
        images = torch.stack([torch.as_tensor(e["image"]).to(device) for e in exs])
        bboxes = torch.from_numpy(np.stack([e["bbox"] for e in exs])).to(device)
        centers, scales = geometry.bbox_to_center_scale(bboxes)
        crops = warp.crop_and_resize(images, centers, scales, image_size)
        preds, maxvals, _ = step(normalize_crops(crops), centers, scales)
        all_preds[start:start + len(idx), :, :2] = preds[:len(idx)].cpu().numpy()
        all_preds[start:start + len(idx), :, 2] = maxvals[:len(idx)].cpu().numpy()
    if output_path:
        coco_io.save_pred_mat(all_preds, output_path)
        logger.info("wrote %s", output_path)
    return all_preds


def oks_metrics(all_preds: np.ndarray, examples: LandmarkExamples, sigmas=None) -> dict:
    """Keypoint-OKS AP of a validation pass against the examples' labeled
    keypoints (``coco_eval.evaluate_keypoints``). The examples' visibility
    weights are COCO vis - 1, mapped back (+1) so that every labeled
    keypoint (v >= 1) counts, as pycocotools' computeOks does."""
    from ..data import coco_eval

    dets, gts = [], []
    for i in range(len(examples)):
        # the example's float32 values, as the JAX example() hands them over
        rec = {k: examples.records[i][k].astype(np.float32).astype(np.float64)
               for k in ("joints", "joints_vis", "bbox")}
        dets.append({"keypoints": np.asarray(all_preds[i], np.float64)[None],
                     "scores": np.asarray([float(all_preds[i, :, 2].mean())])})
        gts.append({"keypoints": np.concatenate([rec["joints"], rec["joints_vis"][:, None] + 1.0], axis=1)[None],
                    "boxes": rec["bbox"][None]})
    return coco_eval.evaluate_keypoints(dets, gts, sigmas=sigmas)
