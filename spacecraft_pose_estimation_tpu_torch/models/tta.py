"""Test-time augmentation for detection (port of ``models/tta.py``,
detectron2's ``GeneralizedRCNNWithTTA``): horizontal flips and extra
scales, merged by one class-aware NMS over the union of the views.

Each view gives the detector's padded (B, K, ...) detections; the views'
boxes are mapped back to the original image, concatenated in the order
scale, then its flip, for each scale (the merge's ties go to the earlier
view), and kept by ``ops/nms.batched_nms_mask`` (kernel K4 on CUDA
tensors) and a top-k by score.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..ops import nms as nms_ops

Tensor = torch.Tensor


def flip_boxes(boxes: Tensor, width: float) -> Tensor:
    """XYXY boxes (..., 4) of a horizontally flipped image of ``width``."""
    return torch.stack([width - boxes[..., 2], boxes[..., 1], width - boxes[..., 0], boxes[..., 3]], dim=-1)


def resize_bilinear(images: Tensor, size: tuple[int, int]) -> Tensor:
    """(B, H, W, C) -> (B, h, w, C) float32 by ``jax.image.resize(...,
    "bilinear")``'s rule: half-pixel centres, antialiased when shrinking.
    Not rounded: a uint8 batch comes back float32."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def make_tta_inference(infer_fn: Callable[[Tensor], dict], scales: Sequence[float] = (1.0,), flip: bool = True,
                       nms_thresh: float = 0.5, max_dets: int = 100):
    """Wrap an ``images (B, H, W, C) -> padded detections`` callable
    (boxes (B, K, 4), scores, classes, valid) with flip / multi-scale TTA.

    A scale of 1.0 hands the images over as they are; another resizes them
    to ``int(round(H * s))`` x ``int(round(W * s))`` (Python's rounding,
    half to even) with :func:`resize_bilinear`, so the detector sees float32.
    Returns run(images) -> {boxes (B, max_dets, 4), scores, classes, valid};
    the rows past the kept ones have score 0 and ``valid`` False.
    """

    def run(images: Tensor) -> dict:
        h, w = images.shape[1], images.shape[2]
        views = []
        for s in scales:
            imgs = images if s == 1.0 else resize_bilinear(images, (int(round(h * s)), int(round(w * s))))
            sh, sw = h / imgs.shape[1], w / imgs.shape[2]
            scale_back = torch.tensor([sw, sh, sw, sh], dtype=torch.float32, device=images.device)
            dets = infer_fn(imgs)
            views.append(dict(dets, boxes=dets["boxes"] * scale_back))
            if flip:
                dets = infer_fn(torch.flip(imgs, dims=(2,)))
                views.append(dict(dets, boxes=flip_boxes(dets["boxes"], imgs.shape[2]) * scale_back))
        boxes, scores, classes, valid = (torch.cat([v[k] for v in views], dim=1)
                                         for k in ("boxes", "scores", "classes", "valid"))
        keep = nms_ops.batched_nms_mask(boxes, scores, classes, nms_thresh, valid)
        masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
        top, idx = nms_ops.top_k_by_score(masked, min(max_dets, masked.shape[1]))
        found = torch.isfinite(top)
        return {
            "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            "scores": torch.where(found, top, torch.zeros_like(top)),
            "classes": torch.gather(classes, 1, idx),
            "valid": found,
        }

    return run
