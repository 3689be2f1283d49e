"""Box arithmetic for inference: areas, IoU, clipping, delta decoding.

Port of the inference subset of ``spacecraft_pose_estimation_tpu/ops/boxes.py``.
Boxes are (..., 4) XYXY float32.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

# Maximum dw/dh so exp() cannot overflow (detectron2 _DEFAULT_SCALE_CLAMP).
SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: Tensor) -> Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0
    )


def pairwise_iou(a: Tensor, b: Tensor) -> Tensor:
    """(..., Na, 4) x (..., Nb, 4) -> (..., Na, Nb) IoU; 0 where the union is not positive."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))


def clip_boxes(boxes: Tensor, height: float, width: float) -> Tensor:
    x0 = torch.clamp(boxes[..., 0], 0, width)
    y0 = torch.clamp(boxes[..., 1], 0, height)
    x1 = torch.clamp(boxes[..., 2], 0, width)
    y1 = torch.clamp(boxes[..., 3], 0, height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty_mask(boxes: Tensor, threshold: float = 0.0) -> Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold
    )


def apply_deltas(deltas: Tensor, boxes: Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> Tensor:
    """Decode (dx, dy, dw, dh) deltas against boxes (Box2BoxTransform.apply_deltas)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1
    )
