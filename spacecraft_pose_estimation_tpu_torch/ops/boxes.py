"""Box arithmetic: areas, IoU, clipping, delta encoding and decoding, matching.

Port of ``spacecraft_pose_estimation_tpu/ops/boxes.py`` without the
giou/diou/ciou losses, which no ported model uses. Boxes are (..., 4)
XYXY float32.
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


def get_deltas(src: Tensor, target: Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> Tensor:
    """Encode target boxes as (dx, dy, dw, dh) deltas wrt src (anchor) boxes."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    dx = wx * (tcx - scx) / torch.clamp(sw, min=1e-7)
    dy = wy * (tcy - scy) / torch.clamp(sh, min=1e-7)
    dw = ww * torch.log(torch.clamp(tw, min=1e-7) / torch.clamp(sw, min=1e-7))
    dh = wh * torch.log(torch.clamp(th, min=1e-7) / torch.clamp(sh, min=1e-7))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def elementwise_iou(a: Tensor, b: Tensor) -> Tensor:
    """(..., 4) x (..., 4) -> (...) IoU of paired boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))


def match_to_gt(iou: Tensor, thresholds: tuple[float, ...], labels: tuple[int, ...],
                allow_low_quality: bool = False) -> tuple[Tensor, Tensor]:
    """detectron2 ``Matcher``: per candidate its best GT and a quality label.

    ``iou`` (..., G, N) of G ground-truth boxes (zero rows for padding) vs N
    candidates; ``thresholds`` ascending cut points, ``labels`` one of
    {-1, 0, 1} per interval from the lowest. ``allow_low_quality`` also marks
    each GT's best candidates, ties included, positive
    (``set_low_quality_matches_``). Returns matched_idx (..., N) int64, the
    first maximum as ``jnp.argmax`` picks it, and labels (..., N) int32.
    """
    matched_vals = iou.amax(dim=-2)
    # the first maximum: torch.argmax does not promise which of tied entries it returns
    g = iou.shape[-2]
    rows = torch.arange(g, device=iou.device)[:, None]
    matched_idx = torch.where(iou == matched_vals[..., None, :], rows, g).amin(dim=-2).clamp(max=g - 1)
    label = torch.full(matched_vals.shape, labels[0], dtype=torch.int32, device=iou.device)
    cuts = (0.0,) + tuple(thresholds) + (float("inf"),)
    for (low, high), lab in zip(zip(cuts[:-1], cuts[1:]), labels):
        label = torch.where((matched_vals >= low) & (matched_vals < high), torch.tensor(lab, dtype=torch.int32), label)
    if allow_low_quality:
        per_gt_max = iou.amax(dim=-1, keepdim=True)  # (..., G, 1)
        is_best = (iou == per_gt_max) & (per_gt_max > 0)
        label = torch.where(is_best.any(dim=-2), torch.tensor(1, dtype=torch.int32), label)
    return matched_idx, label
