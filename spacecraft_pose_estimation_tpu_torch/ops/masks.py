"""Mask ops: polygon rasterization and pasting ROI masks into the image.

Port of ``spacecraft_pose_estimation_tpu/ops/masks.py``: detectron2's
``polygons_to_bitmask`` (structures/masks.py) by even-odd crossing counts
at pixel centres, and ``paste_masks_in_image`` (layers/mask_ops.py), which
resamples each ROI's M x M mask bilinearly over its box into the full
image. Plain PyTorch, batched over the ROIs, on the masks' device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pixel_centres(height: int, width: int, device) -> tuple[Tensor, Tensor]:
    """(H, W) x and y of every pixel centre."""
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width) + 0.5
    return xs, ys


def polygon_to_bitmask(polygon: Tensor, height: int, width: int) -> Tensor:
    """(V, 2) closed polygon -> (H, W) bool mask: a pixel is inside where a
    ray from its centre crosses the polygon's edges an odd number of times."""
    xs, ys = _pixel_centres(height, width, polygon.device)
    polygon = polygon.to(torch.float32)
    v = polygon.shape[0]
    crossings = torch.zeros((height, width), dtype=torch.int32, device=polygon.device)
    for i in range(v):
        x1, y1 = polygon[i, 0], polygon[i, 1]
        x2, y2 = polygon[(i + 1) % v, 0], polygon[(i + 1) % v, 1]
        cond = (y1 <= ys) != (y2 <= ys)
        dy = y2 - y1
        t = (ys - y1) / torch.where(dy == 0, torch.ones_like(dy), dy)
        x_int = x1 + t * (x2 - x1)
        crossings = crossings + (cond & (xs < x_int)).to(torch.int32)
    return crossings % 2 == 1


def paste_masks_in_image(masks: Tensor, boxes: Tensor, height: int, width: int, threshold: float = 0.5) -> Tensor:
    """(R, M, M) ROI masks (logits or probabilities) and their (R, 4) XYXY
    boxes -> (R, H, W) bool: each pixel centre inside a box samples its mask
    bilinearly (the mask's M x M cells spread over the box, their centres at
    half-cell offsets, clamped at the mask's edges) and is set where the
    sample exceeds ``threshold``; pixels outside the box stay False."""
    r, m = masks.shape[0], masks.shape[-1]
    xs, ys = _pixel_centres(height, width, masks.device)
    x0, y0, x1, y1 = (boxes.to(torch.float32)[:, i, None, None] for i in range(4))
    w = torch.clamp(x1 - x0, min=1e-6)
    h = torch.clamp(y1 - y0, min=1e-6)
    gx = (xs - x0) / w * m - 0.5  # (R, H, W) in the mask's cells
    gy = (ys - y0) / h * m - 0.5
    inb = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    gx0 = torch.clamp(torch.floor(gx), 0, m - 1).to(torch.int64)
    gy0 = torch.clamp(torch.floor(gy), 0, m - 1).to(torch.int64)
    gx1 = torch.clamp(gx0 + 1, 0, m - 1)
    gy1 = torch.clamp(gy0 + 1, 0, m - 1)
    fx = torch.clamp(gx - gx0, 0.0, 1.0)
    fy = torch.clamp(gy - gy0, 0.0, 1.0)
    flat = masks.reshape(r, m * m)
    at = lambda yy, xx: torch.gather(flat, 1, (yy * m + xx).reshape(r, -1)).reshape(r, height, width)
    v = (at(gy0, gx0) * (1 - fx) * (1 - fy) + at(gy0, gx1) * fx * (1 - fy)
         + at(gy1, gx0) * (1 - fx) * fy + at(gy1, gx1) * fx * fy)
    return (v > threshold) & inb


def paste_mask_in_image(mask: Tensor, box: Tensor, height: int, width: int, threshold: float = 0.5) -> Tensor:
    """One (M, M) mask and its (4,) box -> (H, W) bool (:func:`paste_masks_in_image`)."""
    return paste_masks_in_image(mask[None], box[None], height, width, threshold)[0]
