"""Sub-pixel heatmap peak decoding (lib/core/inference.py:18-79).

Port of the decoding half of ``spacecraft_pose_estimation_tpu/ops/heatmap.py``.
Heatmaps are channels-last (B, H, W, J).
"""

from __future__ import annotations

import torch

from . import geometry

Tensor = torch.Tensor


def get_max_preds(heatmaps: Tensor) -> tuple[Tensor, Tensor]:
    """Argmax peak per joint: (B, H, W, J) -> coords (B, J, 2) as (x, y), maxvals (B, J).

    Ties go to the first maximum; joints whose max is <= 0 get zero coords.
    """
    b, h, w, j = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, j, h * w)
    maxvals = flat.amax(dim=-1)
    idx = torch.argmax(flat, dim=-1)  # first maximum, as jnp.argmax
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0)[..., None], maxvals


def _subpixel_shift(heatmaps_bjhw: Tensor, coords: Tensor) -> Tensor:
    """+-0.25-px shift along the sign of the neighbour difference (inference.py:56-69)."""
    b, j, h, w = heatmaps_bjhw.shape
    px = torch.floor(coords[..., 0] + 0.5).to(torch.int64)
    py = torch.floor(coords[..., 1] + 0.5).to(torch.int64)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    pxc = torch.clamp(px, 1, w - 2)
    pyc = torch.clamp(py, 1, h - 2)
    flat = heatmaps_bjhw.reshape(b, j, h * w)

    def gather(dy, dx):
        return torch.gather(flat, -1, ((pyc + dy) * w + (pxc + dx))[..., None])[..., 0]

    diff_x = gather(0, 1) - gather(0, -1)
    diff_y = gather(1, 0) - gather(-1, 0)
    shift = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1) * 0.25
    return coords + shift * ok[..., None]


def decode_heatmaps(
    heatmaps: Tensor, centers: Tensor, scales: Tensor, post_process: bool = True
) -> tuple[Tensor, Tensor]:
    """(B, H, W, J) heatmaps -> source-image keypoints (B, J, 2) and confidences (B, J)."""
    coords, maxvals = get_max_preds(heatmaps)
    hh, wh = heatmaps.shape[1], heatmaps.shape[2]
    if post_process:
        coords = _subpixel_shift(heatmaps.permute(0, 3, 1, 2), coords)
    return geometry.transform_preds(coords, centers, scales, (wh, hh)), maxvals
