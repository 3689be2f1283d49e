"""Gaussian heatmap targets and sub-pixel peak decoding.

Port of ``spacecraft_pose_estimation_tpu/ops/heatmap.py``:

* :func:`generate_target`, the reference's ``lib/dataset/JointsDataset.py:264-332``
  with its quirks: the peak cell is ``int(x / stride + 0.5)`` (truncation),
  cells outside the 6 sigma + 1 box are exact zeros, and a joint whose box
  misses the map gets target weight 0;
* the decode, ``lib/core/inference.py:18-79``.

Heatmaps are channels-last (B, H, W, J).
"""

from __future__ import annotations

import torch

from . import geometry

Tensor = torch.Tensor


def generate_target(joints: Tensor, joints_vis: Tensor, image_size: tuple[int, int],
                    heatmap_size: tuple[int, int], sigma: float) -> tuple[Tensor, Tensor]:
    """Unnormalized per-joint Gaussians (peak 1) on the heatmap grid.

    ``joints`` (..., J, 2) in model-input pixels, ``joints_vis`` (..., J)
    (1 visible, 0 not); sizes are (width, height); ``sigma`` in heatmap
    pixels. Returns the targets (..., Hh, Wh, J) float32 and the weights
    (..., J): 0 where a joint is invisible or its box misses the map.
    """
    wh, hh = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = image_size[0] / heatmap_size[0]
    stride_y = image_size[1] / heatmap_size[1]
    tmp_size = int(sigma * 3)
    joints = joints.float()
    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)  # int(x / stride + 0.5), C truncation
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    in_bounds = ~((mu_x - tmp_size >= wh) | (mu_y - tmp_size >= hh)
                  | (mu_x + tmp_size + 1 < 0) | (mu_y + tmp_size + 1 < 0))
    weight = joints_vis.float() * in_bounds.float()
    xs = torch.arange(wh, dtype=torch.float32, device=joints.device)
    ys = torch.arange(hh, dtype=torch.float32, device=joints.device)
    dx = xs[:, None] - mu_x[..., None, None, :]  # (..., 1, Wh, J)
    dy = ys[:, None, None] - mu_y[..., None, None, :]  # (..., Hh, 1, J)
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma**2))
    box = (dx.abs() <= tmp_size) & (dy.abs() <= tmp_size)
    target = torch.where(box & (weight[..., None, None, :] > 0.5), g, 0.0)
    return target, weight


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
