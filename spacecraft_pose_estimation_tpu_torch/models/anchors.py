"""Grid anchors for an FPN (port of ``models/anchors.py``, detectron2
DefaultAnchorGenerator). Built in numpy float64 and cast to float32, as
the JAX package does, so both hold the same anchors bit for bit."""

from __future__ import annotations

import numpy as np
import torch


def cell_anchors(sizes, aspect_ratios) -> np.ndarray:
    """(A, 4) anchors centred at the origin: area size^2, h/w = ratio."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for r in aspect_ratios:
            w = np.sqrt(area / r)
            h = w * r
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, base: np.ndarray) -> np.ndarray:
    """(H*W*A, 4) float32 anchors for one level, row-major over (y, x, a)."""
    shift_x = np.arange(feat_w) * stride
    shift_y = np.arange(feat_h) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None, :, :]).reshape(-1, 4).astype(np.float32)


def fpn_anchors(
    feat_shapes: dict[str, tuple[int, int]],
    strides: dict[str, int],
    sizes_per_level: dict[str, tuple[float, ...]],
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
    device=None,
) -> dict[str, torch.Tensor]:
    """Per-level anchors {level: (N_l, 4) float32 tensor on ``device``}."""
    return {
        lvl: torch.from_numpy(
            grid_anchors(h, w, strides[lvl], cell_anchors(sizes_per_level[lvl], aspect_ratios))
        ).to(device)
        for lvl, (h, w) in feat_shapes.items()
    }
