"""Training-time PCK accuracy (port of ``train/accuracy.py``, the reference's
``lib/core/evaluate.py:16-71``).

The predicted and ground-truth heatmaps' argmax positions are compared
after normalising by heatmap size / 10; a joint is correct below ``thr``
(0.5). Joints with no ground-truth peak (the argmax of an all-zero map
sits at the origin) are left out, and a joint with none in the batch
reads -1.
"""

from __future__ import annotations

import torch

from ..ops.heatmap import get_max_preds

Tensor = torch.Tensor


def pck_accuracy(pred_heatmaps: Tensor, target_heatmaps: Tensor, thr: float = 0.5) -> tuple[Tensor, Tensor]:
    """(B, H, W, J) heatmaps -> (per-joint accuracy (J,), mean accuracy); -1 marks joints without GT."""
    _, h, w, _ = pred_heatmaps.shape
    pred, _ = get_max_preds(pred_heatmaps)
    target, _ = get_max_preds(target_heatmaps)
    norm = torch.tensor([w, h], dtype=torch.float32, device=pred.device) / 10.0
    dist = torch.linalg.vector_norm((pred - target) / norm, dim=-1)  # (B, J)
    has_gt = (target[..., 0] > 1) & (target[..., 1] > 1)
    correct = (dist < thr) & has_gt
    count = has_gt.sum(0)
    acc = torch.where(count > 0, correct.sum(0) / count.clamp(min=1), -1.0)
    valid = acc >= 0
    mean = torch.where(valid, acc, 0.0).sum() / valid.sum().clamp(min=1)
    return acc, mean
