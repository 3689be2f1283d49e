"""Heatmap regression losses (port of ``train/loss.py``, the reference's ``lib/core/loss.py``).

* :func:`joints_mse_loss`, JointsMSELoss: per joint 0.5 * MSE between the
  (optionally target-weighted) predicted and target heatmaps over batch
  and pixels, then the mean over joints.
* :func:`joints_ohkm_mse_loss`, JointsOHKMMSELoss: per-sample per-joint
  0.5 * MSE, online hard keypoint mining keeps the top k joints of each
  sample.

Heatmaps are channels-last (B, H, W, J) and reduced in float32; the
target weight is (B, J).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _weighted_diff(pred: Tensor, target: Tensor, target_weight: Tensor | None) -> Tensor:
    pred, target = pred.float(), target.float()
    if target_weight is not None:
        w = target_weight.float()[:, None, None, :]
        pred, target = pred * w, target * w
    return pred - target


def joints_mse_loss(pred: Tensor, target: Tensor, target_weight: Tensor | None = None) -> Tensor:
    """0.5 * target-weighted MSE, mean over (batch, pixels), then over joints."""
    diff = _weighted_diff(pred, target, target_weight)
    return (0.5 * (diff * diff).mean(dim=(0, 1, 2))).mean()


def joints_ohkm_mse_loss(pred: Tensor, target: Tensor, target_weight: Tensor | None = None,
                         topk: int = 8) -> Tensor:
    """Online hard keypoint mining: the mean over samples of each sample's
    top-k per-joint losses summed and divided by k."""
    diff = _weighted_diff(pred, target, target_weight)
    per_sample_joint = 0.5 * (diff * diff).mean(dim=(1, 2))  # (B, J)
    k = min(topk, per_sample_joint.shape[-1])
    return (torch.topk(per_sample_joint, k, dim=-1).values.sum(-1) / k).mean()
