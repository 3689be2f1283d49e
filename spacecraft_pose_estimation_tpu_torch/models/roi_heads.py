"""Standard ROI heads, inference half (port of ``models/roi_heads.py``).

Pooler (kernel K2, one launch for every image's boxes) -> box head ->
FastRCNN outputs -> ``fast_rcnn_inference`` with class-aware NMS (kernel
K4, one launch for every image). Every ragged structure stays padded and
masked, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from ..ops import roi_align
from .layers import Linear
from .rpn import top_k

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ROIHeadsConfig:
    """The inference fields of the JAX package's ``ROIHeadsConfig``.

    ``pooler_window`` is the per-box read window of kernel K2 (the
    JAX package's ``pallas`` pooler semantics); the port has no other
    pooler, so ``pooler_impl`` is not a field here.
    """

    num_classes: int = 1
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    fc_dim: int = 1024
    num_fc: int = 2
    cls_agnostic_bbox_reg: bool = False
    bbox_reg_weights: tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_image: int = 100
    in_levels: tuple[str, ...] = ("p2", "p3", "p4", "p5")
    pooler_window: int = 48


class BoxHead(nn.Module):
    """Flatten pooled (R, P, P, C) features -> ``num_fc`` ReLU FC layers."""

    def __init__(self, in_features: int, fc_dim: int = 1024, num_fc: int = 2):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(in_features if i == 0 else fc_dim, fc_dim))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutput(nn.Module):
    """Linear classifier (+1 background) and box regressor, float32 out."""

    def __init__(self, in_features: int, num_classes: int, cls_agnostic: bool = False):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes + 1)
        self.bbox_pred = Linear(in_features, 4 * (1 if cls_agnostic else num_classes))

    def forward(self, x):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class StandardROIHeads(nn.Module):
    """Pooler + box head + output layers over a batch of images.

    ``feats`` {level: (B, H, W, C)} NHWC, ``boxes`` (B, R, 4) -> scores
    (B, R, C+1) and deltas (B, R, 4*reg), float32. The compute dtype is
    that of the features.
    """

    def __init__(self, config: ROIHeadsConfig, in_channels: int):
        super().__init__()
        self.config = config
        p = config.pooler_resolution
        self.box_head = BoxHead(in_channels * p * p, config.fc_dim, config.num_fc)
        self.predictor = FastRCNNOutput(
            config.fc_dim, config.num_classes, config.cls_agnostic_bbox_reg
        )

    def forward(self, feats: dict[str, Tensor], boxes: Tensor, strides: dict[str, int]):
        cfg = self.config
        b, r = boxes.shape[:2]
        level_feats = [feats[lvl].contiguous() for lvl in cfg.in_levels]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(r)
        pooled = roi_align.roi_align_multilevel(
            level_feats,
            boxes.reshape(b * r, 4).to(torch.float32).contiguous(),
            batch_idx,
            cfg.pooler_resolution,
            tuple(strides[lvl] for lvl in cfg.in_levels),
            sampling_ratio=cfg.pooler_sampling_ratio,
            window=cfg.pooler_window,
        )
        x = self.box_head(pooled.to(level_feats[0].dtype))
        scores, deltas = self.predictor(x)
        return scores.reshape(b, r, -1), deltas.reshape(b, r, -1)


def fast_rcnn_inference(
    scores: Tensor,  # (B, R, C+1) logits
    deltas: Tensor,  # (B, R, 4*reg)
    proposals: Tensor,  # (B, R, 4)
    prop_valid: Tensor,  # (B, R)
    image_hw: tuple[int, int],
    cfg: ROIHeadsConfig,
) -> dict[str, Tensor]:
    """Score filter -> per-class NMS -> top-k, per image (fast_rcnn.py:118).

    Fixed output size ``detections_per_image``; ``valid`` marks real ones.
    """
    b, r = proposals.shape[:2]
    c = cfg.num_classes
    probs = torch.softmax(scores, dim=-1)[..., :c]  # (B, R, C)
    if cfg.cls_agnostic_bbox_reg:
        decoded = box_ops.apply_deltas(deltas.reshape(b, r, 4), proposals, cfg.bbox_reg_weights)
        boxes_per_class = decoded[:, :, None, :].expand(b, r, c, 4)
    else:
        boxes_per_class = box_ops.apply_deltas(
            deltas.reshape(b, r, c, 4), proposals[:, :, None, :], cfg.bbox_reg_weights
        )
    h, w = image_hw
    flat_boxes = box_ops.clip_boxes(boxes_per_class, h, w).reshape(b, r * c, 4)
    flat_scores = probs.reshape(b, r * c)
    flat_cls = torch.arange(c, device=scores.device).repeat(r).expand(b, r * c)
    flat_valid = (
        (flat_scores > cfg.score_thresh)
        & prop_valid.repeat_interleave(c, dim=1)
        & box_ops.nonempty_mask(flat_boxes)
    )
    keep = nms_ops.batched_nms_mask(flat_boxes, flat_scores, flat_cls, cfg.nms_thresh, flat_valid)
    masked = torch.where(keep, flat_scores, torch.full_like(flat_scores, -torch.inf))
    top_scores, top_idx = top_k(masked, min(cfg.detections_per_image, r * c))
    finite = torch.isfinite(top_scores)
    return {
        "boxes": torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(finite, top_scores, torch.zeros_like(top_scores)),
        "classes": torch.gather(flat_cls, 1, top_idx),
        "valid": finite,
    }
