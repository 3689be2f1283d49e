"""Standard ROI heads (port of ``models/roi_heads.py``).

Pooler (kernel K2, one launch for every image's boxes; in training its
backward, K2's backward kernel) -> box head -> FastRCNN outputs ->
``fast_rcnn_inference`` with class-aware NMS (kernel K4, one launch for
every image), or in training :func:`sample_proposals` and
:func:`fast_rcnn_losses`. Every ragged structure stays padded and masked,
as in the JAX package; every function here is batched over the images.
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
from .rpn import smooth_l1, top_k
from .sampling import gather_topk_mask, subsample_labels

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ROIHeadsConfig:
    """The JAX package's ``ROIHeadsConfig``, with its defaults.

    ``pooler_window`` is the per-box read window of kernel K2. Both of the
    JAX package's windowed poolers run on K2, each with its own read window
    (``ops.roi_align``): ``"windowed"`` (XLA; the one its trainer
    differentiates) and ``"pallas"`` (its Pallas kernel). They pool the same
    wherever a box fits the window. K2 has a backward kernel for either, so
    ``"pallas"`` (``config_4``) trains in the port, where ``jax.grad``
    through the Pallas pooler raises. The box head takes these two; the
    ``"gather"`` read (unwindowed, K2 too) is the mask and keypoint heads'
    and the cascade's, which call it themselves.
    """

    num_classes: int = 1
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_threshold: float = 0.5
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    fc_dim: int = 1024
    num_fc: int = 2
    cls_agnostic_bbox_reg: bool = False
    smooth_l1_beta: float = 0.0
    bbox_reg_weights: tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_image: int = 100
    in_levels: tuple[str, ...] = ("p2", "p3", "p4", "p5")
    pooler_impl: str = "windowed"
    pooler_window: int = 48

    def __post_init__(self):
        if self.pooler_impl not in roi_align.READS or self.pooler_impl == "gather":
            raise ValueError(f"pooler_impl {self.pooler_impl!r}: the port's box head has the windowed reads "
                             "'windowed' and 'pallas' (both kernel K2)")


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
            impl=cfg.pooler_impl,
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


def sample_proposals(
    proposals: Tensor,  # (B, P, 4)
    prop_valid: Tensor,  # (B, P)
    gt_boxes: Tensor,  # (B, G, 4) padded
    gt_classes: Tensor,  # (B, G) 0-based class ids
    gt_valid: Tensor,  # (B, G)
    pri_pos: Tensor,  # (B, P + G) uniform priorities: the positives' and negatives' sampling,
    pri_neg: Tensor,
    pri_gather: Tensor,  # and the gather of the sampled subset
    cfg: ROIHeadsConfig,
) -> dict[str, Tensor]:
    """``label_and_sample_proposals`` per image (roi_heads.py:181-280).

    The GT boxes join the proposals (``add_ground_truth_to_proposals``), so
    each GT is at least its own positive; candidates are matched at
    ``iou_threshold`` and ``batch_size_per_image`` of them sampled with
    ``positive_fraction`` positives. Returns the sampled ``boxes`` (B, S,
    4), ``valid``, ``gt_classes`` (``num_classes`` for background),
    matched ``gt_boxes`` and ``is_fg``, S = ``batch_size_per_image``.
    """
    boxes = torch.cat([proposals, gt_boxes], dim=1)
    valid = torch.cat([prop_valid, gt_valid], dim=1)
    iou = box_ops.pairwise_iou(gt_boxes, boxes) * gt_valid[..., None]
    iou = iou * valid[:, None, :]
    matched_idx, matched_labels = box_ops.match_to_gt(iou, (cfg.iou_threshold,), (0, 1), allow_low_quality=False)
    has_gt = gt_valid.any(dim=-1, keepdim=True)
    fg = (matched_labels == 1) & valid & has_gt
    bg = (matched_labels == 0) & valid
    background = torch.full_like(matched_idx, cfg.num_classes)
    labels = torch.where(fg, torch.gather(gt_classes.to(torch.int64), 1, matched_idx), background)
    sample_labels = torch.where(fg, 1, torch.where(bg, 0, -1))
    pos_sel, neg_sel = subsample_labels(sample_labels, cfg.batch_size_per_image, cfg.positive_fraction,
                                        pri_pos, pri_neg)
    idx, sel_valid = gather_topk_mask(pos_sel | neg_sel, cfg.batch_size_per_image, pri_gather)
    take = lambda t: torch.gather(t, 1, idx)
    gt_idx = take(matched_idx)
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "valid": sel_valid,
        "gt_classes": torch.where(sel_valid, take(labels), take(background)),
        "gt_boxes": torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4)),
        "is_fg": take(pos_sel) & sel_valid,
    }


def fast_rcnn_losses(scores: Tensor, deltas: Tensor, sampled: dict[str, Tensor],
                     cfg: ROIHeadsConfig) -> dict[str, Tensor]:
    """Per-image softmax CE over the valid samples and L1 (or smooth L1) of
    the foreground's box deltas, both over the count of valid samples
    (fast_rcnn.py:307-420). scores (B, S, C+1), deltas (B, S, 4*reg) -> (B,)."""
    valid = sampled["valid"]
    n_valid = torch.clamp(valid.sum(dim=-1).to(torch.float32), min=1.0)
    logp = torch.log_softmax(scores, dim=-1)
    cls_loss = -torch.gather(logp, 2, sampled["gt_classes"][..., None])[..., 0]
    loss_cls = torch.sum(cls_loss * valid, dim=-1) / n_valid
    gt_deltas = box_ops.get_deltas(sampled["boxes"], sampled["gt_boxes"], cfg.bbox_reg_weights)
    b, r = valid.shape
    if cfg.cls_agnostic_bbox_reg:
        fg_deltas = deltas.reshape(b, r, 4)
    else:
        d = deltas.reshape(b, r, cfg.num_classes, 4)
        cls_idx = torch.clamp(sampled["gt_classes"], 0, cfg.num_classes - 1)
        fg_deltas = torch.gather(d, 2, cls_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg = torch.sum(smooth_l1(fg_deltas, gt_deltas, cfg.smooth_l1_beta), dim=-1)
    loss_box = torch.sum(reg * sampled["is_fg"], dim=-1) / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}
