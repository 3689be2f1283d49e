"""Region Proposal Network (port of ``models/rpn.py``).

Fixed shapes as in the JAX package: proposals come back as
(B, post_nms_topk, 4) with a validity mask. The NMS of every (image,
level) runs in one launch of kernel K4 (``ops/nms.py``): up to 1000
candidates a level at test time, 2000 in training. :func:`rpn_losses` is
the training loss (``label_and_sample_anchors`` and ``losses`` of
detectron2's ``rpn.py``), batched over the images.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from .layers import Conv
from .sampling import subsample_labels

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """The JAX package's ``RPNConfig``, with its defaults."""

    pre_nms_topk_train: int = 2000
    post_nms_topk_train: int = 1000
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    iou_thresholds: tuple[float, float] = (0.3, 0.7)
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    smooth_l1_beta: float = 0.0
    min_size: float = 0.0
    bbox_reg_weights: tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


class RPNHead(nn.Module):
    """Shared 3x3 conv -> (objectness, anchor deltas) per level.

    Takes NCHW levels; returns {level: (logits (B, H, W, A), deltas
    (B, H, W, 4A))} float32 in the JAX package's NHWC layout.
    """

    def __init__(self, in_channels: int, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv(in_channels, in_channels, 3, 1, 1)
        self.objectness = Conv(in_channels, num_anchors, 1)
        self.deltas = Conv(in_channels, num_anchors * 4, 1)

    def forward(self, feats: dict[str, Tensor]) -> dict[str, tuple[Tensor, Tensor]]:
        out = {}
        for lvl, x in feats.items():
            t = F.relu(self.conv(x))
            out[lvl] = (
                self.objectness(t).float().permute(0, 2, 3, 1),
                self.deltas(t).float().permute(0, 2, 3, 1),
            )
        return out


def top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``lax.top_k`` over the last dim: descending, ties to the lowest index.

    ``torch.topk`` does not promise that tie order; a stable descending
    sort does, and it decides which padded -inf slots come out.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_last(t: Tensor, n: int, fill) -> Tensor:
    """Pad dim 1 of (B, k, ...) up to n with ``fill``."""
    if t.shape[1] == n:
        return t
    pad = torch.full((t.shape[0], n - t.shape[1], *t.shape[2:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=1)


def find_top_proposals(
    head_out: dict[str, tuple[Tensor, Tensor]],
    anchors: dict[str, Tensor],
    image_hw: tuple[int, int],
    cfg: RPNConfig,
    train: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """Batched proposal selection (rpn.py:118 semantics, per image).

    Per level: top-k by objectness -> decode -> clip -> drop empty -> NMS;
    then the global top post_nms_topk over the survivors, with the train or
    test budgets. ``head_out`` is {level: (logits (B, H, W, A), deltas
    (B, H, W, 4A))}. Returns boxes (B, P, 4), scores (B, P), valid (B, P).
    """
    pre_k = cfg.pre_nms_topk_train if train else cfg.pre_nms_topk_test
    post_k = cfg.post_nms_topk_train if train else cfg.post_nms_topk_test
    h, w = image_hw
    levels = sorted(anchors)
    per_level = []
    for lvl in levels:
        logits, deltas = head_out[lvl]
        b = logits.shape[0]
        logits = logits.reshape(b, -1)
        deltas = deltas.reshape(b, -1, 4)
        scores, idx = top_k(logits, min(pre_k, logits.shape[1]))
        picked = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        boxes = box_ops.apply_deltas(picked, anchors[lvl][idx], cfg.bbox_reg_weights)
        boxes = box_ops.clip_boxes(boxes, h, w)
        valid = box_ops.nonempty_mask(boxes, cfg.min_size) & torch.isfinite(scores)
        per_level.append((boxes, scores, valid))

    # one NMS over every (image, level) problem: levels padded to the
    # widest with invalid slots, which neither survive nor suppress
    kmax = max(s.shape[1] for _, s, _ in per_level)
    keep_all = nms_ops.nms_mask(
        torch.stack([_pad_last(bx, kmax, 0.0) for bx, _, _ in per_level], dim=1),
        torch.stack([_pad_last(s, kmax, -torch.inf) for _, s, _ in per_level], dim=1),
        cfg.nms_thresh,
        torch.stack([_pad_last(v, kmax, False) for _, _, v in per_level], dim=1),
    )  # (B, L, kmax)
    boxes = torch.cat([bx for bx, _, _ in per_level], dim=1)
    scores = torch.cat([s for _, s, _ in per_level], dim=1)
    keep = torch.cat([keep_all[:, i, : s.shape[1]] for i, (_, s, _) in enumerate(per_level)], dim=1)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = top_k(masked, min(post_k, masked.shape[1]))
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, torch.isfinite(top_scores)


def smooth_l1(pred: Tensor, target: Tensor, beta: float) -> Tensor:
    diff = torch.abs(pred - target)
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def sigmoid_ce(logits: Tensor, targets: Tensor) -> Tensor:
    """``optax.sigmoid_binary_cross_entropy``: the stable BCE with logits."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def concat_levels(head_out: dict[str, tuple[Tensor, Tensor]], levels: list[str]) -> tuple[Tensor, Tensor]:
    """Every level's logits (B, N) and deltas (B, N, 4) in anchor order."""
    b = head_out[levels[0]][0].shape[0]
    logits = torch.cat([head_out[lvl][0].reshape(b, -1) for lvl in levels], dim=1)
    deltas = torch.cat([head_out[lvl][1].reshape(b, -1, 4) for lvl in levels], dim=1)
    return logits, deltas


def rpn_losses(
    head_out: dict[str, tuple[Tensor, Tensor]],
    anchors: dict[str, Tensor],
    gt_boxes: Tensor,  # (B, G, 4) padded
    gt_valid: Tensor,  # (B, G)
    pri_pos: Tensor,  # (B, N) uniform priorities of the positive and negative samples
    pri_neg: Tensor,
    cfg: RPNConfig = RPNConfig(),
) -> dict[str, Tensor]:
    """Per-image RPN losses (B,): anchors matched to the GT at
    ``iou_thresholds`` (low-quality matches kept), ``batch_size_per_image``
    of them sampled; the objectness BCE over the sampled and the L1 (or
    smooth L1) of the positives' deltas, each over ``batch_size_per_image``.
    An image without GT has only negatives (rpn.py:385-392)."""
    levels = sorted(anchors)
    anchor_cat = torch.cat([anchors[lvl] for lvl in levels], dim=0)
    logits, deltas = concat_levels(head_out, levels)
    iou = box_ops.pairwise_iou(gt_boxes, anchor_cat) * gt_valid[..., None]
    matched_idx, labels = box_ops.match_to_gt(iou, cfg.iou_thresholds, (0, -1, 1), allow_low_quality=True)
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, torch.zeros_like(labels))
    pos_sel, neg_sel = subsample_labels(labels, cfg.batch_size_per_image, cfg.positive_fraction, pri_pos, pri_neg)
    sel = pos_sel | neg_sel
    normalizer = float(cfg.batch_size_per_image)
    obj_loss_all = sigmoid_ce(logits, pos_sel.to(torch.float32))
    objectness_loss = torch.sum(obj_loss_all * sel, dim=-1) / normalizer
    matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
    gt_deltas = box_ops.get_deltas(anchor_cat, matched_gt, cfg.bbox_reg_weights)
    box_loss_all = torch.sum(smooth_l1(deltas, gt_deltas, cfg.smooth_l1_beta), dim=-1)
    localization_loss = torch.sum(box_loss_all * pos_sel, dim=-1) / normalizer
    return {"loss_rpn_cls": objectness_loss, "loss_rpn_loc": localization_loss}
