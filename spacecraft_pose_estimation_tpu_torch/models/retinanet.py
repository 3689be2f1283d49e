"""RetinaNet: the single-stage detector with the focal loss (port of ``models/retinanet.py``).

detectron2's ``RetinaNet`` as the reference's ``config_20`` trains it: a
ResNet backbone, an FPN over res3-res5 with learned p6 = conv(res5) and
p7 = conv(relu(p6)), 3 octave sizes x 3 aspect ratios a cell on p3-p7,
shared 4-conv class and box towers, the sigmoid focal loss, and at test
time a per-level top-k, one class-aware NMS over every level's candidates
(kernel K4: 4,441 boxes an image at 800^2) and the top detections.

Module names mirror the Flax tree (``backbone``, ``fpn``, ``p6``, ``p7``,
``head.cls_conv0`` ... ``head.cls_score``, ``head.bbox_pred``), so
``convert.flax_to_state_dict`` maps the JAX variables by name. Inside the
model tensors are NCHW views of NHWC memory; the head hands its outputs
over in the JAX package's NHWC layout, so that (B, H*W*A, C) is a view in
anchor order (y, x, a), class fastest.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from .anchors import fpn_anchors
from .fpn import FPN
from .layers import Conv, init_params
from .rcnn import PIXEL_MEAN, PIXEL_STD
from .resnet_backbone import RESNET101_FPN, RESNET_TINY, ResNetBackbone, ResNetConfig
from .rpn import sigmoid_ce, smooth_l1, top_k

Tensor = torch.Tensor

RETINA_STRIDES = {"p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


def octave_sizes(base: float) -> tuple[float, ...]:
    """Three anchor sizes an octave apart in thirds: base * 2^(k/3)."""
    return tuple(base * 2 ** (k / 3) for k in range(3))


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """The JAX package's ``RetinaNetConfig``, with its defaults."""

    backbone: ResNetConfig = RESNET101_FPN
    fpn_channels: int = 256
    num_classes: int = 1
    num_convs: int = 4
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 0.1
    iou_thresholds: tuple[float, float] = (0.4, 0.5)
    bbox_reg_weights: tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    topk_candidates: int = 1000
    detections_per_image: int = 100
    prior_prob: float = 0.01


RETINANET_TINY = RetinaNetConfig(
    backbone=RESNET_TINY, fpn_channels=16, num_convs=1, topk_candidates=64, detections_per_image=4,
)


class RetinaNetHead(nn.Module):
    """Shared towers of ``num_convs`` 3x3 convs -> per-anchor class logits and box deltas.

    Takes NCHW levels; returns {level: (logits (B, H, W, A*C), deltas
    (B, H, W, A*4))} float32 in the JAX package's NHWC layout. ``cls_score``'s
    bias starts at the prior's log-odds.
    """

    def __init__(self, channels: int, num_classes: int, num_anchors: int, num_convs: int, prior_prob: float):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"cls_conv{i}", Conv(channels, channels, 3, 1, 1))
            self.add_module(f"box_conv{i}", Conv(channels, channels, 3, 1, 1))
        self.cls_score = Conv(channels, num_anchors * num_classes, 3, 1, 1)
        self.bbox_pred = Conv(channels, num_anchors * 4, 3, 1, 1)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)

    def forward(self, feats: dict[str, Tensor]) -> dict[str, tuple[Tensor, Tensor]]:
        out = {}
        for lvl, x in feats.items():
            c = b = x
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                b = F.relu(getattr(self, f"box_conv{i}")(b))
            out[lvl] = (self.cls_score(c).float().permute(0, 2, 3, 1),
                        self.bbox_pred(b).float().permute(0, 2, 3, 1))
        return out


def sigmoid_focal_loss(logits: Tensor, targets: Tensor, alpha: float, gamma: float) -> Tensor:
    """The elementwise focal loss on optax's ``sigmoid_binary_cross_entropy``."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


class RetinaNet(nn.Module):
    """RetinaNet over (B, H, W, 3) raw 0-255 BGR images.

    ``dtype`` is the compute dtype (bfloat16 for training on the card);
    parameters stay float32. ``forward`` returns padded detections
    {boxes (B, D, 4) XYXY, scores (B, D), classes (B, D), valid (B, D)};
    :meth:`losses` the training branch.
    """

    def __init__(self, config: RetinaNetConfig = RetinaNetConfig(), dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.backbone = ResNetBackbone(config.backbone)
        res = self.backbone.out_channels
        self.fpn = FPN({k: res[k] for k in ("res3", "res4", "res5")}, config.fpn_channels,
                       last_level_max_pool=False)
        self.p6 = Conv(res["res5"], config.fpn_channels, 3, 2, 1)
        self.p7 = Conv(config.fpn_channels, config.fpn_channels, 3, 2, 1)
        self.num_anchors = 3 * len(config.aspect_ratios)
        self.head = RetinaNetHead(config.fpn_channels, config.num_classes, self.num_anchors, config.num_convs,
                                  config.prior_prob)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        with torch.no_grad():
            self.head.cls_score.bias.fill_(self.head.prior_bias)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD), persistent=False)
        self._anchors: dict = {}
        self.to(resolve_device(device))

    def anchors(self, shapes: dict[str, tuple[int, int]], device) -> dict[str, Tensor]:
        """Per-level anchors for these pyramid shapes, built once per shape:
        ``octave_sizes(4 * stride)`` on each level."""
        key = (tuple(sorted(shapes.items())), str(device))
        if key not in self._anchors:
            sizes = {lvl: octave_sizes(4 * RETINA_STRIDES[lvl]) for lvl in shapes}
            self._anchors[key] = fpn_anchors(shapes, RETINA_STRIDES, sizes, self.config.aspect_ratios, device=device)
        return self._anchors[key]

    def pyramid(self, images: Tensor) -> dict[str, Tensor]:
        """Raw (B, H, W, 3) images -> {p3..p7: NCHW views of NHWC memory}."""
        x = ((images.to(torch.float32) - self.pixel_mean) / self.pixel_std).permute(0, 3, 1, 2)
        feats = self.backbone(x.to(self.dtype, memory_format=torch.channels_last))
        pyr = self.fpn(feats)
        pyr["p6"] = self.p6(feats["res5"])
        pyr["p7"] = self.p7(F.relu(pyr["p6"]))
        return pyr

    def _outputs(self, images: Tensor):
        """The levels (p3..p7), the head's outputs and the anchors."""
        pyr = self.pyramid(images)
        levels = sorted(pyr)
        anchors = self.anchors({lvl: (pyr[lvl].shape[2], pyr[lvl].shape[3]) for lvl in levels}, images.device)
        return levels, self.head(pyr), anchors

    def losses(self, images: Tensor, gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor) -> dict[str, Tensor]:
        """The JAX ``__call__(train=True)``: every anchor matched to the GT at
        ``iou_thresholds`` (low-quality matches kept; an image without GT
        all background), the focal loss over the anchors not ignored and the
        smooth-L1 of the foreground's deltas, summed over the batch
        (``loss_cls_sum``, ``loss_box_reg_sum``), ``num_fg`` = max(foreground
        anchors, 1), and each sum over ``num_fg`` (``loss_cls``,
        ``loss_box_reg``, ``loss_total`` their sum): the normalization by the
        batch's own count, which the EMA train step rescales.

        gt_boxes (B, G, 4) XYXY padded, gt_classes (B, G) 0-based, gt_valid (B, G).
        """
        cfg = self.config
        b, c = images.shape[0], cfg.num_classes
        levels, head, anchors = self._outputs(images)
        logits = torch.cat([head[lvl][0].reshape(b, -1, c) for lvl in levels], dim=1)
        deltas = torch.cat([head[lvl][1].reshape(b, -1, 4) for lvl in levels], dim=1)
        anchor_cat = torch.cat([anchors[lvl] for lvl in levels], dim=0)
        gt_valid = gt_valid.to(torch.bool)
        iou = box_ops.pairwise_iou(gt_boxes, anchor_cat) * gt_valid[..., None]
        matched_idx, labels = box_ops.match_to_gt(iou, cfg.iou_thresholds, (0, -1, 1), allow_low_quality=True)
        labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, torch.zeros_like(labels))
        fg, kept = labels == 1, labels >= 0
        matched_cls = torch.gather(gt_classes, 1, matched_idx)
        # jax.nn.one_hot: a row of zeros for a class outside [0, C)
        cls_t = (matched_cls[..., None] == torch.arange(c, device=images.device)).float() * fg[..., None]
        cls_loss = torch.sum(sigmoid_focal_loss(logits, cls_t, cfg.focal_alpha, cfg.focal_gamma) * kept[..., None])
        matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
        gt_deltas = box_ops.get_deltas(anchor_cat, matched_gt, cfg.bbox_reg_weights)
        reg_loss = torch.sum(torch.sum(smooth_l1(deltas, gt_deltas, cfg.smooth_l1_beta), dim=-1) * fg)
        num_fg = torch.clamp(fg.sum().to(torch.float32), min=1.0)
        losses = {"loss_cls_sum": cls_loss, "loss_box_reg_sum": reg_loss, "num_fg": num_fg,
                  "loss_cls": cls_loss / num_fg, "loss_box_reg": reg_loss / num_fg}
        losses["loss_total"] = losses["loss_cls"] + losses["loss_box_reg"]
        return losses

    def forward(self, images: Tensor) -> dict[str, Tensor]:
        """Per level the top ``topk_candidates`` (anchor, class) scores,
        decoded; then per image one class-aware NMS over every level's
        candidates above ``score_thresh`` and the top
        ``detections_per_image`` kept."""
        cfg = self.config
        b, h, w, c = images.shape[0], images.shape[1], images.shape[2], cfg.num_classes
        levels, head, anchors = self._outputs(images)
        cand_s, cand_b, cand_c = [], [], []
        for lvl in levels:
            flat = torch.sigmoid(head[lvl][0]).reshape(b, -1)
            top, idx = top_k(flat, min(cfg.topk_candidates, flat.shape[1]))
            a_idx = idx // c
            picked = torch.gather(head[lvl][1].reshape(b, -1, 4), 1, a_idx[..., None].expand(-1, -1, 4))
            cand_b.append(box_ops.apply_deltas(picked, anchors[lvl][a_idx], cfg.bbox_reg_weights))
            cand_s.append(top)
            cand_c.append(idx % c)
        scores = torch.cat(cand_s, dim=1)
        boxes = box_ops.clip_boxes(torch.cat(cand_b, dim=1), h, w)
        classes = torch.cat(cand_c, dim=1)
        keep = nms_ops.batched_nms_mask(boxes, scores, classes, cfg.nms_thresh, scores > cfg.score_thresh)
        masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
        top_s, top_i = top_k(masked, min(cfg.detections_per_image, masked.shape[1]))
        found = torch.isfinite(top_s)
        return {
            "boxes": torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)),
            "scores": torch.where(found, top_s, torch.zeros_like(top_s)),
            "classes": torch.gather(classes, 1, top_i).to(torch.int32),
            "valid": found,
        }
