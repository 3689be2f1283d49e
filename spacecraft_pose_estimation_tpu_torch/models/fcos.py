"""FCOS: the anchor-free one-stage detector (port of ``models/fcos.py``).

detectron2's ``FCOS`` as the JAX package builds it: a ResNet backbone, an
FPN over res3-res5 without the max-pool level, learned p6 = conv(p5) and
p7 = conv(relu(p6)) (``LastLevelP6P7(in_feature="p5")``), class and box
towers shared over p3-p7, per-location class logits, linear LTRB distances
(``relu(pred * scale_l) * stride``, a learned ``scale_l`` a level) and
centerness. Training assigns each location to the smallest-area GT that
holds it, within its level's scale range and 1.5 strides of the GT's
centre; the focal loss on the classes, the GIoU of the decoded boxes
weighted by the centerness target and the BCE of the centerness are
normalized by batch-wide sums. Inference: a level's top 1,000 locations by
sqrt(sigmoid(cls) * sigmoid(ctr)), clipped, one class-aware NMS an image
(kernel K4: 2,843 candidates at 800^2) and the top detections.

Pixels only lose the mean (no std). Module names mirror the Flax tree
(``backbone``, ``fpn``, ``p6``, ``p7``, ``cls_conv0`` ... ``centerness``,
``scale_p3`` ...), so ``convert.flax_to_state_dict`` maps it by name.
Inside the model tensors are NCHW views of NHWC memory; the head's outputs
are laid out as the JAX package's (B, H * W * C) NHWC order.
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
from .fpn import FPN
from .layers import Conv, init_params
from .rcnn import PIXEL_MEAN
from .resnet_backbone import RESNET_TINY, ResNetBackbone, ResNetConfig
from .retinanet import RETINA_STRIDES, sigmoid_focal_loss
from .rpn import sigmoid_ce, top_k

Tensor = torch.Tensor

# each level's range of object scale (the largest LTRB distance), FCOS's defaults
SCALE_RANGES = {
    "p3": (0.0, 64.0),
    "p4": (64.0, 128.0),
    "p5": (128.0, 256.0),
    "p6": (256.0, 512.0),
    "p7": (512.0, 1e8),
}


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    """The JAX package's ``FCOSConfig``, with its defaults."""

    backbone: ResNetConfig = ResNetConfig(depth=50)
    fpn_channels: int = 256
    num_classes: int = 1
    num_convs: int = 4
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    center_sample_radius: float = 1.5  # x stride: FCOS's centre sampling
    score_thresh: float = 0.05
    nms_thresh: float = 0.6
    topk_candidates: int = 1000
    detections_per_image: int = 100
    prior_prob: float = 0.01


FCOS_TINY = FCOSConfig(backbone=RESNET_TINY, fpn_channels=16, num_convs=1, topk_candidates=64,
                       detections_per_image=4)


class FCOS(nn.Module):
    """FCOS over (B, H, W, 3) raw 0-255 BGR images.

    ``dtype`` is the compute dtype (bfloat16 for training on the card);
    parameters stay float32. ``forward`` returns padded detections {boxes
    (B, D, 4) XYXY, scores (B, D), classes (B, D), valid (B, D)};
    :meth:`losses` the training branch.
    """

    def __init__(self, config: FCOSConfig = FCOSConfig(), dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        ch = config.fpn_channels
        self.backbone = ResNetBackbone(config.backbone)
        res = self.backbone.out_channels
        self.fpn = FPN({k: res[k] for k in ("res3", "res4", "res5")}, ch, last_level_max_pool=False)
        self.p6 = Conv(ch, ch, 3, 2, 1)
        self.p7 = Conv(ch, ch, 3, 2, 1)
        self.num_convs = config.num_convs
        for i in range(config.num_convs):
            self.add_module(f"cls_conv{i}", Conv(ch, ch, 3, 1, 1))
            self.add_module(f"box_conv{i}", Conv(ch, ch, 3, 1, 1))
        self.cls_score = Conv(ch, config.num_classes, 3, 1, 1)
        self.bbox_pred = Conv(ch, 4, 3, 1, 1)
        self.centerness = Conv(ch, 1, 3, 1, 1)
        for lvl in RETINA_STRIDES:
            setattr(self, f"scale_{lvl}", nn.Parameter(torch.ones(())))
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        with torch.no_grad():
            self.cls_score.bias.fill_(-math.log((1 - config.prior_prob) / config.prior_prob))
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN), persistent=False)
        self.to(resolve_device(device))

    def pyramid(self, images: Tensor) -> dict[str, Tensor]:
        """Raw (B, H, W, 3) images -> {p3..p7: NCHW views of NHWC memory}."""
        x = (images.to(torch.float32) - self.pixel_mean).permute(0, 3, 1, 2)
        pyr = self.fpn(self.backbone(x.to(self.dtype, memory_format=torch.channels_last)))
        pyr["p6"] = self.p6(pyr["p5"])
        pyr["p7"] = self.p7(F.relu(pyr["p6"]))
        return pyr

    def head(self, images: Tensor):
        """Per location, p3 to p7 in the JAX package's order: class logits
        (B, N, C), decoded boxes (B, N, 4), centerness logits (B, N),
        float32; the locations' centres (N, 2), strides (N,) and scale
        ranges (N, 2); and each level's location count."""
        b = images.shape[0]
        pyr = self.pyramid(images)
        logits, boxes, ctrs, centres, strides, ranges, sizes = [], [], [], [], [], [], []
        for lvl in sorted(pyr):
            f = pyr[lvl]
            c = g = f
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                g = F.relu(getattr(self, f"box_conv{i}")(g))
            stride = RETINA_STRIDES[lvl]
            nhwc = lambda t: t.float().permute(0, 2, 3, 1)
            logits.append(nhwc(self.cls_score(c)).reshape(b, -1, self.config.num_classes))
            ltrb = (F.relu(nhwc(self.bbox_pred(g)) * getattr(self, f"scale_{lvl}")) * stride).reshape(b, -1, 4)
            ctrs.append(nhwc(self.centerness(g)).reshape(b, -1))
            fh, fw = f.shape[2], f.shape[3]
            ys = (torch.arange(fh, device=f.device, dtype=torch.float32) + 0.5) * stride
            xs = (torch.arange(fw, device=f.device, dtype=torch.float32) + 0.5) * stride
            centre = torch.stack([xs[None, :].expand(fh, fw).reshape(-1), ys[:, None].expand(fh, fw).reshape(-1)], -1)
            boxes.append(torch.cat([centre[None] - ltrb[..., :2], centre[None] + ltrb[..., 2:]], dim=-1))
            centres.append(centre)
            n = fh * fw
            strides.append(torch.full((n,), float(stride), device=f.device))
            ranges.append(torch.tensor(SCALE_RANGES[lvl], device=f.device).expand(n, 2))
            sizes.append(n)
        cat = lambda ts, d: torch.cat(ts, dim=d)
        return (cat(logits, 1), cat(boxes, 1), cat(ctrs, 1), cat(centres, 0), cat(strides, 0), cat(ranges, 0),
                sizes)

    def losses(self, images: Tensor, gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor) -> dict[str, Tensor]:
        """The JAX ``__call__(train=True)``: ``loss_cls`` (the focal loss over
        every location) and ``loss_centerness`` (the BCE over the foreground)
        over the batch's foreground count, ``loss_box_reg`` (the GIoU loss
        weighted by the centerness target) over the batch's sum of that
        target, and ``loss_total``.

        gt_boxes (B, G, 4) XYXY padded, gt_classes (B, G) 0-based, gt_valid (B, G).
        """
        cfg = self.config
        logits, boxes_pred, ctr, centres, strides, ranges, _ = self.head(images)
        gt_valid = gt_valid.to(torch.bool)
        gb = gt_boxes.to(torch.float32)  # (B, G, 4)
        cx, cy = centres[None, None, :, 0], centres[None, None, :, 1]  # (1, 1, N)
        ltrb_gt = torch.stack([cx - gb[..., 0, None], cy - gb[..., 1, None], gb[..., 2, None] - cx,
                               gb[..., 3, None] - cy], dim=-1)  # (B, G, N, 4)
        inside = ltrb_gt.amin(dim=-1) > 0
        max_d = ltrb_gt.amax(dim=-1)
        in_range = (max_d >= ranges[:, 0]) & (max_d <= ranges[:, 1])
        gt_cx = (gb[..., 0, None] + gb[..., 2, None]) / 2
        gt_cy = (gb[..., 1, None] + gb[..., 3, None]) / 2
        rad = cfg.center_sample_radius * strides
        near_centre = (torch.abs(cx - gt_cx) <= rad) & (torch.abs(cy - gt_cy) <= rad)
        candidate = inside & in_range & near_centre & gt_valid[..., None]
        area_mat = torch.where(candidate, box_ops.box_area(gb)[..., None], torch.full_like(max_d, math.inf))
        best = box_ops.first_argmin(area_mat, dim=1)  # the smallest candidate GT; 0 where none is
        fg = candidate.any(dim=1)  # (B, N)
        best_cls = torch.gather(gt_classes.to(torch.int64), 1, best)
        # jax.nn.one_hot: a row of zeros for a class outside [0, C)
        cls_t = (best_cls[..., None] == torch.arange(cfg.num_classes, device=gb.device)).float() * fg[..., None]
        cls_s = sigmoid_focal_loss(logits, cls_t, cfg.focal_alpha, cfg.focal_gamma).sum(dim=(1, 2))
        gt_box = torch.gather(gb, 1, best[..., None].expand(-1, -1, 4))
        lt = torch.gather(ltrb_gt, 1, best[:, None, :, None].expand(-1, 1, -1, 4))[:, 0]  # (B, N, 4)
        lr_min, lr_max = torch.minimum(lt[..., 0], lt[..., 2]), torch.maximum(lt[..., 0], lt[..., 2])
        tb_min, tb_max = torch.minimum(lt[..., 1], lt[..., 3]), torch.maximum(lt[..., 1], lt[..., 3])
        ctr_t = torch.sqrt(torch.clamp((lr_min / torch.clamp(lr_max, min=1e-6))
                                       * (tb_min / torch.clamp(tb_max, min=1e-6)), 0.0, 1.0))
        fgf = fg.to(torch.float32)
        ctr_w = ctr_t * fgf
        reg_s = torch.sum(box_ops.giou_loss(boxes_pred, gt_box) * ctr_w, dim=1)
        ctr_s = torch.sum(sigmoid_ce(ctr, ctr_t) * fgf, dim=1)
        num_pos = torch.clamp(fgf.sum(), min=1.0)
        loss_denorm = torch.clamp(ctr_w.sum(), min=1e-6)
        losses = {"loss_cls": cls_s.sum() / num_pos, "loss_box_reg": reg_s.sum() / loss_denorm,
                  "loss_centerness": ctr_s.sum() / num_pos}
        losses["loss_total"] = sum(losses.values())
        return losses

    def forward(self, images: Tensor) -> dict[str, Tensor]:
        """Per level the top ``topk_candidates`` (location, class) scores
        sqrt(sigmoid(cls) * sigmoid(ctr)); then per image one class-aware
        NMS over every level's candidates above ``score_thresh`` and the top
        ``detections_per_image`` kept."""
        cfg = self.config
        b, h, w, c = images.shape[0], images.shape[1], images.shape[2], cfg.num_classes
        logits, boxes_pred, ctr, _, _, _, sizes = self.head(images)
        cand_s, cand_b, cand_c = [], [], []
        start = 0
        for n in sizes:
            sl = slice(start, start + n)
            start += n
            sc = torch.sqrt(torch.sigmoid(logits[:, sl]) * torch.sigmoid(ctr[:, sl])[:, :, None]).reshape(b, -1)
            top, idx = top_k(sc, min(cfg.topk_candidates, sc.shape[1]))
            loc = idx // c
            cand_c.append(idx % c)
            cand_s.append(top)
            cand_b.append(torch.gather(boxes_pred[:, sl], 1, loc[..., None].expand(-1, -1, 4)))
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
