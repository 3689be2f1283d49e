"""Cascade R-CNN ROI heads and the mask and keypoint heads (port of ``models/cascade.py``).

detectron2's remaining ROI heads (modeling/roi_heads/cascade_rcnn.py,
mask_head.py, keypoint_head.py) in the JAX package's fixed-shape form:

* :class:`CascadeROIHeads`: three box stages, each pooling its boxes with
  kernel K2 in the gather read (``impl="gather"``: the JAX package's
  ``multilevel_roi_align`` default, no read window), its own box head and
  class-agnostic predictor; the class scores are averaged over the stages
  and the last stage's boxes kept. Boxes handed from one stage to the next
  carry no gradient.
* :class:`MaskHead` (4 x conv 256 -> transposed conv k2 s2 -> 1 x 1 per
  class) with :func:`mask_loss`; :class:`KeypointHead` (8 x conv 512 ->
  transposed conv k4 s2 -> x2 bilinear) with :func:`keypoint_loss` and
  :func:`keypoints_from_logits`. ``models/rcnn.GeneralizedRCNN`` runs them
  when its config asks for them.

Heads take pooled (R, P, P, C) features in the JAX package's NHWC layout,
run in the features' compute dtype (``dtype``) and return float32 NHWC.
Module names mirror the Flax tree (``mask_fcn1``, ``deconv``,
``predictor``, ``conv_fcn1``, ``score_lowres``, ``box_head0``,
``predictor0`` ...), so ``convert.flax_to_state_dict`` maps it by name.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import roi_align
from .layers import Conv, ConvTranspose, init_params, upsample_bilinear
from .roi_heads import BoxHead, FastRCNNOutput, ROIHeadsConfig
from .rpn import sigmoid_ce

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    base: ROIHeadsConfig = ROIHeadsConfig(cls_agnostic_bbox_reg=True)
    stage_ious: tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_weights: tuple[tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )


def pool_gather(feats: dict[str, Tensor], boxes: Tensor, cfg: ROIHeadsConfig, strides: dict[str, int],
                output_size: int) -> Tensor:
    """Boxes (B, R, 4) pooled from the levels ``cfg.in_levels`` of NHWC
    ``feats`` by K2's gather read: (B * R, P, P, C) float32."""
    b, r = boxes.shape[:2]
    batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(r)
    return roi_align.roi_align_multilevel(
        [feats[lvl].contiguous() for lvl in cfg.in_levels],
        boxes.reshape(b * r, 4).to(torch.float32).contiguous(), batch_idx, output_size,
        tuple(strides[lvl] for lvl in cfg.in_levels), sampling_ratio=cfg.pooler_sampling_ratio, impl="gather",
    )


class CascadeROIHeads(nn.Module):
    """Three refinement stages over NHWC ``feats`` {level: (B, H, W, C)}:
    ``forward(feats, boxes (B, R, 4), strides, image_hw)`` -> (the stages'
    mean softmax scores (B, R, C + 1), the last stage's boxes (B, R, 4)),
    float32. The compute dtype is the features'."""

    def __init__(self, config: CascadeConfig = CascadeConfig(), in_channels: int = 256, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        cfg = config.base
        p = cfg.pooler_resolution
        for s in range(len(config.stage_weights)):
            self.add_module(f"box_head{s}", BoxHead(in_channels * p * p, cfg.fc_dim, cfg.num_fc))
            self.add_module(f"predictor{s}", FastRCNNOutput(cfg.fc_dim, cfg.num_classes, True))
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():  # FastRCNNOutputLayers' init
            for s in range(len(config.stage_weights)):
                pred = getattr(self, f"predictor{s}")
                pred.cls_score.weight.normal_(0.0, 0.01, generator=generator)
                pred.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
        self.to(resolve_device(device))

    def forward(self, feats: dict[str, Tensor], boxes: Tensor, strides: dict[str, int],
                image_hw: tuple[int, int]) -> tuple[Tensor, Tensor]:
        cfg = self.config.base
        h, w = image_hw
        b, r = boxes.shape[:2]
        dtype = feats[cfg.in_levels[0]].dtype
        all_scores = []
        cur = boxes
        last = len(self.config.stage_weights) - 1
        for s, stage_w in enumerate(self.config.stage_weights):
            pooled = pool_gather(feats, cur, cfg, strides, cfg.pooler_resolution)
            x = getattr(self, f"box_head{s}")(pooled.to(dtype))
            scores, deltas = getattr(self, f"predictor{s}")(x)
            all_scores.append(torch.softmax(scores.reshape(b, r, -1), dim=-1))
            cur = box_ops.clip_boxes(box_ops.apply_deltas(deltas.reshape(b, r, 4), cur, stage_w), h, w)
            if s < last:  # the next stage's proposals: no gradient through them (cascade.py:73-74)
                cur = cur.detach()
        return torch.stack(all_scores).mean(dim=0), cur


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: ``num_convs`` 3x3 convs + ReLU, a k2 s2
    transposed conv + ReLU, a 1x1 conv to per-class logits.

    (R, P, P, C) pooled -> (R, 2P, 2P, num_classes) float32."""

    def __init__(self, in_channels: int, num_classes: int = 1, conv_dim: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"mask_fcn{i + 1}", Conv(in_channels if i == 0 else conv_dim, conv_dim, 3, 1, 1))
        cin = conv_dim if num_convs else in_channels
        self.deconv = ConvTranspose(cin, conv_dim, 2, 2, (1, 1))  # Flax "SAME" at k 2, s 2
        self.predictor = Conv(conv_dim, num_classes, 1)

    def forward(self, pooled: Tensor, dtype=torch.float32) -> Tensor:
        x = pooled.permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).float().permute(0, 2, 3, 1)


def mask_loss(mask_logits: Tensor, gt_masks: Tensor, gt_classes: Tensor, fg: Tensor) -> Tensor:
    """Per-ROI mean BCE of the GT class's mask channel, over the foreground
    ROIs (mask_head.py's loss). mask_logits (..., R, M, M, C), gt_masks
    (..., R, M, M), gt_classes (..., R), fg (..., R) -> (...), one loss per
    leading index (a scalar for one image's ROIs)."""
    cls = torch.clamp(gt_classes.to(torch.int64), 0, mask_logits.shape[-1] - 1)
    logits = torch.gather(mask_logits, -1, cls[..., None, None, None].expand(*mask_logits.shape[:-1], 1))[..., 0]
    per_roi = sigmoid_ce(logits, gt_masks.to(logits.dtype)).mean(dim=(-2, -1))
    fg = fg.to(per_roi.dtype)
    return torch.sum(per_roi * fg, dim=-1) / torch.clamp(torch.sum(fg, dim=-1), min=1.0)


class KeypointHead(nn.Module):
    """KRCNNConvDeconvUpsampleHead: ``num_convs`` 3x3 convs + ReLU, a k4 s2
    transposed conv (``score_lowres``), then a x2 bilinear upsample in
    float32.

    (R, P, P, C) pooled -> (R, 4P, 4P, num_keypoints) float32 logits."""

    def __init__(self, in_channels: int, num_keypoints: int = 17, conv_dim: int = 512, num_convs: int = 8):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv_fcn{i + 1}", Conv(in_channels if i == 0 else conv_dim, conv_dim, 3, 1, 1))
        cin = conv_dim if num_convs else in_channels
        self.score_lowres = ConvTranspose(cin, num_keypoints, 4, 2, (2, 2))  # Flax "SAME" at k 4, s 2

    def forward(self, pooled: Tensor, dtype=torch.float32) -> Tensor:
        x = pooled.permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        return upsample_bilinear(self.score_lowres(x).float(), 2).permute(0, 2, 3, 1)


def keypoint_loss(kp_logits: Tensor, gt_heatmap_idx: Tensor, kp_valid: Tensor, fg: Tensor) -> Tensor:
    """Softmax cross-entropy over each keypoint's flattened heatmap, over the
    valid keypoints of foreground ROIs (keypoint_rcnn_loss). kp_logits
    (..., R, S, S, K), gt_heatmap_idx (..., R, K) flat y * S + x, kp_valid
    (..., R, K), fg (..., R) -> (...), one loss per leading index."""
    *lead, r, hh, ww, k = kp_logits.shape
    logp = torch.log_softmax(kp_logits.reshape(*lead, r, hh * ww, k).transpose(-1, -2), dim=-1)  # (..., R, K, HW)
    picked = torch.gather(logp, -1, gt_heatmap_idx.to(torch.int64)[..., None])[..., 0]
    weights = kp_valid.to(picked.dtype) * fg.to(picked.dtype)[..., None]
    return -torch.sum(picked * weights, dim=(-2, -1)) / torch.clamp(torch.sum(weights, dim=(-2, -1)), min=1.0)


def keypoints_from_logits(kp_logits: Tensor, boxes: Tensor) -> Tensor:
    """(R, S, S, K) heatmap logits and their (R, 4) XYXY boxes -> (R, K, 3)
    image x, y and score: the first maximum's bin centre scaled into the
    box (x = x0 + (xi + 0.5) * w / S) and its softmax probability
    (keypoint_head.py heatmaps_to_keypoints)."""
    r, hh, ww, k = kp_logits.shape
    flat = kp_logits.reshape(r, hh * ww, k)
    idx = box_ops.first_argmin(flat, dim=1, largest=True)  # (R, K)
    score = torch.gather(torch.softmax(flat, dim=1), 1, idx[:, None, :])[:, 0, :]
    yi, xi = (idx // ww).to(torch.float32), (idx % ww).to(torch.float32)
    boxes = boxes.to(torch.float32)
    bw = torch.clamp(boxes[:, 2:3] - boxes[:, 0:1], min=1e-6)
    bh = torch.clamp(boxes[:, 3:4] - boxes[:, 1:2], min=1e-6)
    # divisors as tensors: PyTorch's CUDA division by a Python number multiplies by its reciprocal
    sw, sh = (torch.tensor(float(v), device=flat.device) for v in (ww, hh))
    x = boxes[:, 0:1] + (xi + 0.5) * bw / sw
    y = boxes[:, 1:2] + (yi + 0.5) * bh / sh
    return torch.stack([x, y, score], dim=-1)
