"""GeneralizedRCNN: backbone -> FPN -> RPN -> ROI heads.

Port of ``models/rcnn.py`` with its X101 and R101 presets and
``select_best_box``: inference (``forward``) and the training losses
(:meth:`GeneralizedRCNN.losses`, the JAX ``train=True`` branch), with the
Mask and Keypoint R-CNN heads of ``models/cascade.py`` where the config
asks for them (``with_mask``, ``with_keypoints``): they pool with kernel
K2's gather read at ``mask_resolution``. Images arrive pre-sized (a
letterbox), and detections leave as padded (B, D) arrays with a ``valid``
mask.

Inside the model, tensors are NCHW views of NHWC memory (the
``channels_last`` format), so the pyramid hands its levels to kernel K2 as
NHWC without a copy.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import roi_align
from .anchors import fpn_anchors
from .cascade import KeypointHead, MaskHead, keypoint_loss, mask_loss, pool_gather
from .fpn import FPN, FPN_STRIDES
from .layers import init_params
from .resnet_backbone import RESNET101_FPN, RESNET_TINY, RESNEXT101_32x8d, ResNetBackbone, ResNetConfig
from .roi_heads import ROIHeadsConfig, StandardROIHeads, fast_rcnn_inference, fast_rcnn_losses, sample_proposals
from .rpn import RPNConfig, RPNHead, find_top_proposals, rpn_losses

Tensor = torch.Tensor

# Caffe2 zoo pixel stats (detectron2 configs: BGR mean, std 1).
PIXEL_MEAN = (103.530, 116.280, 123.675)
PIXEL_STD = (1.0, 1.0, 1.0)
# The X101-32x8d trunk is torch-trained: its config sets a per-channel std
# (faster_rcnn_X_101_32x8d_FPN_3x.yaml).
X101_PIXEL_STD = (57.375, 57.120, 58.395)


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    backbone: ResNetConfig = RESNET101_FPN
    fpn_channels: int = 256
    anchor_sizes: tuple[tuple[float, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    anchor_aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn: RPNConfig = RPNConfig()
    roi: ROIHeadsConfig = ROIHeadsConfig()
    pixel_mean: tuple[float, float, float] = PIXEL_MEAN
    pixel_std: tuple[float, float, float] = PIXEL_STD
    # Mask / Keypoint R-CNN: the heads of models/cascade.py on the sampled ROIs, then on the detections
    with_mask: bool = False
    with_keypoints: bool = False
    num_keypoints: int = 17
    mask_resolution: int = 14  # the heads' pooler side; the mask head's output is 2x, the keypoint head's 4x


# The reference's detector (config_4: X101-FPN) with the spacecraft ROI
# heads: one class, class-agnostic boxes, two detections per image, 1000
# proposals per level and image, the Pallas pooler (kernel K2 here, as the
# windowed one is).
FASTER_RCNN_X101_SPACECRAFT = RCNNConfig(
    backbone=RESNEXT101_32x8d,
    roi=ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, detections_per_image=2, pooler_impl="pallas"),
    pixel_std=X101_PIXEL_STD,
)
# Serving variant: the same weights, 512/256 proposals.
FASTER_RCNN_X101_SERVING = dataclasses.replace(
    FASTER_RCNN_X101_SPACECRAFT,
    rpn=RPNConfig(pre_nms_topk_test=512, post_nms_topk_test=256),
)
# config_2 semantics (R101-FPN, a Caffe2 model: std 1) with the same heads.
FASTER_RCNN_R101_SPACECRAFT = dataclasses.replace(
    FASTER_RCNN_X101_SPACECRAFT, backbone=RESNET101_FPN, pixel_std=PIXEL_STD,
)
# Single-object serving point: 256/64 proposals per level / image.
FASTER_RCNN_R101_SERVING_1OBJ = dataclasses.replace(
    FASTER_RCNN_R101_SPACECRAFT,
    rpn=RPNConfig(pre_nms_topk_test=256, post_nms_topk_test=64),
)
RCNN_TINY = RCNNConfig(
    backbone=RESNET_TINY,
    fpn_channels=16,
    rpn=RPNConfig(pre_nms_topk_train=64, post_nms_topk_train=32, pre_nms_topk_test=64, post_nms_topk_test=32,
                  batch_size_per_image=16),
    roi=ROIHeadsConfig(
        num_classes=1, cls_agnostic_bbox_reg=True, batch_size_per_image=16, fc_dim=32, detections_per_image=2,
    ),
)

DRAW_KEYS = ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_gather")


def sample_draws(generator: torch.Generator | None, b: int, num_anchors: int, num_candidates: int,
                 device) -> dict[str, Tensor]:
    """The uniform priorities of one training step's sampling: per image,
    the RPN's positives and negatives over its ``num_anchors`` anchors, the
    ROI heads' positives, negatives and gather over the ``num_candidates``
    proposals and GT boxes. The JAX model draws them from its ``sampling``
    key; the tests hand those draws in through ``GeneralizedRCNN.losses``."""
    shapes = (num_anchors,) * 2 + (num_candidates,) * 3
    # from a CPU generator, so that one seed gives the same draws on every device
    return {k: torch.rand((b, n), generator=generator).to(device) for k, n in zip(DRAW_KEYS, shapes)}


class GeneralizedRCNN(nn.Module):
    """Faster R-CNN inference over (B, H, W, 3) raw 0-255 images.

    ``dtype`` is the compute dtype (bfloat16 for serving); parameters
    stay float32. Returns {boxes (B, D, 4) XYXY, scores (B, D), classes
    (B, D), valid (B, D)} and, with the config's heads, ``mask_logits``
    (B, D, 2P, 2P, num_classes) and ``keypoint_logits`` (B, D, 4P, 4P,
    num_keypoints), P = ``mask_resolution``, float32, for every one of the
    D detections (the invalid ones too, as in the JAX package).
    """

    def __init__(self, config: RCNNConfig = FASTER_RCNN_R101_SPACECRAFT, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.backbone = ResNetBackbone(config.backbone)
        self.fpn = FPN(self.backbone.out_channels, config.fpn_channels)
        num_anchors = len(config.anchor_aspect_ratios) * len(config.anchor_sizes[0])
        self.rpn_head = RPNHead(config.fpn_channels, num_anchors)
        self.roi_heads = StandardROIHeads(config.roi, config.fpn_channels)
        if config.with_mask:
            self.mask_head = MaskHead(config.fpn_channels, config.roi.num_classes)
        if config.with_keypoints:
            self.keypoint_head = KeypointHead(config.fpn_channels, config.num_keypoints)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():  # FastRCNNOutputLayers' init
            self.roi_heads.predictor.cls_score.weight.normal_(0.0, 0.01, generator=generator)
            self.roi_heads.predictor.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
        self.register_buffer("pixel_mean", torch.tensor(config.pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(config.pixel_std), persistent=False)
        self._anchors: dict = {}
        self.to(resolve_device(device))

    def anchors(self, shapes: dict[str, tuple[int, int]], device) -> dict[str, Tensor]:
        """Per-level anchors for these pyramid shapes, built once per shape."""
        key = (tuple(sorted(shapes.items())), str(device))
        if key not in self._anchors:
            sizes = {lvl: self.config.anchor_sizes[i] for i, lvl in enumerate(sorted(shapes))}
            self._anchors[key] = fpn_anchors(
                shapes, FPN_STRIDES, sizes, self.config.anchor_aspect_ratios, device=device
            )
        return self._anchors[key]

    def normalize(self, images: Tensor) -> Tensor:
        """Raw (B, H, W, 3) images -> (x - pixel_mean) / pixel_std, float32 NHWC."""
        return (images.to(torch.float32) - self.pixel_mean) / self.pixel_std

    def pyramid(self, images: Tensor, precomputed_feats: dict[str, Tensor] | None = None) -> dict[str, Tensor]:
        """Raw (B, H, W, 3) images -> {p2..p6: NCHW views of NHWC memory}.

        ``precomputed_feats`` ({res2..res5: (B, h, w, C) NHWC}, e.g. from
        ``backbone_int8.backbone_int8_apply``) replace the backbone's.
        """
        if precomputed_feats is not None:
            feats = {k: v.permute(0, 3, 1, 2).to(self.dtype) for k, v in precomputed_feats.items()}
        else:
            x = self.normalize(images).permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
            feats = self.backbone(x)
        return self.fpn(feats)

    def losses(self, images: Tensor, gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor,
               generator: torch.Generator | None = None, draws: dict[str, Tensor] | None = None,
               gt_masks: Tensor | None = None, gt_keypoints: Tensor | None = None) -> dict[str, Tensor]:
        """The training losses (the JAX ``__call__(train=True)``), each the
        mean over the batch, and ``loss_total`` their sum.

        images (B, H, W, 3) raw 0-255; gt_boxes (B, G, 4) XYXY padded,
        gt_classes (B, G) 0-based, gt_valid (B, G). Proposals take the train
        budgets and carry no gradient; the sampling's priorities come from
        ``draws`` (see :func:`sample_draws`) or are drawn from
        ``generator``. With the config's heads, ``gt_masks`` (B, G, H, W)
        bool adds ``loss_mask`` and ``gt_keypoints`` (B, G, K, 3) x, y,
        visibility adds ``loss_keypoint``, both on the sampled ROIs pooled by
        K2's gather read at ``mask_resolution``.
        """
        cfg = self.config
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        pyramid = self.pyramid(images)
        shapes = {lvl: (p.shape[2], p.shape[3]) for lvl, p in pyramid.items()}
        anchors = self.anchors(shapes, images.device)
        head_out = self.rpn_head(pyramid)
        with torch.no_grad():  # the JAX model stops the gradient through the proposals
            proposals, _, prop_valid = find_top_proposals(head_out, anchors, (h, w), cfg.rpn, train=True)
        if draws is None:
            draws = sample_draws(generator, b, sum(a.shape[0] for a in anchors.values()),
                                 proposals.shape[1] + gt_boxes.shape[1], images.device)
        gt_valid = gt_valid.to(torch.bool)
        sampled = sample_proposals(proposals, prop_valid, gt_boxes, gt_classes, gt_valid, draws["roi_pos"],
                                   draws["roi_neg"], draws["roi_gather"], cfg.roi)
        nhwc = {lvl: p.permute(0, 2, 3, 1) for lvl, p in pyramid.items()}
        scores, deltas = self.roi_heads(nhwc, sampled["boxes"], FPN_STRIDES)
        per_image = {
            **rpn_losses(head_out, anchors, gt_boxes, gt_valid, draws["rpn_pos"], draws["rpn_neg"], cfg.rpn),
            **fast_rcnn_losses(scores, deltas, sampled, cfg.roi),
        }
        losses = {k: v.mean() for k, v in per_image.items()}
        train_mask, train_kps = cfg.with_mask and gt_masks is not None, cfg.with_keypoints and gt_keypoints is not None
        if train_mask or train_kps:
            losses.update(self._head_losses(nhwc, sampled, gt_boxes, gt_masks if train_mask else None,
                                            gt_keypoints if train_kps else None))
        losses["loss_total"] = sum(losses.values())
        return losses

    def _head_losses(self, nhwc: dict[str, Tensor], sampled: dict[str, Tensor], gt_boxes: Tensor,
                     gt_masks: Tensor | None, gt_keypoints: Tensor | None) -> dict[str, Tensor]:
        """``loss_mask`` and ``loss_keypoint`` on the sampled ROIs (JAX
        rcnn.py:205-280): each ROI's GT is recovered as the GT box nearest
        (L1, the first on ties) to the box it was matched to."""
        cfg = self.config
        rois = sampled["boxes"]
        bb, rr = rois.shape[:2]
        pooled = pool_gather(nhwc, rois, cfg.roi, FPN_STRIDES, cfg.mask_resolution)
        dist = torch.abs(gt_boxes[:, None, :, :] - sampled["gt_boxes"][:, :, None, :]).sum(-1)  # (B, S, G)
        gt_idx = box_ops.first_argmin(dist)  # (B, S)
        fg = sampled["is_fg"].to(torch.float32)
        out = {}
        if gt_masks is not None:
            m = 2 * cfg.mask_resolution
            logits = self.mask_head(pooled, self.dtype).reshape(bb, rr, m, m, cfg.roi.num_classes)
            g = gt_masks.shape[1]
            # the GT mask crops (mask_head crop_and_resize), taps gathered from each ROI's own GT bitmask
            map_idx = torch.arange(bb, device=rois.device)[:, None] * g + gt_idx
            crops = roi_align.roi_align_maps(gt_masks.reshape(bb * g, *gt_masks.shape[2:], 1), map_idx.reshape(-1),
                                             rois.reshape(-1, 4), m, 1.0, 2).reshape(bb, rr, m, m)
            out["loss_mask"] = mask_loss(logits, crops > 0.5, sampled["gt_classes"], fg).mean()
        if gt_keypoints is not None:
            logits = self.keypoint_head(pooled, self.dtype)
            side = logits.shape[1]
            logits = logits.reshape(bb, rr, side, side, cfg.num_keypoints)
            kps = torch.gather(gt_keypoints.to(torch.float32), 1,
                               gt_idx[..., None, None].expand(-1, -1, *gt_keypoints.shape[2:]))  # (B, S, K, 3)
            idx, valid = keypoint_targets(kps, rois, side)
            out["loss_keypoint"] = keypoint_loss(logits, idx, valid, fg).mean()
        return out

    def forward(self, images: Tensor, precomputed_feats: dict[str, Tensor] | None = None) -> dict[str, Tensor]:
        cfg = self.config
        h, w = images.shape[1], images.shape[2]
        pyramid = self.pyramid(images, precomputed_feats)
        shapes = {lvl: (p.shape[2], p.shape[3]) for lvl, p in pyramid.items()}
        proposals, _, prop_valid = find_top_proposals(
            self.rpn_head(pyramid), self.anchors(shapes, images.device), (h, w), cfg.rpn
        )
        nhwc = {lvl: p.permute(0, 2, 3, 1) for lvl, p in pyramid.items()}
        scores, deltas = self.roi_heads(nhwc, proposals, FPN_STRIDES)
        dets = fast_rcnn_inference(scores, deltas, proposals, prop_valid, (h, w), cfg.roi)
        if cfg.with_mask or cfg.with_keypoints:  # the heads on every detection (mask_head / keypoint_head inference)
            bb, dd = dets["boxes"].shape[:2]
            pooled = pool_gather(nhwc, dets["boxes"], cfg.roi, FPN_STRIDES, cfg.mask_resolution)
            if cfg.with_mask:
                out = self.mask_head(pooled, self.dtype)
                dets["mask_logits"] = out.reshape(bb, dd, *out.shape[1:])
            if cfg.with_keypoints:
                out = self.keypoint_head(pooled, self.dtype)
                dets["keypoint_logits"] = out.reshape(bb, dd, *out.shape[1:])
        return dets


def keypoint_targets(kps: Tensor, rois: Tensor, side: int) -> tuple[Tensor, Tensor]:
    """Each ROI's keypoints (..., K, 3) in its (..., 4) box -> the flat
    heatmap cell gy * side + gx (int64) and whether it counts (float32): a
    visible keypoint inside the box. The cell is the box-relative position
    times side / box size, truncated toward zero and clipped to the
    heatmap (JAX rcnn.py:261-271)."""
    x0, y0, x1, y1 = (rois[..., i, None] for i in range(4))
    side_t = torch.tensor(float(side), device=rois.device)  # side / w, not w's reciprocal times side
    sw = side_t / torch.clamp(x1 - x0, min=1e-6)
    sh = side_t / torch.clamp(y1 - y0, min=1e-6)
    kx, ky, vis = kps.unbind(-1)

    def cell(v):  # astype(int32), then clip: a clamp to [-1, side] first keeps the cast in range
        return torch.clamp(torch.clamp(v, -1.0, float(side)).to(torch.int64), 0, side - 1)

    gx, gy = cell((kx - x0) * sw), cell((ky - y0) * sh)
    inside = (kx >= x0) & (kx < x1) & (ky >= y0) & (ky < y1) & (vis > 0)
    return gy * side + gx, inside.to(torch.float32)


def select_best_box(dets: dict[str, Tensor], image_hw: tuple[int, int]) -> Tensor:
    """Per image: the highest-scoring valid box, or the full frame when
    nothing was detected (export_object_detection_bounding_boxes.py:313-322).

    Returns (B, 4) XYXY.
    """
    h, w = image_hw
    scores = torch.where(dets["valid"], dets["scores"], torch.full_like(dets["scores"], -torch.inf))
    best = torch.argmax(scores, dim=1)  # first maximum, as jnp.argmax
    boxes = torch.gather(dets["boxes"], 1, best[:, None, None].expand(-1, 1, 4))[:, 0]
    fallback = torch.tensor([0.0, 0.0, float(w), float(h)], device=boxes.device)
    return torch.where(dets["valid"].any(dim=1)[:, None], boxes, fallback)
