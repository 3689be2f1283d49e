"""GeneralizedRCNN inference: backbone -> FPN -> RPN -> ROI heads.

Port of the inference path of ``models/rcnn.py`` with its R101 presets and
``select_best_box``. Images arrive pre-sized (the serving letterbox), and
detections leave as padded (B, D) arrays with a ``valid`` mask.

Inside the model, tensors are NCHW views of NHWC memory (the
``channels_last`` format), so the pyramid hands its levels to kernel K2 as
NHWC without a copy.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from .anchors import fpn_anchors
from .fpn import FPN, FPN_STRIDES
from .layers import init_params
from .resnet_backbone import RESNET101_FPN, RESNET_TINY, ResNetBackbone, ResNetConfig
from .roi_heads import ROIHeadsConfig, StandardROIHeads, fast_rcnn_inference
from .rpn import RPNConfig, RPNHead, find_top_proposals

Tensor = torch.Tensor

# Caffe2 zoo pixel stats (detectron2 configs: BGR mean, std 1).
PIXEL_MEAN = (103.530, 116.280, 123.675)
PIXEL_STD = (1.0, 1.0, 1.0)


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


# config_2 semantics (R101-FPN) with the spacecraft ROI heads: one class,
# class-agnostic boxes, two detections per image.
FASTER_RCNN_R101_SPACECRAFT = RCNNConfig(
    backbone=RESNET101_FPN,
    roi=ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, detections_per_image=2),
)
# Single-object serving point: 256/64 proposals per level / image.
FASTER_RCNN_R101_SERVING_1OBJ = dataclasses.replace(
    FASTER_RCNN_R101_SPACECRAFT,
    rpn=RPNConfig(pre_nms_topk_test=256, post_nms_topk_test=64),
)
RCNN_TINY = RCNNConfig(
    backbone=RESNET_TINY,
    fpn_channels=16,
    rpn=RPNConfig(pre_nms_topk_test=64, post_nms_topk_test=32),
    roi=ROIHeadsConfig(
        num_classes=1, cls_agnostic_bbox_reg=True, fc_dim=32, detections_per_image=2,
    ),
)


class GeneralizedRCNN(nn.Module):
    """Faster R-CNN inference over (B, H, W, 3) raw 0-255 images.

    ``dtype`` is the compute dtype (bfloat16 for serving); parameters
    stay float32. Returns {boxes (B, D, 4) XYXY, scores (B, D), classes
    (B, D), valid (B, D)}.
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
        return fast_rcnn_inference(scores, deltas, proposals, prop_valid, (h, w), cfg.roi)


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
