"""A clip's model FLOPs, counted by ``FlopCounterMode`` over the plain
reference on meta tensors: the detector (trunk, FPN, RPN head, and the box
head on each keyframe's post-NMS proposals) on the keyframes, HRNet on
every crop. An int8 operation counts as one FLOP."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.nets import Detector, HRNet


def clip_flops(cfg: dict, clip: int, det_every: int) -> float:
    d, roi = cfg["detector"], cfg["detector"]["roi"]
    keyframes = math.ceil(clip / det_every)
    size, (iw, ih) = cfg["det_size"], cfg["pipeline"]["image_size"]
    p = roi["pooler_resolution"]
    with torch.device("meta"):
        det, hrnet = Detector(d), HRNet(cfg["landmarks"])
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            pyramid = det.fpn(det.backbone(torch.empty(keyframes, 3, size, size)))
            det.rpn_head(pyramid)
            det.roi_heads(torch.empty(keyframes * d["rpn"]["post_nms_topk_test"], p, p, d["fpn_channels"]))
            hrnet(torch.empty(clip, ih, iw, 3))
    return float(counter.get_total_flops())
