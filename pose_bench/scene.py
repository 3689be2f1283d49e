"""The frames a cell serves and the detector's seeded calibration.

Frames: uint8 1920x1200 RGB made on the card from the seed: dark sensor
noise, and in each a bright textured target (the spacecraft) whose box
drifts a few pixels a frame through each clip of the pool, as a tracked
target does.

Weights are random from the seed, and a random detector ranks its boxes by
near-ties that any rounding reorders. So, as a trained detector does, the
seeded one is made to find the target: on calibration frames, each frozen
BN is set to its input's statistics (``quant.calibrate_norms``, the
residual branches damped), then the
RPN's objectness and the box classifier are set by a closed-form linear
probe on the reference's own features (the difference of the mean feature
on and off the target). The classifier reads the mean background proposal
at log-odds 0, so that every keyframe has boxes far above the score
threshold (0.05, log-odds -2.94) and no answer turns on whether one box
clears it. A trained heatmap head reads well above 0 at its
peak, while a random one's maps straddle 0, where the decode's rule for a
map with no positive value (served at its origin) turns a rounding
difference into a move across the whole map; so the head's bias puts each
landmark's mean, on crops of the calibration frames' targets,
``HEATMAP_LIFT`` standard deviations above 0. The rest stays random.
"""

from __future__ import annotations

import torch

from .reference import detector as ref_det
from .reference import pose as ref_pose

BACKGROUND_MAX = 40  # dark space, sensor noise
TARGET_MIN = 60  # the target's texture, up to 255
PROBE_GAIN = 6.0  # log-odds distance between the mean target and the mean background feature
BACKGROUND_ODDS = 0.0  # the box classifier's log-odds at the mean background proposal: far above the score threshold
HEATMAP_LIFT = 3.0  # each landmark's heatmap mean, in its standard deviations, above 0


def target_boxes(n_clips: int, clip: int, hw, gen, device) -> torch.Tensor:
    """(n_clips * clip, 4) XYXY frame-pixel boxes: per clip a size of
    180-560 px (aspect 0.6-1.6), a start inside the frame and a drift of up
    to 3 px a frame."""
    h, w = hw
    u = torch.rand(n_clips, 6, generator=gen, device=device)
    side = 180 + 380 * u[:, 0]
    aspect = 0.6 + u[:, 1]
    bw, bh = side * aspect.sqrt(), side / aspect.sqrt()
    drift = (u[:, 2:4] - 0.5) * 6.0
    k = torch.arange(clip, device=device, dtype=torch.float32)
    x0 = (w - bw - 3 * clip)[:, None].clamp(min=1) * u[:, 4:5] + 1.5 * clip + drift[:, 0:1] * k
    y0 = (h - bh - 3 * clip)[:, None].clamp(min=1) * u[:, 5:6] + 1.5 * clip + drift[:, 1:2] * k
    x0, y0 = x0.clamp(0, w - 2), y0.clamp(0, h - 2)
    x1 = torch.minimum(x0 + bw[:, None], torch.tensor(float(w), device=device))
    y1 = torch.minimum(y0 + bh[:, None], torch.tensor(float(h), device=device))
    return torch.stack([x0, y0, x1, y1], -1).reshape(-1, 4)


def render(boxes: torch.Tensor, hw, gen, device, chunk: int = 16) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames: background noise, the boxes' insides textured."""
    h, w = hw
    frames = torch.randint(0, BACKGROUND_MAX + 1, (boxes.shape[0], h, w, 3), dtype=torch.uint8, device=device,
                           generator=gen)
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    for lo in range(0, boxes.shape[0], chunk):
        b = boxes[lo:lo + chunk, :, None, None]
        inside = (xs >= b[:, 0]) & (xs < b[:, 2]) & (ys >= b[:, 1]) & (ys < b[:, 3])
        tex = torch.randint(TARGET_MIN, 256, frames[lo:lo + chunk].shape, dtype=torch.uint8, device=device,
                            generator=gen)
        frames[lo:lo + chunk] = torch.where(inside[..., None], tex, frames[lo:lo + chunk])
    return frames


def _probe(pos: torch.Tensor, neg: torch.Tensor, floor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) of a linear score that reads ``floor`` at the mean
    negative feature and ``floor`` + GAIN at the mean positive one."""
    mp, mn = pos.mean(0), neg.mean(0)
    d = mp - mn
    scale = PROBE_GAIN / torch.clamp(d.dot(d), min=1e-12)
    return d * scale, floor - d.dot(mn) * scale


def _iou_to_target(boxes, target):
    """IoU of (B, N, 4) boxes with each image's (B, 4) target."""
    return ref_det.pairwise_iou(boxes, target[:, None])[..., 0]


@torch.no_grad()
def calibrate_detector(det, lb, targets) -> None:
    """Set the RPN objectness and the box classifier of the reference
    detector ``det`` by linear probes on letterboxed calibration images
    ``lb`` (B, S, S, 3) whose targets are ``targets`` (B, 4, letterbox px)."""
    cfg = det.cfg
    feats = det.backbone(det.normalize(lb).permute(0, 3, 1, 2))
    pyramid = det.fpn(feats)
    hw = (lb.shape[1], lb.shape[2])
    pos, neg = [], []
    for i, lvl in enumerate(sorted(pyramid)):
        t = torch.relu(det.rpn_head.conv(pyramid[lvl]))  # (B, C, H, W)
        b, c, h, w = t.shape
        anchors = ref_det.anchors((h, w), ref_det.STRIDES[lvl], cfg["anchor_sizes"][i], cfg["anchor_aspect_ratios"],
                                  lb.device)
        a = anchors.shape[0] // (h * w)
        iou = _iou_to_target(anchors[None].expand(b, -1, -1), targets).reshape(b, h * w, a).amax(-1)
        flat = t.permute(0, 2, 3, 1).reshape(b, h * w, c)
        pos.append(flat[iou >= torch.clamp(iou.amax(1, keepdim=True), max=0.5)])
        neg.append(flat[iou < 0.1])
    wt, bias = _probe(torch.cat(pos), torch.cat(neg), -PROBE_GAIN / 2)
    det.rpn_head.objectness.weight.copy_(wt[None, :, None, None].expand_as(det.rpn_head.objectness.weight))
    det.rpn_head.objectness.bias.fill_(float(bias))

    nhwc = [pyramid[lvl].permute(0, 2, 3, 1).contiguous() for lvl in cfg["roi"]["in_levels"]]
    props, valid = ref_det.proposals(det, ref_det.rpn_candidates(det, pyramid, hw))
    iou = _iou_to_target(props, targets)
    r = props.shape[1]
    pooled = ref_det.roi_align(nhwc, props.reshape(-1, 4), torch.arange(props.shape[0], device=lb.device)
                               .repeat_interleave(r), cfg["roi"])
    h = det.roi_heads.box_head(pooled).reshape(props.shape[0], r, -1)
    best = torch.where(valid, iou, torch.zeros_like(iou)).amax(1, keepdim=True)
    wt, bias = _probe(h[valid & (iou >= torch.clamp(best, max=0.6))], h[valid & (iou < 0.2)], BACKGROUND_ODDS)
    cls = det.roi_heads.predictor.cls_score
    cls.weight.zero_()
    cls.bias.zero_()
    cls.weight[0].copy_(wt)
    cls.bias[0] = bias


@torch.no_grad()
def calibrate_heatmaps(hrnet, frames, targets, pipeline: dict) -> None:
    """Set the heatmap head's bias of the reference HRNet ``hrnet`` so that
    each landmark's map, over crops of ``frames`` (B, H, W, 3) uint8 at their
    ``targets`` (B, 4, XYXY frame px), has mean ``HEATMAP_LIFT`` standard
    deviations."""
    xywh = torch.cat([targets[:, :2], targets[:, 2:] - targets[:, :2]], 1)
    size = tuple(pipeline["image_size"])
    center, scale = ref_pose.center_scale(xywh, pipeline["bbox_padding"], size, pipeline.get("crop_window"))
    maps = hrnet(ref_pose.normalize(ref_pose.crop(frames, center, scale, size)))
    flat = maps.reshape(-1, maps.shape[-1])
    hrnet.final_layer.bias.add_(HEATMAP_LIFT * flat.std(0) - flat.mean(0))
