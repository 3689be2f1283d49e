"""The plain reference of the served pose path, and its control.

Plain PyTorch, importing nothing of the served program. :class:`Reference`
holds the networks the benchmark made (float32 weights on the card) and
works out again what the program's set-up derives: for a stage the
configuration states in int8, the quantized trees from the same float
weights and calibration inputs (``quant.py``); for one stated in bfloat16,
the same network in float32. ``precision="control"`` computes every stage
one step below what the configuration states (int8 -> the scheme at 4
bits; bfloat16 -> float8 e4m3, the step below bfloat16 that Hopper's tensor
cores offer; float32 -> bfloat16): put in the program's place, it has to
fail the comparison (``check.py``).
"""

from __future__ import annotations

import contextlib

import torch

from . import detector as det_ops
from . import pose as pose_ops
from .nets import Detector, HRNet
from .quant import QuantHRNet, QuantTrunk, fp8_layers

INT_BITS = {"reference": 8, "control": 4}  # a stage stated in int8, in the reference and in its control


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions and matmuls without TF32, restored after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Reference:
    """The served path in plain PyTorch, for one configuration.

    ``det`` and ``hrnet`` are the benchmark's networks (``nets``), ``calib``
    the calibration inputs {"images": raw (B, S, S, 3) letterboxed,
    "crops": raw (B, h, w, 3)} the int8 scheme is calibrated on, ``lm3d``
    the (J, 3) landmark model, ``det_every`` the traffic's keyframe step.
    """

    def __init__(self, cfg: dict, det: Detector, hrnet: HRNet, calib: dict, lm3d, det_every: int,
                 precision: str = "reference"):
        self.cfg, self.det, self.hrnet, self.lm3d, self.det_every = cfg, det, hrnet, lm3d, det_every
        prec = cfg["precision"]
        control = precision == "control"
        self.solve_dtype = torch.bfloat16 if control else torch.float32
        bits = INT_BITS[precision]
        self.trunk = self.landmarks = None
        with torch.no_grad():
            if prec["trunk"] == "int8":
                self.trunk = QuantTrunk(det.backbone, det.normalize(calib["images"]), bits)
            if prec["landmarks"] == "int8":
                self.landmarks = QuantHRNet(hrnet, pose_ops.normalize(calib["crops"]),
                                            (pose_ops.IMAGENET_MEAN, pose_ops.IMAGENET_STD), bits)
        # the float networks the control runs in float8: those stated in bfloat16
        stated_bf16 = {"trunk": [det.backbone], "heads": [det.fpn, det.rpn_head, det.roi_heads], "landmarks": [hrnet]}
        self.fp8 = [n for k, nets in stated_bf16.items() if control and prec[k] == "bfloat16" for n in nets]

    def lowered(self):
        return fp8_layers(self.fp8) if self.fp8 else contextlib.nullcontext()

    # -- stages --------------------------------------------------------------

    def detect(self, frames, served_props=None) -> tuple[dict, float]:
        """Keyframes (K, H, W, 3) uint8 -> the detector readout (letterbox px) and the letterbox scale;
        ``served_props``: a served detector's proposals (K, R, 4, letterbox px) to score as well."""
        lb, scale = det_ops.letterbox(frames, self.cfg["det_size"])
        x = self.det.normalize(lb)
        with self.lowered():
            feats = self.trunk(x) if self.trunk is not None else self.det.backbone(x.permute(0, 3, 1, 2))
            return det_ops.keyframe_readout(self.det, lb, feats, served_props), scale

    def heatmaps(self, frames, boxes_xywh, block: int = 16) -> tuple:
        """(N, H, W, 3) uint8 frames and (N, 4) xywh boxes -> (N, h, w, J)
        heatmaps, centers, scales (blocks of ``block`` crops)."""
        pl = self.cfg["pipeline"]
        size = tuple(pl["image_size"])
        center, scale = pose_ops.center_scale(boxes_xywh, pl["bbox_padding"], size, pl.get("crop_window"))
        maps = []
        for lo in range(0, frames.shape[0], block):
            crops = pose_ops.crop(frames[lo:lo + block], center[lo:lo + block], scale[lo:lo + block], size)
            if self.landmarks is not None:
                maps.append(self.landmarks(crops))
            else:
                with self.lowered():
                    maps.append(self.hrnet(pose_ops.normalize(crops)))
        return torch.cat(maps), center, scale

    def solve(self, keypoints, confidence) -> tuple:
        cam, pl = self.cfg["camera"], self.cfg["pipeline"]
        dev = keypoints.device
        K = torch.tensor(cam["K"], device=dev)
        dist = torch.tensor(cam["dist"], device=dev)
        w = pose_ops.confidence_mask(confidence, min_count=pl["min_keypoints"]).to(torch.float32)
        return pose_ops.solve(self.lm3d.to(dev), keypoints, K, dist, w, pl["refine_iters"], self.solve_dtype)

    def __call__(self, frames) -> dict:
        """The whole path on a clip, in the served output's form (used as the control)."""
        every = self.det_every
        with torch.no_grad():
            readout, scale = self.detect(frames[::every])
            best = readout["best"] / scale
            xywh = torch.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], 1)
            boxes = xywh.repeat_interleave(every, dim=0)[: frames.shape[0]]
            maps, center, sc = self.heatmaps(frames, boxes)
            kps, conf = pose_ops.decode(maps, center, sc)
            R, t = self.solve(kps, conf)
        return {"R": R, "t": t, "keypoints": kps, "confidence": conf, "boxes": boxes, "det_boxes": best,
                "det_odds": readout["best_odds"], "det_props": readout["props"]}
