"""Clip server: letterbox -> detector -> best box -> landmark pipeline -> pose.

The body of the JAX package's fused serving graph (``bench.py``,
``build_full_path``) as a callable. A clip of uint8 frames from one
stream is served at once: the detector sees every ``det_every``-th frame,
letterboxed to ``det_size``; its best box is held for the next
``det_every`` frames, which is far inside the crop margin at spacecraft
inter-frame motion.

Two forms: the bf16 models as they are, or the int8 form that ``bench.py``
serves by default (:func:`build_int8_server`): the detector on int8
backbone features and the int8 HRNet on raw crops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .models.backbone_int8 import backbone_int8_apply, quantize_backbone
from .models.hrnet_int8 import HRNetInt8, quantize_hrnet, tree_map
from .models.rcnn import select_best_box
from .ops.int8_conv import with_kmajor
from .pipeline import PipelineConfig, make_pose_pipeline, normalize_crops

Tensor = torch.Tensor

# bench.py's serving point: GN PnP with 5 steps, 768-px crop window.
SERVING_PIPELINE = PipelineConfig(solver="gn", refine_iters=5, crop_window=(768, 768))


def letterbox(frames: Tensor, size: int) -> tuple[Tensor, float]:
    """(B, H, W, 3) frames -> (B, size, size, 3) float32 and the scale.

    Bilinear resize to fit ``size`` (antialiased when shrinking, as
    ``jax.image.resize`` is), zero padding at the bottom and right.
    """
    _, h, w, _ = frames.shape
    scale = size / max(h, w)
    lb_h, lb_w = int(round(h * scale)), int(round(w * scale))
    x = frames.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(lb_h, lb_w), mode="bilinear", align_corners=False, antialias=True)
    x = F.pad(x, (0, size - lb_w, 0, size - lb_h))
    return x.permute(0, 2, 3, 1), scale


class PoseServer:
    """Serve clips: uint8 (N, H, W, 3) frames on the models' device in,
    poses out.

    Returns {R (N, 3, 3), t (N, 3), quat (N, 4), keypoints (N, J, 2),
    confidence (N, J), boxes (N, 4) xywh held per frame, det_boxes
    (ceil(N / det_every), 4) XYXY per keyframe}, all in frame pixels.
    """

    def __init__(self, detector, landmark_model, landmarks_3d, K, dist,
                 config: PipelineConfig = SERVING_PIPELINE, det_every: int = 16,
                 det_size: int = 768, backbone_q: dict | None = None):
        self.detector = detector
        self.det_every, self.det_size = det_every, det_size
        # int8 backbone tree, on the detector's device, with its kernel weights packed once
        self.backbone_q = with_kmajor(backbone_q) if backbone_q is not None else None
        self.landmarks = landmark_model
        self.pose = make_pose_pipeline(landmark_model, landmarks_3d, K, dist, config)

    def detections(self, lb: Tensor) -> dict[str, Tensor]:
        """The detector on letterboxed keyframes, through the int8 backbone
        when the server has one."""
        feats = None
        if self.backbone_q is not None:
            feats = backbone_int8_apply(self.detector.config.backbone, self.backbone_q, self.detector.normalize(lb))
        return self.detector(lb, precomputed_feats=feats)

    @torch.inference_mode()
    def detect(self, frames: Tensor) -> tuple[Tensor, Tensor]:
        """Best XYXY box per keyframe (frame pixels) and the xywh box held
        for every frame."""
        lb, scale = letterbox(frames[:: self.det_every], self.det_size)
        best = select_best_box(self.detections(lb), (self.det_size, self.det_size)) / scale
        xywh = torch.stack(
            [best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], dim=1
        )
        return best, xywh.repeat_interleave(self.det_every, dim=0)[: frames.shape[0]]

    @torch.inference_mode()
    def __call__(self, frames: Tensor) -> dict[str, Tensor]:
        det_boxes, boxes = self.detect(frames)
        out = self.pose(frames, boxes)
        return {
            "R": out["R"], "t": out["t"], "quat": out["quat"],
            "keypoints": out["keypoints"], "confidence": out["confidence"],
            "boxes": boxes, "det_boxes": det_boxes,
        }


def build_int8_server(detector, landmark_model, landmarks_3d, K, dist,
                      config: PipelineConfig = SERVING_PIPELINE, det_every: int = 16, det_size: int = 768,
                      backbone_q: dict | None = None, hrnet_q: dict | None = None,
                      **hrnet_flags) -> PoseServer:
    """The int8 serving form of ``bench.py`` (``det_kind="r101_1obj_int8"``).

    The detector runs on its backbone quantized by ``quantize_backbone``; the
    landmark model is ``HRNetInt8(fold_normalize=True)`` over the quantized
    ``landmark_model``, fed the raw crops. Either tree may be given
    (e.g. ``convert.quantized_to_torch`` of the JAX package's); the missing
    ones are calibrated as ``bench.py`` does, on uniform random pixels drawn
    from seed 0: two letterboxed images for the backbone, then four crops
    for the HRNet. ``hrnet_flags`` go to ``HRNetInt8`` (``fused_blocks``,
    ``layer1_strips``, ``fused_min_width``, ``fuse_exchange``).
    """
    device = next(detector.parameters()).device
    rng = np.random.default_rng(0)
    calib_det = rng.integers(0, 255, (2, det_size, det_size, 3))
    calib_crops = rng.integers(0, 255, (4, config.image_size[1], config.image_size[0], 3))
    if backbone_q is None:
        images = torch.from_numpy(calib_det.astype(np.float32)).to(device)
        backbone_q = quantize_backbone(detector.config.backbone, detector, detector.normalize(images))
    if hrnet_q is None:
        crops = torch.from_numpy(calib_crops.astype(np.float32)).to(device)
        hrnet_q = quantize_hrnet(landmark_model, normalize_crops(crops))
    landmarks = HRNetInt8(landmark_model.config, hrnet_q, fold_normalize=True, device=device, **hrnet_flags)
    return PoseServer(detector, landmarks, landmarks_3d, K, dist, config, det_every=det_every,
                      det_size=det_size, backbone_q=tree_map(lambda t: t.to(device), backbone_q))
