"""Clip server: letterbox -> detector -> best box -> landmark pipeline -> pose.

The body of the JAX package's fused serving graph (``bench.py``,
``build_full_path``) as a callable. A clip of uint8 frames from one
stream is served at once: the detector sees every ``det_every``-th frame,
letterboxed to ``det_size``; its best box is held for the next
``det_every`` frames, which is far inside the crop margin at spacecraft
inter-frame motion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .models.rcnn import select_best_box
from .pipeline import PipelineConfig, make_pose_pipeline

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
                 det_size: int = 768):
        self.detector = detector
        self.det_every, self.det_size = det_every, det_size
        self.pose = make_pose_pipeline(landmark_model, landmarks_3d, K, dist, config)

    @torch.inference_mode()
    def detect(self, frames: Tensor) -> tuple[Tensor, Tensor]:
        """Best XYXY box per keyframe (frame pixels) and the xywh box held
        for every frame."""
        lb, scale = letterbox(frames[:: self.det_every], self.det_size)
        best = select_best_box(self.detector(lb), (self.det_size, self.det_size)) / scale
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
