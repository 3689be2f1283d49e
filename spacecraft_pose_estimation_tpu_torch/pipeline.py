"""The detect-free half of the serving path: crop -> heatmaps -> decode -> PnP.

Port of ``spacecraft_pose_estimation_tpu/pipeline.py``:

    frames (B, H, W, 3 uint8), boxes (B, 4 xywh)
      -> center/scale          (events.py:94-113 semantics)
      -> window clamp + crop   (kernel K1, ops/warp.py)
      -> ImageNet normalize
      -> heatmap model         (models/hrnet.py)
      -> sub-pixel decode      (ops/heatmap.py)
      -> PnP solve             (ops/pnp.py, solver "gn")

The returned functions run under ``torch.inference_mode`` on the model's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .ops import geometry, heatmap, pnp, warp

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The JAX package's ``PipelineConfig``, field for field.

    ``warp_dtype`` is kept for the JAX configs' sake: the port's crop
    (kernel K1) always samples in float32, the JAX package's exact mode
    (``"float32"``), whatever it says. This is a deviation kept on purpose:
    at the served ``"bfloat16"`` the JAX crop is within 1 grey of it and
    the heatmaps on the two correlate >= 0.995, as
    ``tests/test_torch_warp_dtype.py`` pins.
    ``crop_window_impl`` picks the coverage the crop scale is clamped to:
    ``"xla"`` the window less 2 px, ``"pallas"`` ``warp.window_coverage``.
    The solver is ``"gn"`` or ``"none"``; ``"ransac"`` is not ported yet.
    """

    image_size: tuple[int, int] = (512, 512)  # (width, height) model input
    bbox_padding: float = 1.5
    post_process: bool = True
    solver: str = "gn"
    warp_dtype: str = "bfloat16"
    ransac_hypotheses: int = 256
    reproj_threshold: float = 15.0
    refine_iters: int = 10
    min_keypoints: int = 15
    crop_window: tuple[int, int] | None = None
    crop_window_impl: str = "xla"


def normalize_crops(crops: Tensor) -> Tensor:
    """uint8/float [0, 255] crops -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=crops.device) * 255.0
    return (crops.to(torch.float32) - mean) / std


def boxes_to_center_scale(boxes: Tensor, padding: float = 1.5) -> tuple[Tensor, Tensor]:
    """(B, 4) xywh -> (B, 2) centers, (B, 2) scales."""
    return geometry.bbox_to_center_scale(boxes.to(torch.float32), padding=padding)


def _clamped_scales(scales: Tensor, config: PipelineConfig) -> Tensor:
    if config.crop_window is None:
        return scales
    if config.crop_window_impl == "xla":
        cov = (config.crop_window[0] - 2, config.crop_window[1] - 2)
    elif config.crop_window_impl == "pallas":
        cov = None
    else:
        raise ValueError(f"crop_window_impl must be 'xla' or 'pallas', got {config.crop_window_impl!r}")
    return warp.clamp_scales_to_window(scales, config.image_size, config.crop_window, coverage=cov)


def make_landmark_stage(model, config: PipelineConfig = PipelineConfig()) -> Callable:
    """Returns fn(frames, boxes) -> dict(keypoints, confidence, centers, scales, heatmaps).

    Keypoints come back in source-frame pixels (the reference's pred.mat).
    Once the scale is clamped to the window, both JAX windowed crops equal
    the full-frame crop, so one crop serves every ``crop_window`` setting.
    """

    @torch.inference_mode()
    def run(frames: Tensor, boxes: Tensor) -> dict[str, Tensor]:
        centers, scales = boxes_to_center_scale(boxes, config.bbox_padding)
        scales = _clamped_scales(scales, config)
        crops = warp.crop_and_resize(frames, centers, scales, config.image_size)
        # a model that folds the normalisation into its stem takes raw pixels
        inputs = crops if getattr(model, "consumes_raw_pixels", False) else normalize_crops(crops)
        heatmaps = model(inputs)
        preds, maxvals = heatmap.decode_heatmaps(
            heatmaps, centers, scales, post_process=config.post_process
        )
        return {
            "keypoints": preds,  # (B, J, 2) source-frame pixels
            "confidence": maxvals,  # (B, J)
            "centers": centers,
            "scales": scales,
            "heatmaps": heatmaps,
        }

    return run


def make_pose_pipeline(
    model, landmarks_3d, K, dist, config: PipelineConfig = PipelineConfig()
) -> Callable:
    """Returns fn(frames, boxes) -> the landmark outputs plus R, t, quat.

    ``landmarks_3d`` (J, 3), ``K`` (3, 3) and ``dist`` (5,) are moved to
    the model's device (its ``device`` attribute, else its parameters') as
    float32.
    """
    if config.solver not in ("gn", "none"):
        raise NotImplementedError(f"solver {config.solver!r} is not ported yet ('gn', 'none')")
    landmark_stage = make_landmark_stage(model, config)
    # a quantized model holds no parameters and names its device itself
    device = getattr(model, "device", None) or next(model.parameters()).device
    lm3d, K, dist = (torch.as_tensor(a, dtype=torch.float32).to(device) for a in (landmarks_3d, K, dist))

    @torch.inference_mode()
    def run(frames: Tensor, boxes: Tensor) -> dict[str, Tensor]:
        out = landmark_stage(frames, boxes)
        if config.solver == "none":
            return out
        w = pnp.adaptive_confidence_mask(out["confidence"], min_count=config.min_keypoints)
        R, t = pnp.solve_pnp(
            lm3d, out["keypoints"], K, dist, w.to(torch.float32), refine_iters=config.refine_iters
        )
        out.update({"R": R, "t": t, "quat": geometry.rotmat_to_quat(R)})
        return out

    return run
