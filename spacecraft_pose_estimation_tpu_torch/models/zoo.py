"""Named detector presets (port of ``models/zoo.py``: ``object_detection_utils.py`` config_1..config_20).

Each name maps to an architecture, an ``RCNNConfig`` (``config_1``-
``config_4``) or a ``RetinaNetConfig`` (``config_20``), the input size, the
flip and the SOLVER block the reference trains that config with.
``config_4`` pins the input size to the frame height.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .rcnn import FASTER_RCNN_X101_SPACECRAFT
from .resnet_backbone import RESNET101_FPN
from .retinanet import RetinaNetConfig
from .roi_heads import ROIHeadsConfig


@dataclasses.dataclass(frozen=True)
class SolverPreset:
    """The SOLVER/TEST block of a reference registry entry: the exact
    schedule the reference trains that config with."""

    max_iter: int
    base_lr: float
    ims_per_batch: int
    warmup_iters: int
    steps: tuple[int, ...]
    gamma: float = 0.1
    checkpoint_period: int = 500
    eval_period: int = 5000


@dataclasses.dataclass(frozen=True)
class DetectorPreset:
    arch: str  # 'faster_rcnn' | 'retinanet'
    config: Any  # an RCNNConfig or a RetinaNetConfig
    input_size: int | None = None  # None -> pin to image height (config_4)
    flip: bool = False
    solver: SolverPreset | None = None
    notes: str = ""


DETECTOR_PRESETS: dict[str, DetectorPreset] = {
    # Faster R-CNN X101-FPN 3x (the paper's main detector)
    "config_1": DetectorPreset(
        arch="faster_rcnn",
        config=dataclasses.replace(
            FASTER_RCNN_X101_SPACECRAFT,
            roi=ROIHeadsConfig(num_classes=1, detections_per_image=100, batch_size_per_image=128),
        ),
        input_size=800,
        flip=True,
        solver=SolverPreset(max_iter=5000, base_lr=0.001, ims_per_batch=4, warmup_iters=500,
                            steps=(500, 800, 1000, 1100, 1200), gamma=0.05, eval_period=1000),
        notes="X101-FPN, default sizes/flips, ROI batch 128",
    ),
    # Faster R-CNN R101-FPN 3x
    "config_2": DetectorPreset(
        arch="faster_rcnn",
        config=dataclasses.replace(
            FASTER_RCNN_X101_SPACECRAFT, backbone=RESNET101_FPN,
            roi=ROIHeadsConfig(num_classes=1, detections_per_image=100),
        ),
        input_size=800,
        flip=True,
        solver=SolverPreset(max_iter=10000, base_lr=0.001, ims_per_batch=8, warmup_iters=200,
                            steps=(2000, 6000, 8000), eval_period=2000),
        notes="R101-FPN",
    ),
    "config_3": DetectorPreset(
        arch="faster_rcnn",
        config=dataclasses.replace(
            FASTER_RCNN_X101_SPACECRAFT,
            roi=ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, detections_per_image=100),
        ),
        input_size=1200,
        flip=False,
        solver=SolverPreset(max_iter=15000, base_lr=0.0001, ims_per_batch=7, warmup_iters=500,
                            steps=(10000,), eval_period=5000),
        notes="X101-FPN class-agnostic, 1200px",
    ),
    # the pipeline's flagship: sizes pinned to frame height, no flips, class-agnostic, <= 2 detections
    "config_4": DetectorPreset(
        arch="faster_rcnn",
        config=FASTER_RCNN_X101_SPACECRAFT,
        input_size=None,
        flip=False,
        solver=SolverPreset(max_iter=10000, base_lr=0.0001, ims_per_batch=10, warmup_iters=500,
                            steps=(8000,), eval_period=5000),
        notes="X101-FPN pinned-size class-agnostic (the eval preset)",
    ),
    # RetinaNet R101 3x
    "config_20": DetectorPreset(
        arch="retinanet",
        config=RetinaNetConfig(backbone=RESNET101_FPN, num_classes=1),
        input_size=800,
        # config_20's INPUT block is commented out upstream: detectron2's default horizontal flip
        flip=True,
        solver=SolverPreset(max_iter=20000, base_lr=0.0001, ims_per_batch=10, warmup_iters=500,
                            steps=(6000, 10000, 15000), eval_period=10000),
        notes="RetinaNet R101",
    ),
}


def get_detector_preset(name: str, image_height: int | None = None) -> DetectorPreset:
    p = DETECTOR_PRESETS[name]
    if p.input_size is None:
        if image_height is None:
            raise ValueError(f"{name} pins input size to the frame height; pass image_height")
        p = dataclasses.replace(p, input_size=image_height)
    return p


def build_detector_config(preset: DetectorPreset):
    """The preset's ``RCNNConfig`` or ``RetinaNetConfig``."""
    return preset.config
