"""Camera intrinsics and loaders for the reference's two formats.

A copy of the JAX package's numpy-only ``data/camera.py``:

* SPEED+ ``camera.json``: focal lengths in metres and the pixel pitch,
  ``cameraMatrix``, ``distCoeffs``;
* the pipeline's ``calibration.json``:
  {"intrinsics": {"camera_matrix": 3x3, "distortion_coefficients": [5]}}.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraModel:
    K: np.ndarray  # (3, 3) intrinsics
    dist: np.ndarray  # (5,) OpenCV Brown coefficients
    width: int
    height: int
    pixel_pitch: float | None = None  # metres/pixel, when known (SPEED+)

    @classmethod
    def from_speedplus_json(cls, path: str) -> "CameraModel":
        with open(path) as f:
            p = json.load(f)
        return cls(
            K=np.asarray(p["cameraMatrix"], np.float64),
            dist=np.asarray(p["distCoeffs"], np.float64),
            width=int(p["Nu"]),
            height=int(p["Nv"]),
            pixel_pitch=float(p["ppx"]),
        )

    @classmethod
    def from_calibration_json(cls, path: str, width: int = 0, height: int = 0) -> "CameraModel":
        with open(path) as f:
            p = json.load(f)
        intr = p["intrinsics"]
        return cls(
            K=np.asarray(intr["camera_matrix"], np.float64),
            dist=np.asarray(intr["distortion_coefficients"], np.float64).reshape(-1)[:5],
            width=width,
            height=height,
        )

    @classmethod
    def pinhole(cls, fx, fy, cx, cy, width, height) -> "CameraModel":
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        return cls(K=K, dist=np.zeros(5), width=width, height=height)
