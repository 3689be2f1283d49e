"""The landmark stage's example table: COCO json + frames -> indexable examples.

A copy of ``LandmarkExamples`` of the JAX package's
``data/landmark_dataset.py`` (the evaluation subset: no augmentation, no
batch iterator, no device cache). The frames come from files, read with
OpenCV, or from a mapping of frames already in memory, which is how a
machine without OpenCV (the card's) hands them over.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from . import coco_io


class LandmarkExamples:
    """COCO json -> one example per annotation, in the json's order.

    ``image_dir``: the frames are the files named by the json there, read as
    BGR with ``cv2.imread`` (cv2 is imported only then). ``frames``: a
    mapping of file name -> (H, W, 3) uint8 BGR frame (a numpy array or a
    tensor on any device), used in place of the files. A frame comes out
    as uint8, RGB unless ``color_rgb`` is False; the JAX copy casts it to
    float32, which holds the integers exactly.
    """

    def __init__(self, coco_json: str, image_dir: str | None = None, frames: Mapping | None = None):
        if (image_dir is None) == (frames is None):
            raise ValueError("LandmarkExamples takes the frames from image_dir or from frames, one of them")
        self.records = coco_io.coco_to_examples(coco_io.load_coco(coco_json))
        self.image_dir, self.frames = image_dir, frames
        self.num_joints = self.records[0]["joints"].shape[0]

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, i: int, color_rgb: bool = True):
        name = self.records[i]["file_name"]
        if self.frames is not None:
            img = self.frames[name]
            if not color_rgb:
                return img
            return img.flip(-1) if hasattr(img, "flip") else np.ascontiguousarray(img[..., ::-1])
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("reading frames from image files needs OpenCV (cv2), which is not installed; "
                               "hand the frames over in memory (frames=)") from e
        path = os.path.join(self.image_dir, name)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if color_rgb else img

    def example(self, i: int, color_rgb: bool = True) -> dict:
        rec = self.records[i]
        return {
            "image": self.load_image(i, color_rgb),
            "bbox": rec["bbox"].astype(np.float32),
            "joints": rec["joints"].astype(np.float32),
            "joints_vis": rec["joints_vis"].astype(np.float32),
            "image_id": rec["image_id"],
        }
