"""The file contract of the evaluation entry and its stages: COCO json, pred.mat, poses.

A copy of the subset of the JAX package's ``data/coco_io.py`` that
``evaluate.py`` and the stage tools (``tools/``) use:

* predicted-box export (``real_test.json``): one annotation per image,
  the best box (the whole frame when nothing is detected), keypoints all
  2.0 dummies; read back as per-annotation example records;
* ``pred.mat`` keypoints {'preds': (B, J, 3) [x, y, maxval]};
* ``opencv_poses.json`` [{image_name, T (3x1), rotation_matrix (3x3)}] and
  the landmarks' projection for its overlays;
* the 3-D landmark CSV, read by its ``x,y,z`` header with the ``csv``
  module (the JAX package reads it with pandas).

NumPy and SciPy on the host: this is IO, not compute.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Sequence

import numpy as np
import scipy.io

LICENSES = [
    {
        "url": "https://creativecommons.org/licenses/by-nc-sa/4.0/",
        "id": 1,
        "name": "Attribution-NonCommercial-ShareAlike License",
    }
]


def category_dict(num_keypoints: int) -> dict:
    return {
        "supercategory": "spacecraft",
        "id": 1,
        "name": "spacecraft",
        "keypoints": [f"p{i + 1}" for i in range(num_keypoints)],
        "skeleton": [],
    }


def image_record(file_name: str, width: int, height: int, image_id: int,
                 date_captured: str = "2022") -> dict:
    return {
        "license": 1,
        "file_name": file_name,
        "width": width,
        "height": height,
        "date_captured": date_captured,
        "id": int(image_id),
    }


def keypoint_annotation(
    keypoints_xyvis: np.ndarray,
    bbox_xywh: Sequence[float],
    image_id: int,
    ann_id: int,
) -> dict:
    bbox = [float(b) for b in bbox_xywh]
    return {
        "segmentation": {},
        "num_keypoints": int(keypoints_xyvis.shape[0]),
        "area": bbox[2] * bbox[3],
        "iscrowd": 0,
        "keypoints": np.asarray(keypoints_xyvis, np.float64).flatten().tolist(),
        "image_id": int(image_id),
        "bbox": bbox,
        "category_id": 1,
        "id": int(ann_id),
    }


def build_coco_dict(images: list[dict], annotations: list[dict], num_keypoints: int) -> dict:
    return {
        "info": {},
        "licenses": LICENSES,
        "categories": [category_dict(num_keypoints)],
        "images": images,
        "annotations": annotations,
    }


def frame_image_ids(file_names: Sequence[str]) -> list[int]:
    """imgNNN.* -> NNN; any other name -> its index in the list."""
    ids = []
    for i, f in enumerate(file_names):
        stem = os.path.basename(f).split(".")[0].replace("img", "")
        ids.append(int(stem) if stem.isdigit() else i)
    return ids


def detections_to_coco(
    file_names: Sequence[str],
    boxes_xyxy: np.ndarray,  # (B, 4) best box per image (x0, y0, x1, y1)
    num_keypoints: int,
    width: int,
    height: int,
    image_ids: Sequence[int] | None = None,
) -> dict:
    """Predicted boxes -> the real_test.json contract: one annotation per
    image, keypoints all dummy 2.0."""
    if image_ids is None:
        image_ids = frame_image_ids(file_names)
    images, anns = [], []
    for fname, box, image_id in zip(file_names, boxes_xyxy, image_ids):
        x, y = float(box[0]), float(box[1])
        w, h = float(box[2] - box[0]), float(box[3] - box[1])
        images.append(image_record(fname, width, height, image_id))
        anns.append(keypoint_annotation(np.full((num_keypoints, 3), 2.0), [x, y, w, h], image_id, image_id))
    return build_coco_dict(images, anns, num_keypoints)


def fallback_full_frame_box(width: int, height: int) -> np.ndarray:
    """Zero-detection graceful degradation: the whole frame as the XYXY box."""
    return np.array([0.0, 0.0, float(width), float(height)])


def project_landmarks(landmarks: np.ndarray, R: np.ndarray, t: np.ndarray, K: np.ndarray,
                      dist: np.ndarray | None = None) -> np.ndarray:
    """K @ [R|t] projection with optional Brown distortion -> (N, 2) pixels."""
    p_cam = landmarks @ np.asarray(R).T + np.asarray(t)
    xy = p_cam[:, :2] / p_cam[:, 2:3]
    if dist is not None and np.any(dist):
        k1, k2, p1, p2, k3 = np.asarray(dist, np.float64)[:5]
        x, y = xy[:, 0], xy[:, 1]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = np.stack([xd, yd], axis=1)
    u = K[0, 0] * xy[:, 0] + K[0, 2]
    v = K[1, 1] * xy[:, 1] + K[1, 2]
    return np.stack([u, v], axis=1)


def save_coco(coco: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(coco, indent=2))


def load_coco(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def coco_to_examples(coco: dict) -> list[dict]:
    """COCO dict -> flat per-annotation records: joints (J, 2), joint
    visibility weights (COCO vis - 1), bbox xywh, file name, image size."""
    image_by_id = {im["id"]: im for im in coco["images"]}
    out = []
    for ann in coco["annotations"]:
        im = image_by_id[ann["image_id"]]
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        out.append({
            "file_name": im["file_name"],
            "image_id": ann["image_id"],
            "width": im["width"],
            "height": im["height"],
            "bbox": np.asarray(ann["bbox"], np.float64),
            "joints": kp[:, :2],
            "joints_vis": kp[:, 2] - 1.0,  # detectron vis -> 0/1 weight
        })
    return out


def save_pred_mat(preds: np.ndarray, path: str) -> None:
    """(B, J, 3) [x, y, maxval] -> pred.mat {'preds': ...}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    scipy.io.savemat(path, mdict={"preds": np.asarray(preds)})


def load_pred_mat(path: str) -> np.ndarray:
    return np.array(scipy.io.loadmat(path)["preds"])


def save_opencv_poses(
    image_names: Sequence[str], rotations: np.ndarray, translations: np.ndarray, path: str
) -> None:
    """[{image_name, T (3x1), rotation_matrix (3x3)}]: the solver's output contract."""
    poses = [
        {
            "image_name": name,
            "T": np.asarray(t, np.float64).reshape(3, 1).tolist(),
            "rotation_matrix": np.asarray(R, np.float64).tolist(),
        }
        for name, R, t in zip(image_names, rotations, translations)
    ]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(poses, indent=2))


def load_landmarks_csv(path: str) -> np.ndarray:
    """3-D landmark CSV with an x,y,z header -> (N, 3) float64, the columns
    found by name."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = [header.index(name) for name in ("x", "y", "z")]
    return np.array([[float(r[c]) for c in cols] for r in body], np.float64).reshape(-1, 3)
