"""The pipeline's file contract: COCO json, pred.mat, poses, the frame split.

A copy of the JAX package's ``data/coco_io.py``:

* ground-truth conversion (``poses_to_coco``): the 3-D landmarks projected
  through K[R|t] (and Brown distortion), the box their min/max grown by 10%
  *of the width* on both axes, visibility 2 strictly inside the frame
  else 1; the SPEED+ flavour's 1900-px visibility test and its
  all-visible quirk are options;
* predicted-box export (``real_test.json``): one annotation per image,
  the best box (the whole frame when nothing is detected), keypoints all
  2.0 dummies; read back as per-annotation example records;
* ``pred.mat`` keypoints {'preds': (B, J, 3) [x, y, maxval]};
* ``opencv_poses.json`` [{image_name, T (3x1), rotation_matrix (3x3)}] and
  the landmarks' projection for its overlays;
* the random train/validation/test split of frames (``split_files``);
* the 3-D landmark CSV, read by its ``x,y,z`` header with pandas, as the
  JAX package reads it.

NumPy and SciPy on the host: this is IO, not compute.
"""

from __future__ import annotations

import json
import os
import random
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


def visible_keypoints(points2d: np.ndarray, width: float, height: float) -> np.ndarray:
    """(N, 3) [x, y, vis]: vis=2 strictly inside the image, else 1."""
    inside = (
        (points2d[:, 0] > 0)
        & (points2d[:, 0] < width)
        & (points2d[:, 1] > 0)
        & (points2d[:, 1] < height)
    )
    vis = np.where(inside, 2.0, 1.0)
    return np.column_stack([points2d, vis])


def landmarks_bbox(points2d: np.ndarray) -> list[float]:
    """Keypoint min/max box grown by 10% of its *width* on both axes (the
    reference takes y's margin from the width too)."""
    min_xy = points2d.min(axis=0)
    max_xy = points2d.max(axis=0)
    w, h = max_xy - min_xy
    tol = w * 0.1
    return [float(min_xy[0] - tol), float(min_xy[1] - tol), float(w + 2 * tol), float(h + 2 * tol)]


def poses_to_coco(
    file_names: Sequence[str],
    rotations: np.ndarray,  # (B, 3, 3) world->camera
    translations: np.ndarray,  # (B, 3)
    landmarks: np.ndarray,  # (N, 3)
    K: np.ndarray,
    width: int,
    height: int,
    image_ids: Sequence[int] | None = None,
    dist: np.ndarray | None = None,
    visibility_width: float | None = None,
    shuffle_seed: int | None = None,
    force_visible: bool = False,
) -> dict:
    """Ground-truth poses -> COCO keypoints dict, one annotation an image
    whose id is the image's.

    ``image_ids`` default to each file's numeric stem. ``visibility_width``
    replaces the width in the visibility test (the SPEED+ converter's 1900
    px); ``force_visible`` marks every keypoint 2, in the frame or not (what
    the SPEED+ converter does). ``shuffle_seed`` shuffles the images, then
    the annotations, with one ``random.Random(shuffle_seed)``.
    """
    if image_ids is None:
        image_ids = [int(os.path.basename(f).split(".")[0]) for f in file_names]
    vis_w = visibility_width if visibility_width is not None else width
    images, anns = [], []
    for i, (fname, image_id) in enumerate(zip(file_names, image_ids)):
        pts2d = project_landmarks(landmarks, rotations[i], translations[i], K, dist)
        images.append(image_record(fname, width, height, image_id))
        kps = visible_keypoints(pts2d, vis_w, height)
        if force_visible:
            kps[:, 2] = 2.0
        anns.append(keypoint_annotation(kps, landmarks_bbox(pts2d), image_id, ann_id=image_id))
    if shuffle_seed is not None:
        rng = random.Random(shuffle_seed)
        rng.shuffle(images)
        rng.shuffle(anns)
    return build_coco_dict(images, anns, landmarks.shape[0])


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


def load_opencv_poses(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def split_files(
    files: Sequence[str],
    fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
    seed: int | None = None,
) -> dict[str, list[str]]:
    """Random train/validation/test split: the files shuffled by
    ``random.Random(seed)``, the first ``int(fractions[0] * n)`` to train,
    the next ``int(fractions[1] * n)`` to validation, the rest to test."""
    files = list(files)
    rng = random.Random(seed)
    rng.shuffle(files)
    n = len(files)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    return {
        "train": files[:n_train],
        "validation": files[n_train:n_train + n_val],
        "test": files[n_train + n_val:],
    }


def load_landmarks_csv(path: str) -> np.ndarray:
    """3-D landmark CSV with an x,y,z header -> (N, 3) float64, the columns
    found by name, read by pandas as the JAX package reads it."""
    import pandas as pd

    return pd.read_csv(path)[["x", "y", "z"]].values.astype(np.float64)
