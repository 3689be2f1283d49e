"""The detector's data: COCO -> fixed-shape batches (port of ``data/detection_dataset.py``).

detectron2's train loader and dataset mapper with the fork's geometric
augmentations (``detection_utils.py:616-651``), as the JAX package runs
them: an optional horizontal flip, a rotation by U(0, 45) degrees that
grows the canvas to hold the whole image, a letterbox to one static size
and a translation by U(-100, 100) px on each axis. GT boxes are padded to
``max_gt`` a image with a validity mask.

The draws are the JAX package's, number for number: ``random.Random`` for
the shuffle and ``np.random.default_rng((seed, epoch, i))`` for the flip,
the angle and the shift, in its order; the boxes follow in float64 numpy
as there. The JAX package warps the images with OpenCV on the host; here
they are tensor ops on the frames' device (``ops.warp.affine_warp``, cv2's
``warpAffine`` semantics, and ``serving.letterbox_linear``, cv2's
``resize``), so the library needs no OpenCV. cv2 rounds its source
coordinates to 1/32 px and ``affine_warp`` does not, so the images differ
by a few grey levels where they are not flat.
"""

from __future__ import annotations

import math
import os
import random
from typing import Iterator, Mapping

import numpy as np
import torch

from ..ops.warp import affine_warp
from ..serving import letterbox_linear
from . import coco_io
from .landmark_dataset import read_bgr
from .loader import parallel_batches

Tensor = torch.Tensor


class DetectionExamples:
    """COCO json -> one record per image with all its boxes (XYXY) and
    0-based classes, in the json's order.

    ``image_dir``: the frames are the files named by the json there, read as
    BGR with ``cv2.imread`` (cv2 is imported only then). ``frames``: a
    mapping of file name -> (H, W, 3) uint8 BGR frame (a numpy array or a
    tensor on any device), used in place of the files.
    """

    def __init__(self, coco_json: str, image_dir: str | None = None, frames: Mapping | None = None):
        if (image_dir is None) == (frames is None):
            raise ValueError("DetectionExamples takes the frames from image_dir or from frames, one of them")
        coco = coco_io.load_coco(coco_json)
        anns_by_image: dict[int, list] = {}
        for ann in coco["annotations"]:
            anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.records = []
        for im in coco["images"]:
            anns = anns_by_image.get(im["id"], [])
            boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                              for a in anns], np.float32).reshape(-1, 4)
            classes = np.array([a["category_id"] - 1 for a in anns], np.int32)
            self.records.append({"file_name": im["file_name"], "image_id": im["id"], "boxes": boxes,
                                 "classes": classes})
        self.image_dir, self.frames = image_dir, frames

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, i: int):
        """Frame i as (H, W, 3) uint8 BGR: a tensor or a numpy array."""
        name = self.records[i]["file_name"]
        if self.frames is not None:
            return self.frames[name]
        return read_bgr(os.path.join(self.image_dir, name))


def rotation_matrix(h: int, w: int, angle: float) -> tuple[np.ndarray, int, int]:
    """cv2's ``getRotationMatrix2D`` about the centre (angle in degrees,
    counter-clockwise), its translation moved so the (nw, nh) canvas holds
    the whole rotated image (``expand``). Returns (M (2, 3) float64, nh, nw)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = w / 2, h / 2
    M = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])
    nw = int(np.rint(w * abs(alpha) + h * abs(beta)))
    nh = int(np.rint(w * abs(beta) + h * abs(alpha)))
    M[0, 2] += nw / 2 - w / 2
    M[1, 2] += nh / 2 - h / 2
    return M, nh, nw


def rotate_boxes(boxes: np.ndarray, M: np.ndarray, h: int, w: int) -> np.ndarray:
    """The axis-aligned hull of each box's corners under M, clipped to (h, w)."""
    if not len(boxes):
        return boxes
    corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]], boxes[:, [2, 3]]], axis=1)
    pts = np.concatenate([corners, np.ones((*corners.shape[:2], 1))], axis=-1) @ M.T
    out = np.concatenate([pts.min(axis=1), pts.max(axis=1)], axis=-1)
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    return out


def warp(img: Tensor, M: np.ndarray, out_hw: tuple[int, int]) -> Tensor:
    """cv2 ``warpAffine(img, M, (w, h))`` (bilinear, border 0) of one (H, W, 3)
    float32 image by the forward map M, through ``affine_warp``."""
    full = np.vstack([M, [0.0, 0.0, 1.0]])
    m_inv = torch.tensor(np.linalg.inv(full)[:2], dtype=torch.float32, device=img.device)
    return affine_warp(img[None], m_inv[None], (out_hw[1], out_hw[0]))[0]


def make_example(examples: DetectionExamples, i: int, epoch: int, image_hw: tuple[int, int], max_gt: int,
                 train: bool, augment: bool, flip: bool, seed: int, rotation_range: tuple[float, float],
                 translation_range: float, device) -> dict:
    """One example of epoch ``epoch``: the JAX ``make_example`` with its draws."""
    if image_hw[0] != image_hw[1]:
        raise ValueError(f"the letterbox is square; got {image_hw}")
    nprng = np.random.default_rng((seed, epoch, i))
    rec = examples.records[i]
    img = torch.as_tensor(examples.load_image(i))
    img = img.to(device=device if device is not None else img.device, dtype=torch.float32)
    boxes = rec["boxes"].copy()
    if train and augment:
        if flip and nprng.random() < 0.5:
            w0 = img.shape[1]
            img = img.flip(1)
            if len(boxes):
                boxes[:, [0, 2]] = w0 - boxes[:, [2, 0]]
        angle = nprng.uniform(*rotation_range)
        M, nh, nw = rotation_matrix(img.shape[0], img.shape[1], angle)
        img = warp(img, M, (nh, nw))
        boxes = rotate_boxes(boxes, M, nh, nw)
    lb, scale = letterbox_linear(img[None], image_hw[0])
    img = lb[0]
    boxes = boxes * scale
    if train and augment:
        tx, ty = nprng.uniform(-translation_range, translation_range, 2)
        h, w = img.shape[:2]
        img = warp(img, np.float32([[1, 0, tx], [0, 1, ty]]).astype(np.float64), (h, w))
        if len(boxes):
            boxes = boxes + np.array([tx, ty, tx, ty])
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_classes = np.zeros((max_gt,), np.int32)
    gt_valid = np.zeros((max_gt,), bool)
    if min(len(boxes), max_gt):
        wh_ok = ((boxes[:, 2] - boxes[:, 0]) > 1) & ((boxes[:, 3] - boxes[:, 1]) > 1)
        boxes, classes = boxes[wh_ok][:max_gt], rec["classes"][wh_ok][:max_gt]
        keep = len(boxes)
        gt_boxes[:keep] = boxes
        gt_classes[:keep] = classes
        gt_valid[:keep] = True
    return {"image": img, "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_valid": gt_valid,
            "image_id": rec["image_id"], "scale": scale}


def detection_batches(
    examples: DetectionExamples,
    batch_size: int,
    image_hw: tuple[int, int],
    max_gt: int = 16,
    train: bool = True,
    seed: int = 0,
    rotation_range: tuple[float, float] = (0.0, 45.0),
    translation_range: float = 100.0,
    augment: bool = True,
    flip: bool = False,
    device=None,
    start: int = 0,
    num_workers: int | None = None,
    prefetch: int = 4,
) -> Iterator[dict]:
    """Endless (train) or single-pass (eval) batches on ``device`` (default:
    each frame's own): ``image`` (B, H, W, 3) float32 BGR letterboxed,
    ``gt_boxes`` (B, max_gt, 4), ``gt_classes``, ``gt_valid``, and numpy
    ``image_id``, ``scale`` and ``count`` (the real examples of a padded
    eval tail). Training shuffles each epoch and drops the ragged tail.
    ``start`` skips that many batches (a resumed run takes the batch after
    its last one). Examples are made on a thread pool."""
    rng = random.Random(seed)
    n = len(examples)

    def index_gen():
        epoch, emitted = 0, 0
        while True:
            order = list(range(n))
            if train:
                rng.shuffle(order)
            for begin in range(0, n, batch_size):
                sel = order[begin:begin + batch_size]
                if len(sel) < batch_size:
                    if train:
                        break
                    sel = sel + [sel[-1]] * (batch_size - len(sel))
                count = min(batch_size, n - begin)
                if emitted >= start:
                    yield count, [(epoch, i) for i in sel]
                emitted += 1
            if not train:
                return
            epoch += 1

    def make(key):
        epoch, i = key
        return make_example(examples, i, epoch, image_hw, max_gt, train, augment, flip, seed, rotation_range,
                            translation_range, device)

    def collate(count, chunk):
        dev = chunk[0]["image"].device
        batch = {"image": torch.stack([c["image"] for c in chunk])}
        for k in ("gt_boxes", "gt_classes", "gt_valid"):
            batch[k] = torch.from_numpy(np.stack([c[k] for c in chunk])).to(dev)
        batch["image_id"] = np.array([c["image_id"] for c in chunk])
        batch["scale"] = np.array([c["scale"] for c in chunk])
        batch["count"] = count
        return batch

    yield from parallel_batches(index_gen(), make, collate, num_workers=num_workers, prefetch_batches=prefetch)
