"""Debug visualization (port of ``utils/vis.py``: HRNet's ``lib/utils/vis.py:20-141`` and
detectron2 Visualizer essentials): batch image grids with GT/pred joints,
per-joint colormapped heatmap grids, box overlays, track-stable overlays.

Drawn on the host with cv2, which each function imports itself. Images,
joints, heatmaps and boxes may be numpy arrays or tensors on any device;
tensors are moved to the host first. Heatmaps are the port's layout,
channels last: (B, Hh, Wh, J), as the models return them.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _grid(images: list[np.ndarray], cols: int | None = None) -> np.ndarray:
    n = len(images)
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    h, w = images[0].shape[:2]
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = im
    return canvas


def save_batch_image_with_joints(
    images,  # (B, H, W, 3) float 0..255 RGB
    joints,  # (B, J, 2)
    joints_vis,  # (B, J)
    path: str,
) -> None:
    """Grid of frames with joint dots (save_batch_image_with_joints)."""
    import cv2

    tiles = []
    for img, jts, vis in zip(_host(images), _host(joints), _host(joints_vis)):
        im = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR).copy()
        for (x, y), v in zip(jts, vis):
            if v > 0:
                cv2.circle(im, (int(x), int(y)), 2, (0, 255, 0), 2)
        tiles.append(im)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, _grid(tiles))


def save_batch_heatmaps(
    images,  # (B, H, W, 3)
    heatmaps,  # (B, Hh, Wh, J)
    path: str,
) -> None:
    """Per-sample row: resized input + each joint's colormapped heatmap
    blended over it (save_batch_heatmaps)."""
    import cv2

    heatmaps = _host(heatmaps)
    b, hh, wh, j = heatmaps.shape
    rows = []
    for img, hm in zip(_host(images), heatmaps):
        small = cv2.resize(np.clip(img, 0, 255).astype(np.uint8), (wh, hh))
        small = cv2.cvtColor(small, cv2.COLOR_RGB2BGR)
        row = [small]
        for k in range(j):
            m = hm[:, :, k]
            m = np.clip(m * 255, 0, 255).astype(np.uint8)
            colored = cv2.applyColorMap(m, cv2.COLORMAP_JET)
            row.append((colored * 0.7 + small * 0.3).astype(np.uint8))
        rows.append(np.concatenate(row, axis=1))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, np.concatenate(rows, axis=0))


def save_debug_images(
    config_debug,
    images,
    target,
    pred_heatmaps,
    joints_gt,
    joints_vis,
    prefix: str,
) -> None:
    """DEBUG block dispatch (lib/utils/vis.py:119-141); the predicted joints
    are ``ops.heatmap.get_max_preds`` of ``pred_heatmaps`` on their device."""
    from ..ops.heatmap import get_max_preds

    if getattr(config_debug, "save_batch_images_gt", False):
        save_batch_image_with_joints(images, joints_gt, joints_vis, f"{prefix}_gt.jpg")
    if getattr(config_debug, "save_batch_images_pred", False):
        hm = pred_heatmaps if isinstance(pred_heatmaps, torch.Tensor) else torch.as_tensor(np.asarray(pred_heatmaps))
        preds, _ = get_max_preds(hm)
        stride = images.shape[1] / hm.shape[1]
        save_batch_image_with_joints(images, _host(preds) * stride, joints_vis, f"{prefix}_pred.jpg")
    if getattr(config_debug, "save_heatmaps_gt", False):
        save_batch_heatmaps(images, target, f"{prefix}_hm_gt.jpg")
    if getattr(config_debug, "save_heatmaps_pred", False):
        save_batch_heatmaps(images, pred_heatmaps, f"{prefix}_hm_pred.jpg")


def draw_detections(
    image: np.ndarray,  # (H, W, 3) BGR uint8
    boxes,
    scores,
    color=(0, 255, 0),
) -> np.ndarray:
    import cv2

    out = _host(image).copy()
    for b, s in zip(_host(boxes), _host(scores)):
        cv2.rectangle(out, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), color, 2)
        cv2.putText(out, f"{s:.2f}", (int(b[0]), max(int(b[1]) - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 1)
    return out


class VideoVisualizer:
    """Track-stable detection overlay across a frame sequence — the
    d2 ``utils/video_visualizer.py`` role (stable per-instance colors
    frame to frame) on top of ``models/extra_layers.IouTracker``, whose IoU
    runs on ``device`` (CUDA unless the caller names another, e.g. "cpu").

    Usage: call ``draw_frame(image, boxes, scores)`` per frame in
    order; each physical object keeps one color for its whole track.
    """

    _PALETTE = [
        (0, 255, 0), (255, 128, 0), (0, 128, 255), (255, 0, 255),
        (0, 255, 255), (255, 255, 0), (128, 0, 255), (0, 0, 255),
    ]

    def __init__(self, iou_threshold: float = 0.5, max_missed: int = 5, device=None):
        from ..models.extra_layers import IouTracker

        self.tracker = IouTracker(iou_threshold, max_missed, device=device)

    def color_for(self, track_id: int):
        return self._PALETTE[track_id % len(self._PALETTE)]

    def draw_frame(self, image, boxes, scores) -> tuple[np.ndarray, list[int]]:
        import cv2

        boxes, scores = _host(boxes), _host(scores)
        ids = self.tracker.update(boxes, scores)
        out = _host(image).copy()
        for b, s, tid in zip(boxes.reshape(-1, 4), scores, ids):
            color = self.color_for(tid)
            cv2.rectangle(out, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])),
                          color, 2)
            cv2.putText(out, f"#{tid} {s:.2f}",
                        (int(b[0]), max(int(b[1]) - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 1)
        return out, ids
