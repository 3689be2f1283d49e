"""PointSup: point-supervised instance segmentation (port of ``projects/pointsup.py``).

Semantic contract of the reference ``projects/PointSup/point_sup/``:

* annotated points come in image coordinates with {0, 1} labels; they are
  box-normalized against the proposal, and points outside the box get the
  label -1 (ignored);
* ``MaskRCNNConvUpsamplePointSupHead``: the standard mask head's logits,
  point-sampled at the annotated points, trained by PointRend's point BCE
  instead of the dense mask loss;
* ``ImplicitPointRendPointSupHead``: implicit PointRend whose training
  points are the annotation's, not uniform draws.

Fixed shapes: R instances x P annotated points, padded and masked.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .point_rend import point_sample, roi_mask_point_loss


def point_coords_wrt_box(boxes: Tensor, coords: Tensor) -> Tensor:
    """Image-coordinate points (R, P, 2) -> box-normalized [0,1]² against
    the boxes (R, 4) xyxy."""
    wh = boxes[:, None, 2:4] - boxes[:, None, 0:2]
    return (coords - boxes[:, None, 0:2]) / wh


def point_labels_from_annotation(boxes: Tensor, point_coords: Tensor, point_labels: Tensor) -> tuple[Tensor, Tensor]:
    """-> (box-normalized coords (R, P, 2), float32 labels with the
    out-of-box points set to -1)."""
    wrt = point_coords_wrt_box(boxes, point_coords)
    outside = (wrt[..., 0] < 0) | (wrt[..., 0] > 1) | (wrt[..., 1] < 0) | (wrt[..., 1] > 1)
    labels = torch.where(outside, torch.full_like(wrt[..., 0], -1.0), point_labels.float())
    return wrt, labels


def mask_rcnn_point_sup_loss(mask_logits: Tensor, boxes: Tensor, point_coords: Tensor, point_labels: Tensor,
                             gt_classes: Tensor | None, valid: Tensor | None = None) -> Tensor:
    """The dense mask loss's point-supervised replacement: the mask head's
    logits (R, M, M, C), which live in box space, sampled at the annotated
    points and scored by the PointRend point BCE."""
    coords, labels = point_labels_from_annotation(boxes, point_coords, point_labels)
    return roi_mask_point_loss(point_sample(mask_logits, coords), labels, gt_classes, valid)


def implicit_point_sup_train_points(boxes: Tensor, point_coords: Tensor,
                                    point_labels: Tensor) -> tuple[Tensor, Tensor]:
    """Training points of ``ImplicitPointRendMaskHead`` under point
    supervision: the annotation's, box-normalized, with their labels."""
    return point_labels_from_annotation(boxes, point_coords, point_labels)
