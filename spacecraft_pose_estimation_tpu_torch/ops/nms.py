"""Greedy NMS as a keep-mask in input order, many problems per call.

Port of ``spacecraft_pose_estimation_tpu/ops/nms.py`` (``nms_mask``,
``batched_nms_mask``) with the sorted core done by kernel K4
(``csrc/nms_mask_sorted.cu``, the counterpart of ``ops/pallas_nms.py``).
Leading dims are independent problems: the RPN hands over every
(image, level) at once, the box head and RetinaNet every image (RetinaNet's
five levels of candidates in one problem: 4,441 boxes at 800^2).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .boxes import pairwise_iou

Tensor = torch.Tensor

MAX_BOXES = 8192
# above this many boxes a problem's overlap mask leaves shared memory for a
# global workspace (nms_mask_sorted.cu)
MAX_SMEM_BOXES = 1024

KERNEL = _cuda.Kernel(
    "nms_mask_sorted", "nms_mask_sorted.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p],
)


def nms_mask_sorted_plain(boxes: Tensor, valid: Tensor, iou_threshold: float) -> Tensor:
    """Plain PyTorch K4: (P, N, 4) score-sorted boxes, (P, N) bool -> (P, N) keep.

    In the kernel's form: a kept box removes only the boxes after it
    (j > i). That gives the greedy keep-mask because the IoU is symmetric
    bit for bit: a kept box never overlaps an earlier kept one above the
    threshold, so removing earlier boxes changes no keep bit.
    """
    n = boxes.shape[-2]
    over = torch.triu(pairwise_iou(boxes, boxes) > iou_threshold, diagonal=1)
    removed = torch.zeros_like(valid)
    for i in range(n):
        keep_i = valid[:, i] & ~removed[:, i]
        removed |= over[:, i] & keep_i[:, None]
    return valid & ~removed


def nms_mask_sorted(boxes: Tensor, valid: Tensor, iou_threshold: float) -> Tensor:
    """Keep-mask (P, N) bool over (P, N, 4) score-sorted boxes.

    CPU tensors take the plain version; CUDA tensors launch K4, which
    writes the bool mask itself. Up to 1024 boxes a problem the kernel
    keeps its overlap mask in shared memory; up to 8192 in a workspace of
    N x ceil(N / 64) words a problem, allocated here (2.49 MB at 4,441).
    """
    n = boxes.shape[-2]
    if n > MAX_BOXES:  # on every device, so that the CPU takes what the card takes
        raise ValueError(f"nms_mask_sorted takes at most {MAX_BOXES} boxes per problem, got {n}")
    if boxes.device.type == "cpu":
        return nms_mask_sorted_plain(boxes, valid, iou_threshold)
    _cuda.check_cuda_tensor("boxes", boxes, torch.float32, 3)
    _cuda.check_cuda_tensor("valid", valid, torch.bool, 2)
    p, n, four = boxes.shape
    if four != 4 or tuple(valid.shape) != (p, n):
        raise ValueError(f"boxes {tuple(boxes.shape)} and valid {tuple(valid.shape)} disagree")
    keep = torch.empty((p, n), dtype=torch.bool, device=boxes.device)
    workspace = None
    if n > MAX_SMEM_BOXES:
        workspace = torch.empty((p, n, (n + 63) // 64), dtype=torch.int64, device=boxes.device)
    KERNEL.launch(
        _cuda.ptr(boxes), _cuda.ptr(valid), _cuda.ptr(keep),
        ctypes.c_void_p(None) if workspace is None else _cuda.ptr(workspace), p, n, float(iou_threshold),
    )
    return keep


def nms_mask(
    boxes: Tensor, scores: Tensor, iou_threshold: float, valid: Tensor | None = None
) -> Tensor:
    """Exact greedy NMS keep-mask (..., N) in input order.

    Boxes (..., N, 4) are visited in descending score order (stable: ties
    keep input order, as ``jnp.argsort(descending=True)``); a box is kept
    iff no higher-scoring kept box overlaps it above ``iou_threshold``.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    b = boxes.reshape(-1, n, 4).to(torch.float32)
    v = valid.reshape(-1, n)
    s = torch.where(v, scores.reshape(-1, n), torch.full_like(scores.reshape(-1, n), -torch.inf))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    b_sorted = torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    v_sorted = torch.gather(v, 1, order).contiguous()
    keep_sorted = nms_mask_sorted(b_sorted, v_sorted, iou_threshold)
    keep = torch.zeros_like(v).scatter_(1, order, keep_sorted)
    return keep.reshape(*lead, n)


def batched_nms_mask(
    boxes: Tensor, scores: Tensor, class_ids: Tensor, iou_threshold: float,
    valid: Tensor | None = None,
) -> Tensor:
    """Class-aware NMS by the coordinate-offset trick (detectron2 batched_nms).

    Boxes of different classes are moved apart by twice the problem's
    largest coordinate so they never overlap.
    """
    n = boxes.shape[-2]
    max_coord = torch.abs(boxes).reshape(*boxes.shape[:-2], n * 4).amax(-1) + 1.0
    offsets = class_ids.to(boxes.dtype) * (2.0 * max_coord[..., None])
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold, valid)
