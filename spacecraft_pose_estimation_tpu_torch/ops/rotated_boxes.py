"""Rotated boxes: IoU by polygon clipping, and rotated NMS (port of ``ops/rotated_boxes.py``).

detectron2's ``box_iou_rotated`` / ``nms_rotated`` kernels, as the JAX
package computes them (XLA, not Pallas): boxes are (cx, cy, w, h,
angle_deg), the angle counter-clockwise. One rectangle is clipped by the
other's four half-planes (Sutherland-Hodgman) in a fixed 8-vertex polygon
with a count of valid vertices, every pair at once. The pairs are taken in
row chunks of at most ``PAIRS_PER_CHUNK`` so that no intermediate passes
~100 MB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

_MAX_V = 8
PAIRS_PER_CHUNK = 1 << 19


def box_to_corners(box: Tensor) -> Tensor:
    """(..., 5) rotated boxes -> (..., 4, 2) corners, counter-clockwise."""
    cx, cy, w, h, a = box.unbind(-1)
    t = a * torch.tensor(math.pi / 180, dtype=torch.float32, device=box.device)  # jnp.deg2rad, in float32
    # cos and sin of that float32 angle rounded from float64: float32 cos / sin differ in the last bit
    # between the CPU and the card, and the clipping of coinciding edges turns that ulp into 1e-4 of IoU
    c = torch.cos(t.double()).to(box.dtype)[..., None]
    s = torch.sin(t.double()).to(box.dtype)[..., None]
    dx = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=box.dtype, device=box.device) * w[..., None]
    dy = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=box.dtype, device=box.device) * h[..., None]
    x = cx[..., None] + c * dx - s * dy
    y = cy[..., None] + s * dx + c * dy
    return torch.stack([x, y], dim=-1)


def _rolled(poly: Tensor, count: Tensor) -> Tensor:
    """Each vertex's successor among the first ``count`` (wrapping at the
    count, not at 8): poly[(i + 1) % max(count, 1)]."""
    idx = (torch.arange(_MAX_V, device=poly.device) + 1) % torch.clamp(count, min=1)[:, None]
    return torch.gather(poly, 1, idx[..., None].expand(-1, -1, 2))


def _clip_halfplane(poly: Tensor, count: Tensor, p0: Tensor, p1: Tensor) -> tuple[Tensor, Tensor]:
    """Clip (P, 8, 2) polygons with ``count`` (P,) valid vertices against
    the half-planes left of the edges p0 -> p1 (P, 2)."""
    d = (p1 - p0)[:, None, :]

    def side(pt):
        return d[..., 0] * (pt[..., 1] - p0[:, None, 1]) - d[..., 1] * (pt[..., 0] - p0[:, None, 0])

    nxt = _rolled(poly, count)
    s_cur, s_nxt = side(poly), side(nxt)
    valid = torch.arange(_MAX_V, device=poly.device) < count[:, None]
    inside_cur, inside_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    tpar = torch.where(torch.abs(denom) > 1e-12, s_cur / torch.where(denom == 0, torch.ones_like(denom), denom),
                       torch.zeros_like(denom))
    inter = poly + tpar[..., None] * (nxt - poly)
    # each edge emits up to 2 points: its start if inside, the crossing if the edge crosses
    keep = torch.stack([valid & inside_cur, valid & (inside_cur != inside_nxt)], dim=2).reshape(-1, 2 * _MAX_V)
    cand = torch.stack([poly, inter], dim=2).reshape(-1, 2 * _MAX_V, 2)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :_MAX_V]  # kept first, in order
    return torch.gather(cand, 1, order[..., None].expand(-1, -1, 2)), torch.clamp(keep.sum(1), max=_MAX_V)


def _polygon_area(poly: Tensor, count: Tensor) -> Tensor:
    nxt = _rolled(poly, count)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(torch.arange(_MAX_V, device=poly.device) < count[:, None], cross, torch.zeros_like(cross))
    total = cross[:, 0]
    for i in range(1, _MAX_V):  # one order of the sum on every device
        total = total + cross[:, i]
    return 0.5 * torch.abs(total)


def rotated_intersection_area(box_a: Tensor, box_b: Tensor) -> Tensor:
    """Intersection areas of (P, 5) box pairs."""
    p = box_a.shape[0]
    poly = torch.zeros(p, _MAX_V, 2, dtype=box_a.dtype, device=box_a.device)
    poly[:, :4] = box_to_corners(box_a)
    count = torch.full((p,), 4, dtype=torch.int64, device=box_a.device)
    corners_b = box_to_corners(box_b)
    for i in range(4):
        poly, count = _clip_halfplane(poly, count, corners_b[:, i], corners_b[:, (i + 1) % 4])
    return torch.where(count >= 3, _polygon_area(poly, count), torch.zeros(p, dtype=poly.dtype, device=poly.device))


def pairwise_iou_rotated(a: Tensor, b: Tensor) -> Tensor:
    """(Na, 5) x (Nb, 5) -> (Na, Nb) rotated IoU, on the boxes' device; 0
    where the union is not positive. Not symmetric bit for bit: the pair
    (i, j) clips a[i] by b[j]."""
    na, nb = a.shape[0], b.shape[0]
    out = torch.empty(na, nb, dtype=a.dtype, device=a.device)
    rows = max(1, PAIRS_PER_CHUNK // max(nb, 1))
    area_b = b[:, 2] * b[:, 3]
    for r0 in range(0, na, rows):
        ra = a[r0:r0 + rows]
        m = ra.shape[0]
        inter = rotated_intersection_area(ra[:, None].expand(m, nb, 5).reshape(-1, 5),
                                          b[None].expand(m, nb, 5).reshape(-1, 5)).reshape(m, nb)
        union = (ra[:, 2] * ra[:, 3])[:, None] + area_b[None, :] - inter
        out[r0:r0 + m] = torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))
    return out


def nms_rotated_mask(boxes: Tensor, scores: Tensor, iou_threshold: float, valid: Tensor | None = None) -> Tensor:
    """Greedy rotated NMS keep-mask (N,) in input order (``nms_rotated``).

    Boxes go in descending score order (stable: ties to the lower index),
    invalid ones last; the (N, N) overlap matrix of the sorted boxes is
    computed on their device, then walked greedily on one host copy (one
    transfer, no device launch a box). As in the JAX package's loop, a kept
    box's row suppresses every box it overlaps above the threshold, earlier
    ones included (the IoU is not symmetric bit for bit).
    """
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -torch.inf)), descending=True,
                       stable=True).indices
    over = (pairwise_iou_rotated(boxes[order], boxes[order]) > iou_threshold).cpu().numpy()
    v = valid[order].cpu().numpy()
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if v[i] and not suppressed[i]:
            row = over[i].copy()
            row[i] = False
            suppressed |= row
    keep_sorted = torch.from_numpy(v & ~suppressed).to(boxes.device)
    return torch.zeros(n, dtype=torch.bool, device=boxes.device).scatter(0, order, keep_sorted)
