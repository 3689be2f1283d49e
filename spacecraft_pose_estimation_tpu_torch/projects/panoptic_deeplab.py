"""Panoptic-DeepLab (port of ``projects/panoptic_deeplab.py``).

Semantic contract of the reference
``projects/Panoptic-DeepLab/panoptic_deeplab/``, as the JAX module keeps it:

* semantic head: the DeepLabV3+ decoder, two head convs and a predictor,
  DeepLabCE with per-pixel weights;
* instance-embedding head: its own V3+ decoder, a centre branch (heatmap,
  MSE) and an offset branch (pixel -> centre vector in pixels, L1), each
  loss normalized by its weights' sum;
* post-processing: threshold and max-pool NMS to find centres, each pixel
  to its nearest centre, a majority vote of the semantic class per
  instance and the ``label_divisor`` panoptic ids;
* target generation (:class:`PanopticTargetGenerator`, host numpy, the
  port's own copy).

The post-processing is fixed-shape, as the JAX module's: ``top_k`` centre
rows with a validity mask, ties to the lowest index. It computes the same
function in cheaper forms where the result is identical: the distances
only to valid centres and in row chunks, the class histogram and the
panoptic paste by bincount and gathers instead of (K, H, W) one-hots.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import Conv, init_params
from .deeplab import DeepLabV3PlusHead, _sem_seg_losses
from .point_rend import init_prediction, top_k_indices, upsample_bilinear

# ---------------------------------------------------------------------------
# heads


class PanopticDeepLabSemSegHead(nn.Module):
    """V3+ decoder (``decoder``) + ``head0`` / ``head1`` (3x3 + ReLU) + a 1x1
    ``predictor``, upsampled by ``common_stride`` in float32; weighted
    DeepLabCE. ``forward(features, targets, weights, train)``: inference ->
    (logits (N, H, W, C), {}); train -> (None, {"loss_sem_seg"})."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], in_features: tuple[str, ...] = ("res2", "res5"),
                 in_strides: tuple[int, ...] = (4, 16), decoder_channels: tuple[int, ...] = (256, 256),
                 head_channels: int = 256, common_stride: int = 4, loss_type: str = "hard_pixel_mining",
                 ignore_value: int = -1, loss_weight: float = 1.0, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.common_stride, self.loss_type, self.ignore_value = common_stride, loss_type, ignore_value
        self.loss_weight = loss_weight
        self.decoder = DeepLabV3PlusHead(None, in_channels, in_features, in_strides,
                                         decoder_channels=decoder_channels, dtype=dtype, device="cpu")
        self.head0 = Conv(self.decoder.out_channels, decoder_channels[0], 3, 1, 1)
        self.head1 = Conv(decoder_channels[0], head_channels, 3, 1, 1)
        self.predictor = Conv(head_channels, num_classes, 1)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        init_prediction(self.predictor, generator)
        self.to(resolve_device(device))

    def forward(self, features: dict[str, Tensor], targets: Tensor | None = None, weights: Tensor | None = None,
                train: bool = False):
        y = F.relu(self.head1(F.relu(self.head0(self.decoder.decode(features)))))
        y = upsample_bilinear(self.predictor(y).permute(0, 2, 3, 1), self.common_stride)
        if train:
            return None, _sem_seg_losses(y, targets, self.loss_type, self.ignore_value, self.loss_weight, weights)
        return y, {}


class PanopticDeepLabInsEmbedHead(nn.Module):
    """Centre-heatmap + offset head on its own V3+ decoder (``decoder``):
    per branch ``<tag>_head0`` / ``<tag>_head1`` (3x3 + ReLU) and a 1x1
    ``<tag>_predictor``, tag ``center`` (1 channel) or ``offset`` (2, as
    (dy, dx)). Inference -> (center (N, H, W, 1), offset (N, H, W, 2) in
    pixels: upsampled by ``common_stride`` in float32, then multiplied by
    it, {}, {}); train -> (None, None, {"loss_center"}, {"loss_offset"})."""

    def __init__(self, in_channels: Sequence[int], in_features: tuple[str, ...] = ("res2", "res5"),
                 in_strides: tuple[int, ...] = (4, 16), decoder_channels: tuple[int, ...] = (128, 128),
                 head_channels: int = 32, common_stride: int = 4, center_loss_weight: float = 200.0,
                 offset_loss_weight: float = 0.01, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.common_stride = common_stride
        self.center_loss_weight, self.offset_loss_weight = center_loss_weight, offset_loss_weight
        self.decoder = DeepLabV3PlusHead(None, in_channels, in_features, in_strides,
                                         decoder_channels=decoder_channels, dtype=dtype, device="cpu")
        for tag, out in (("center", 1), ("offset", 2)):
            self.add_module(f"{tag}_head0", Conv(self.decoder.out_channels, decoder_channels[0], 3, 1, 1))
            self.add_module(f"{tag}_head1", Conv(decoder_channels[0], head_channels, 3, 1, 1))
            self.add_module(f"{tag}_predictor", Conv(head_channels, out, 1))
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        init_prediction(self.center_predictor, generator)
        init_prediction(self.offset_predictor, generator)
        self.to(resolve_device(device))

    def _branch(self, tag: str, y: Tensor) -> Tensor:
        h = F.relu(getattr(self, f"{tag}_head1")(F.relu(getattr(self, f"{tag}_head0")(y))))
        return upsample_bilinear(getattr(self, f"{tag}_predictor")(h).permute(0, 2, 3, 1), self.common_stride)

    def forward(self, features: dict[str, Tensor], center_targets: Tensor | None = None,
                center_weights: Tensor | None = None, offset_targets: Tensor | None = None,
                offset_weights: Tensor | None = None, train: bool = False):
        y = self.decoder.decode(features)
        center = self._branch("center", y)
        offset = self._branch("offset", y) * self.common_stride
        if not train:
            return center, offset, {}, {}
        cw = center_weights
        closs = torch.sum((center[..., 0] - center_targets) ** 2 * cw)
        closs = torch.where(cw.sum() > 0, closs / torch.clamp(cw.sum(), min=1e-9), torch.zeros_like(closs))
        ow = offset_weights[..., None]  # broadcast over (dy, dx), as the reference's elementwise product
        oloss = torch.sum(torch.abs(offset - offset_targets) * ow)
        oloss = torch.where(ow.sum() > 0, oloss / torch.clamp(ow.sum(), min=1e-9), torch.zeros_like(oloss))
        return (None, None, {"loss_center": closs * self.center_loss_weight},
                {"loss_offset": oloss * self.offset_loss_weight})


# ---------------------------------------------------------------------------
# post-processing (fixed-shape)


def find_instance_center(center: Tensor, threshold: float = 0.1, nms_kernel: int = 3,
                         top_k: int = 200) -> tuple[Tensor, Tensor]:
    """(H, W) heatmap -> ((top_k, 2) (y, x) centres, (top_k,) validity):
    values at or below ``threshold`` set to -1, only the maxima of a
    ``nms_kernel`` max-pool (padded with -inf) kept, the top ``top_k`` by
    score, ties to the lowest index; valid where the score is positive."""
    h, w = center.shape
    x = torch.where(center > threshold, center, torch.full_like(center, -1.0))
    pooled = F.max_pool2d(x[None, None], nms_kernel, 1, (nms_kernel - 1) // 2)[0, 0]
    x = torch.where(x == pooled, x, torch.full_like(x, -1.0))
    flat = x.reshape(-1)
    idx = top_k_indices(flat, min(top_k, h * w))
    pts = torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w], dim=-1)
    return pts, flat[idx] > 0


_GROUP_CHUNK_ELEMS = 1 << 25  # distances of one row chunk: 256 MiB in float64


def group_pixels(centers: Tensor, valid: Tensor, offsets: Tensor) -> Tensor:
    """Each pixel's id (1..K) of its nearest valid centre; offsets (H, W, 2)
    as (dy, dx) -> (H, W) int32. Ties go to the lowest index, and with no
    valid centre every pixel gets 1, as the JAX function's argmin over
    (K, H, W) distances with +inf at invalid centres.

    The distance is JAX's float32 ``norm``: ``sqrt(fma(dx, dx, dy * dy))``,
    correctly rounded. It is computed from the float32 differences in
    float64 (each product exact, the sum and the square root rounded back
    to float32), so the CPU and the card agree bit for bit, and only for
    the valid centres, in chunks of rows."""
    h, w, _ = offsets.shape
    ids = torch.nonzero(valid)[:, 0]
    if ids.numel() == 0:
        return torch.ones((h, w), dtype=torch.int32, device=offsets.device)
    cen = centers[ids].float()
    xx = torch.arange(w, dtype=torch.float32, device=offsets.device)
    rows = max(1, _GROUP_CHUNK_ELEMS // (ids.numel() * w))
    out = []
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        yy = torch.arange(y0, y1, dtype=torch.float32, device=offsets.device)[:, None]
        dy = cen[:, 0, None, None] - (yy + offsets[y0:y1, :, 0])[None]
        dx = cen[:, 1, None, None] - (xx + offsets[y0:y1, :, 1])[None]
        dy2 = (dy.double() * dy.double()).float().double()
        d = (dx.double() * dx.double() + dy2).float().double().sqrt().float()
        out.append(ids[torch.argmin(d, dim=0)])
    return (torch.cat(out).to(torch.int32) + 1)


def merge_semantic_and_instance(sem_seg: Tensor, ins_seg: Tensor, thing_seg: Tensor, num_classes: int,
                                max_instances: int, thing_mask_by_class: Tensor, label_divisor: int = 1000,
                                stuff_area: int = 2048, void_label: int = -1) -> Tensor:
    """Panoptic fusion, as the JAX function: each instance id's class is the
    majority (first on ties) of ``sem_seg`` over its thing pixels; instances
    are numbered per class in id order (the reference's Counter); a stuff
    class whose instance-free area reaches ``stuff_area`` is pasted where no
    instance is. ``sem_seg`` (H, W) in [0, num_classes), ``ins_seg`` (H, W)
    in [0, max_instances] -> (H, W) int32."""
    sem, ins = sem_seg.long(), ins_seg.long()
    is_thing = (ins > 0) & (thing_seg > 0)
    k = max_instances
    # hist[k - 1, c]: the pixels of instance k that are things of class c
    key = torch.where(is_thing, (ins - 1) * num_classes + sem, torch.full_like(ins, k * num_classes))
    hist = torch.bincount(key.reshape(-1), minlength=k * num_classes + 1)[:k * num_classes].reshape(k, num_classes)
    present = hist.sum(dim=1) > 0
    maj = torch.argmax(hist, dim=1)
    same = (maj[None, :] == maj[:, None]) & present[None, :] & present[:, None]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool, device=sem.device), diagonal=-1)
    pan_val = maj * label_divisor + 1 + torch.sum(same & earlier, dim=1)
    slot = torch.clamp(ins - 1, 0, k - 1)
    covered = is_thing & (ins <= k) & present[slot]
    pan = torch.where(covered, pan_val[slot], torch.full_like(sem, void_label))
    free = ins == 0
    areas = torch.bincount(sem[free], minlength=num_classes)[:num_classes]
    ok = (areas >= stuff_area) & ~thing_mask_by_class.bool()
    stuff_hit = free & ok[sem] & ~covered
    return torch.where(stuff_hit, sem * label_divisor, pan).to(torch.int32)


def get_panoptic_segmentation(sem_seg: Tensor, center: Tensor, offsets: Tensor, thing_mask_by_class: Tensor,
                              num_classes: int, label_divisor: int = 1000, stuff_area: int = 2048,
                              void_label: int = -1, threshold: float = 0.1, nms_kernel: int = 7,
                              top_k: int = 200) -> tuple[Tensor, Tensor, Tensor]:
    """The whole fixed-shape fusion: (panoptic (H, W) int32, centres
    (top_k, 2), validity (top_k,))."""
    thing_seg = thing_mask_by_class.bool()[sem_seg.long()]
    pts, valid = find_instance_center(center, threshold, nms_kernel, top_k)
    grouped = group_pixels(pts, valid, offsets) * thing_seg.to(torch.int32)
    ins = torch.where(valid.any(), grouped, torch.zeros_like(grouped))
    pan = merge_semantic_and_instance(sem_seg, ins, thing_seg, num_classes, top_k, thing_mask_by_class,
                                      label_divisor, stuff_area, void_label)
    return pan, pts, valid


# ---------------------------------------------------------------------------
# target generation (host numpy, the data layer)


@dataclasses.dataclass
class PanopticTargetGenerator:
    """Training targets from a panoptic id map and its segments: the
    semantic map, Gaussian centre splats, the offset field, the semantic
    weights (small instances up-weighted) and the centre and offset
    weights (crowd segments ignored)."""

    ignore_label: int
    thing_ids: frozenset
    sigma: float = 8.0
    ignore_stuff_in_offset: bool = True
    small_instance_area: int = 4096
    small_instance_weight: float = 3.0
    ignore_crowd_in_semantic: bool = False

    def __call__(self, panoptic: np.ndarray, segments_info: list[dict]) -> dict:
        h, w = panoptic.shape
        semantic = np.full_like(panoptic, self.ignore_label, dtype=np.int64)
        center = np.zeros((h, w), np.float32)
        offset = np.zeros((h, w, 2), np.float32)
        sem_w = np.ones((h, w), np.float32)
        center_w = np.zeros((h, w), np.float32)
        offset_w = np.zeros((h, w), np.float32)
        yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
        size = int(6 * self.sigma + 3)
        gx = np.arange(size, dtype=np.float32)
        g0 = 3 * self.sigma + 1
        g = np.exp(-((gx - g0) ** 2 + (gx[:, None] - g0) ** 2) / (2 * self.sigma**2))
        pts = []
        for seg in segments_info:
            cat, sid = seg["category_id"], seg["id"]
            m = panoptic == sid
            if not (self.ignore_crowd_in_semantic and seg.get("iscrowd", 0)):
                semantic[m] = cat
            if not seg.get("iscrowd", 0):
                center_w[m] = 1
                if not self.ignore_stuff_in_offset or cat in self.thing_ids:
                    offset_w[m] = 1
            if cat in self.thing_ids:
                idx = np.nonzero(m)
                if idx[0].size == 0:
                    continue
                if idx[0].size < self.small_instance_area:
                    sem_w[m] = self.small_instance_weight
                cy, cx = float(np.mean(idx[0])), float(np.mean(idx[1]))
                pts.append((cy, cx))
                y, x = int(round(cy)), int(round(cx))
                ul = (int(np.round(x - 3 * self.sigma - 1)), int(np.round(y - 3 * self.sigma - 1)))
                br = (int(np.round(x + 3 * self.sigma + 2)), int(np.round(y + 3 * self.sigma + 2)))
                gx0, gx1 = max(0, -ul[0]), min(br[0], w) - ul[0]
                gy0, gy1 = max(0, -ul[1]), min(br[1], h) - ul[1]
                cx0, cx1 = max(0, ul[0]), min(br[0], w)
                cy0, cy1 = max(0, ul[1]), min(br[1], h)
                center[cy0:cy1, cx0:cx1] = np.maximum(center[cy0:cy1, cx0:cx1], g[gy0:gy1, gx0:gx1])
                offset[..., 0][idx] = cy - yy[idx]
                offset[..., 1][idx] = cx - xx[idx]
        return dict(sem_seg=semantic, center=center, center_points=pts, offset=offset, sem_seg_weights=sem_w,
                    center_weights=center_w, offset_weights=offset_w)
