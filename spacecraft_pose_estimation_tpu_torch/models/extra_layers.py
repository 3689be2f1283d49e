"""ASPP and a greedy IoU tracker (port of ``models/extra_layers.py``).

* :class:`ASPP`: atrous spatial pyramid pooling (detectron2
  ``layers/aspp.py``): a 1x1 conv, three dilated 3x3 convs and an image
  pooling branch in parallel, concatenated and projected, ReLU after each.
* :class:`IouTracker`: greedy per-frame IoU association (detectron2
  ``tracking/bbox_iou_tracker.py``); host-side and stateful.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.boxes import pairwise_iou
from .layers import Conv, init_params


class ASPP(nn.Module):
    """(B, H, W, Cin) NHWC -> (B, H, W, features). Module names mirror the
    Flax tree: ``conv1x1``, ``atrous0``..., ``pool_conv``, ``project``, each
    conv with a bias. ``dtype`` is the compute dtype; parameters stay float32."""

    def __init__(self, cin: int, features: int = 256, dilations: tuple[int, ...] = (6, 12, 18),
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.n_atrous = dtype, len(dilations)
        self.conv1x1 = Conv(cin, features, 1)
        for i, d in enumerate(dilations):
            self.add_module(f"atrous{i}", Conv(cin, features, 3, 1, d, dilation=d))
        self.pool_conv = Conv(cin, features, 1)
        self.project = Conv(features * (len(dilations) + 2), features, 1)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        outs = [F.relu(self.conv1x1(x))]
        outs += [F.relu(getattr(self, f"atrous{i}")(x)) for i in range(self.n_atrous)]
        pooled = F.relu(self.pool_conv(x.mean(dim=(2, 3), keepdim=True)))
        outs.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(self.project(torch.cat(outs, dim=1))).permute(0, 2, 3, 1)


class IouTracker:
    """Greedy per-frame IoU association on the host.

    Each frame's boxes are matched to the live tracks in descending IoU
    order (numpy's default sort of the float32 IoU matrix, as in the JAX
    package, so ties fall the same way), down to ``iou_threshold``; an
    unmatched box starts a new track, and a track unmatched for more than
    ``max_missed`` frames is dropped. The IoU runs on ``device`` (CUDA
    unless the caller names another, e.g. "cpu"), as the JAX package's runs
    on its default device."""

    def __init__(self, iou_threshold: float = 0.5, max_missed: int = 5, device=None):
        self.device = resolve_device(device)
        self.iou_threshold = iou_threshold
        self.max_missed = max_missed
        self.tracks: dict[int, dict] = {}
        self._next_id = 0

    def update(self, boxes: np.ndarray, scores: np.ndarray | None = None) -> list[int]:
        """The new frame's boxes (N, 4) -> each box's track id."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        ids = [-1] * len(boxes)
        if self.tracks and len(boxes):
            track_ids = list(self.tracks)
            prev = np.stack([self.tracks[t]["box"] for t in track_ids])
            # the JAX package's IoU of float64 boxes runs in float32 (x64 off)
            iou = pairwise_iou(torch.as_tensor(prev.astype(np.float32), device=self.device),
                               torch.as_tensor(boxes.astype(np.float32), device=self.device)).cpu().numpy()
            order = np.argsort(-iou, axis=None)
            used_t, used_d = set(), set()
            for flat in order:
                ti, di = divmod(int(flat), len(boxes))
                if iou[ti, di] < self.iou_threshold:
                    break
                if ti in used_t or di in used_d:
                    continue
                tid = track_ids[ti]
                ids[di] = tid
                self.tracks[tid] = {"box": boxes[di], "missed": 0}
                used_t.add(ti)
                used_d.add(di)
        for di, tid in enumerate(ids):
            if tid == -1:
                ids[di] = self._next_id
                self.tracks[self._next_id] = {"box": boxes[di], "missed": 0}
                self._next_id += 1
        matched = set(ids)
        for tid in list(self.tracks):  # age out the unmatched tracks
            if tid not in matched:
                self.tracks[tid]["missed"] += 1
                if self.tracks[tid]["missed"] > self.max_missed:
                    del self.tracks[tid]
        return ids
