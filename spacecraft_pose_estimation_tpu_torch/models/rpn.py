"""Region Proposal Network, inference half (port of ``models/rpn.py``).

Fixed shapes as in the JAX package: proposals come back as
(B, post_nms_topk, 4) with a validity mask. The NMS of every (image,
level) runs in one launch of kernel K4 (``ops/nms.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops import nms as nms_ops
from .layers import Conv

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """The inference fields of the JAX package's ``RPNConfig``."""

    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    min_size: float = 0.0
    bbox_reg_weights: tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


class RPNHead(nn.Module):
    """Shared 3x3 conv -> (objectness, anchor deltas) per level.

    Takes NCHW levels; returns {level: (logits (B, H, W, A), deltas
    (B, H, W, 4A))} float32 in the JAX package's NHWC layout.
    """

    def __init__(self, in_channels: int, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv(in_channels, in_channels, 3, 1, 1)
        self.objectness = Conv(in_channels, num_anchors, 1)
        self.deltas = Conv(in_channels, num_anchors * 4, 1)

    def forward(self, feats: dict[str, Tensor]) -> dict[str, tuple[Tensor, Tensor]]:
        out = {}
        for lvl, x in feats.items():
            t = F.relu(self.conv(x))
            out[lvl] = (
                self.objectness(t).float().permute(0, 2, 3, 1),
                self.deltas(t).float().permute(0, 2, 3, 1),
            )
        return out


def top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``lax.top_k`` over the last dim: descending, ties to the lowest index.

    ``torch.topk`` does not promise that tie order; a stable descending
    sort does, and it decides which padded -inf slots come out.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_last(t: Tensor, n: int, fill) -> Tensor:
    """Pad dim 1 of (B, k, ...) up to n with ``fill``."""
    if t.shape[1] == n:
        return t
    pad = torch.full((t.shape[0], n - t.shape[1], *t.shape[2:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=1)


def find_top_proposals(
    head_out: dict[str, tuple[Tensor, Tensor]],
    anchors: dict[str, Tensor],
    image_hw: tuple[int, int],
    cfg: RPNConfig,
) -> tuple[Tensor, Tensor, Tensor]:
    """Batched proposal selection (rpn.py:118 semantics, per image).

    Per level: top-k by objectness -> decode -> clip -> drop empty -> NMS;
    then the global top post_nms_topk over the survivors.
    ``head_out`` is {level: (logits (B, H, W, A), deltas (B, H, W, 4A))}.
    Returns boxes (B, P, 4), scores (B, P), valid (B, P).
    """
    pre_k, post_k = cfg.pre_nms_topk_test, cfg.post_nms_topk_test
    h, w = image_hw
    levels = sorted(anchors)
    per_level = []
    for lvl in levels:
        logits, deltas = head_out[lvl]
        b = logits.shape[0]
        logits = logits.reshape(b, -1)
        deltas = deltas.reshape(b, -1, 4)
        scores, idx = top_k(logits, min(pre_k, logits.shape[1]))
        picked = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        boxes = box_ops.apply_deltas(picked, anchors[lvl][idx], cfg.bbox_reg_weights)
        boxes = box_ops.clip_boxes(boxes, h, w)
        valid = box_ops.nonempty_mask(boxes, cfg.min_size) & torch.isfinite(scores)
        per_level.append((boxes, scores, valid))

    # one NMS over every (image, level) problem: levels padded to the
    # widest with invalid slots, which neither survive nor suppress
    kmax = max(s.shape[1] for _, s, _ in per_level)
    keep_all = nms_ops.nms_mask(
        torch.stack([_pad_last(bx, kmax, 0.0) for bx, _, _ in per_level], dim=1),
        torch.stack([_pad_last(s, kmax, -torch.inf) for _, s, _ in per_level], dim=1),
        cfg.nms_thresh,
        torch.stack([_pad_last(v, kmax, False) for _, _, v in per_level], dim=1),
    )  # (B, L, kmax)
    boxes = torch.cat([bx for bx, _, _ in per_level], dim=1)
    scores = torch.cat([s for _, s, _ in per_level], dim=1)
    keep = torch.cat([keep_all[:, i, : s.shape[1]] for i, (_, s, _) in enumerate(per_level)], dim=1)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = top_k(masked, min(post_k, masked.shape[1]))
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, torch.isfinite(top_scores)
