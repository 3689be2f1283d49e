"""TridentNet (port of ``projects/tridentnet.py``).

Semantic contract of the reference ``projects/TridentNet/tridentnet/``, as
the JAX module keeps it:

* ``TridentConv``: ONE weight applied at each branch's dilation (padding
  ``d * (k - 1) // 2``), or at ``branch_idx``'s alone at test time;
* ``TridentBottleneckBlock``: a bottleneck whose 3x3 is a TridentConv, its
  1x1s and shortcut shared by the branches; the last block of a stage
  concatenates the branches branch-major onto the batch axis;
* :func:`merge_branch_detections`: per image, every branch's padded
  detections, class-aware NMS and the top-k by score.

The branches live on the batch axis: a stage maps (B, H, W, C) to
(num_branch · B, H', W', C'), branch j of image i at row i + B · j. The
blocks run NCHW views of channels-last memory; the stage's input and
output are (N, H, W, C), as in the JAX module. The merge's NMS is
``ops.nms.batched_nms_mask``, K4 on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import Conv, init_params
from ..models.resnet_backbone import ConvFrozenBN, FrozenBN
from ..ops.nms import batched_nms_mask, top_k_by_score


class TridentConv(Conv):
    """The weight-shared multi-dilation conv: ``weight`` (the Flax raw
    ``kernel``, OIHW here) and an optional ``bias``. ``forward(xs)``: the
    (num_branch, B, H, W, C) stack of branches, or with ``branch_idx`` the
    one plane (1, B, H, W, C) of that branch -> the same stack at
    ``features`` channels, in the input's dtype. Built on the CPU:
    :class:`TridentStage` initialises and places it."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dilations: tuple[int, ...] = (1, 2, 3), use_bias: bool = False):
        super().__init__(cin, features, kernel, stride, bias=use_bias)
        self.dilations = tuple(dilations)

    def dils(self, branch_idx: int | None) -> tuple[int, ...]:
        return self.dilations if branch_idx is None else (self.dilations[branch_idx],)

    def branch(self, x: Tensor, d: int) -> Tensor:
        """One branch, NCHW, at dilation ``d``."""
        k = self.weight.shape[-1]
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, d * (k - 1) // 2, d)

    def forward(self, xs: Tensor, branch_idx: int | None = None) -> Tensor:
        dils = self.dils(branch_idx)
        if xs.shape[0] != len(dils):
            raise ValueError(f"expected {len(dils)} branch planes, got {xs.shape[0]}")
        return torch.stack([self.branch(xs[i].permute(0, 3, 1, 2), d).permute(0, 2, 3, 1)
                            for i, d in enumerate(dils)])


class TridentBottleneckBlock(nn.Module):
    """``conv1`` (1x1) -> ``conv2`` (TridentConv 3x3) -> ``norm2`` (FrozenBN)
    + ReLU -> ``conv3`` (1x1), plus ``shortcut`` where the stride or the
    width changes, ReLU; the 1x1s and the shortcut shared by the branches.
    ``forward(xs)``: (num_branch, B, H, W, C) -> the same stack, or with
    ``concat_output`` (num_branch · B, H', W', C'), branch-major. Built on the
    CPU: :class:`TridentStage` initialises and places it."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int, stride: int = 1,
                 dilations: tuple[int, ...] = (1, 2, 3), stride_in_1x1: bool = False, concat_output: bool = False):
        super().__init__()
        self.concat_output = concat_output
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvFrozenBN(cin, bottleneck_channels, 1, s1)
        self.conv2 = TridentConv(bottleneck_channels, bottleneck_channels, 3, s3, dilations)
        self.norm2 = FrozenBN(bottleneck_channels)
        self.conv3 = ConvFrozenBN(bottleneck_channels, out_channels, 1, 1, act=False)
        self.shortcut = (ConvFrozenBN(cin, out_channels, 1, stride, act=False)
                         if stride != 1 or cin != out_channels else None)

    def folded(self, x: Tensor, branch_idx: int | None) -> Tensor:
        """NCHW branches folded branch-major onto the batch axis, in and out."""
        dils = self.conv2.dils(branch_idx)
        out = self.conv1(x)
        out = torch.cat([self.conv2.branch(o, d) for o, d in zip(out.chunk(len(dils)), dils)])
        out = self.conv3(F.relu(self.norm2(out)))
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))

    def forward(self, xs: Tensor, branch_idx: int | None = None) -> Tensor:
        nb, b = xs.shape[:2]
        x = xs.reshape(nb * b, *xs.shape[2:]).permute(0, 3, 1, 2)
        out = self.folded(x, branch_idx).permute(0, 2, 3, 1)
        return out if self.concat_output else out.reshape(nb, b, *out.shape[1:])


class TridentStage(nn.Module):
    """A trident res-stage: ``block0``... TridentBottleneckBlocks, the first
    at ``stride``, the last concatenating the branches. (B, H, W, C) ->
    (num_branch · B, H', W', out_channels), num_branch 1 with
    ``branch_idx``. ``dtype`` is the compute dtype (the input is cast once);
    parameters stay float32. Runs on ``device`` (CUDA unless given another)."""

    def __init__(self, num_blocks: int, cin: int, out_channels: int, bottleneck_channels: int, stride: int = 2,
                 dilations: tuple[int, ...] = (1, 2, 3), stride_in_1x1: bool = False, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_blocks, self.num_branch, self.dtype = num_blocks, len(dilations), dtype
        for bi in range(num_blocks):
            self.add_module(f"block{bi}", TridentBottleneckBlock(
                cin if bi == 0 else out_channels, out_channels, bottleneck_channels, stride if bi == 0 else 1,
                dilations, stride_in_1x1, concat_output=bi == num_blocks - 1))
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x: Tensor, branch_idx: int | None = None) -> Tensor:
        nb = 1 if branch_idx is not None else self.num_branch
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = x.repeat(nb, 1, 1, 1)
        for bi in range(self.num_blocks):
            x = getattr(self, f"block{bi}").folded(x, branch_idx)
        return x.permute(0, 2, 3, 1)


def merge_branch_detections(boxes: Tensor, scores: Tensor, classes: Tensor, valid: Tensor, num_branch: int,
                            nms_thresh: float = 0.5, topk: int = 100) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fixed-shape branch merge: per image, every branch's padded detections
    (branch j of image i at row i + B · j of the (num_branch · B, R, ...)
    inputs), class-aware NMS over the valid ones (K4 on CUDA tensors), the
    top-k of the kept by score, ties and the -inf padding to the lowest
    index as ``lax.top_k``. Returns (boxes (B, topk, 4), scores (0 past the
    kept), classes, valid)."""
    b, r = boxes.shape[0] // num_branch, boxes.shape[1]

    def regroup(t):
        t = t.reshape(num_branch, b, *t.shape[1:])
        return t.movedim(0, 1).reshape(b, num_branch * r, *t.shape[3:])

    bx, sc, cl, va = regroup(boxes), regroup(scores), regroup(classes), regroup(valid) > 0
    keep = batched_nms_mask(bx, sc, cl, nms_thresh, valid=va) & va
    top_sc, idx = top_k_by_score(torch.where(keep, sc, torch.full_like(sc, -torch.inf)), min(topk, sc.shape[1]))
    finite = torch.isfinite(top_sc)
    return (torch.gather(bx, 1, idx[..., None].expand(-1, -1, 4)), torch.where(finite, top_sc, 0.0),
            torch.gather(cl, 1, idx), finite)
