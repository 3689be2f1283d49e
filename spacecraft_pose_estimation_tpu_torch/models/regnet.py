"""RegNet backbone (port of ``models/regnet.py``, detectron2's ``modeling/backbone/regnet.py``).

A 3x3 stride-2 stem and four stages of X-blocks (1x1 -> grouped 3x3 with
the stage's stride in its first block -> 1x1, plus a shortcut), with
squeeze-excite in RegNetY. Every conv is the detector trunks'
``ConvFrozenBN``; the grouped 3x3 is a plain ``groups=`` conv (the JAX
package's 128-lane group packing only reorders the sums). Module names
mirror the Flax tree (``stem``, ``s1_b0.a``, ``s3_b2.se.fc1``, ``s4_b0.proj``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv, init_params
from .resnet_backbone import ConvFrozenBN


@dataclasses.dataclass(frozen=True)
class RegNetConfig:
    depths: tuple[int, ...] = (1, 2, 7, 12)  # RegNetX-400MF
    widths: tuple[int, ...] = (32, 64, 160, 384)
    group_width: int = 16
    stem_width: int = 32
    se_ratio: float = 0.0  # > 0: RegNetY's squeeze-excite
    out_features: tuple[str, ...] = ("s1", "s2", "s3", "s4")


REGNETX_400MF = RegNetConfig()
REGNETY_400MF = RegNetConfig(depths=(1, 3, 6, 6), widths=(48, 104, 208, 440), group_width=8, se_ratio=0.25)
REGNET_TINY = RegNetConfig(depths=(1, 1, 1, 1), widths=(8, 16, 32, 64), group_width=8, stem_width=8)


class SqueezeExcite(nn.Module):
    """x * sigmoid(fc2(relu(fc1(mean(x))))), both 1x1 convs with biases.
    The middle width is ``round(base_width * ratio)`` of the block's input
    width (detectron2 / pycls; the published RegNetY checkpoints' shapes),
    not of the SE input's."""

    def __init__(self, channels: int, ratio: float, base_width: int | None = None):
        super().__init__()
        base = base_width if base_width is not None else channels
        mid = max(int(round(base * ratio)), 1)
        self.fc1 = Conv(channels, mid, 1)
        self.fc2 = Conv(mid, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class XBlock(nn.Module):
    def __init__(self, w_in: int, width: int, stride: int, group_width: int, se_ratio: float):
        super().__init__()
        groups = max(width // group_width, 1)
        self.a = ConvFrozenBN(w_in, width, 1, 1)
        self.b = ConvFrozenBN(width, width, 3, stride, groups=groups)
        self.se = SqueezeExcite(width, se_ratio, base_width=w_in) if se_ratio > 0 else None
        self.c = ConvFrozenBN(width, width, 1, 1, act=False)
        # a projection where the stride or the width changes
        self.proj = ConvFrozenBN(w_in, width, 1, stride, act=False) if stride != 1 or w_in != width else None

    def forward(self, x):
        out = self.b(self.a(x))
        if self.se is not None:
            out = self.se(out)
        out = self.c(out)
        return F.relu(out + (x if self.proj is None else self.proj(x)))


class RegNet(nn.Module):
    """(B, H, W, 3) NHWC images -> {s1..s4: NHWC features} at strides 4-32.

    ``dtype`` is the compute dtype; parameters stay float32. ``device``
    defaults to CUDA (see ``resolve_device``); weights come from
    ``generator`` (N(0, 1/fan_in) convs, zero biases, identity FrozenBN)."""

    def __init__(self, config: RegNetConfig = REGNETX_400MF, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.stem = ConvFrozenBN(3, config.stem_width, 3, 2)
        cin = config.stem_width
        self.stages = []
        for si, (d, w) in enumerate(zip(config.depths, config.widths)):
            blocks = []
            for bi in range(d):
                block = XBlock(cin, w, 2 if bi == 0 else 1, config.group_width, config.se_ratio)
                self.add_module(f"s{si + 1}_b{bi}", block)
                blocks.append(block)
                cin = w
            self.stages.append(blocks)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last))
        feats = {}
        for si, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x)
            feats[f"s{si + 1}"] = x
        return {k: feats[k].permute(0, 2, 3, 1) for k in self.config.out_features}
