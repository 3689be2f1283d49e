"""ResNet detection backbone with frozen BN (port of ``models/resnet_backbone.py``).

Dense Caffe2-style trunks only (stride in the 1x1, ``groups=1``):
``RESNET101_FPN`` and ``RESNET_TINY``. The ResNeXt ``MergedGroupConv`` is
not ported yet. Module names mirror the Flax tree (``stem.conv``,
``stem.norm``, ``res2_b0.conv1`` ...). NCHW inside. Inference only, so
FrozenBN is the eval-mode ``layers.BatchNorm``: the same affine from the
same four tensors.
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv


class ConvFrozenBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


class BottleneckX(nn.Module):
    """Detectron2 BottleneckBlock, groups=1, stride in the 1x1:
    1x1 -> 3x3 -> 1x1 + shortcut."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvFrozenBN(cin, bottleneck_channels, 1, stride)
        self.conv2 = ConvFrozenBN(bottleneck_channels, bottleneck_channels, 3, 1)
        self.conv3 = ConvFrozenBN(bottleneck_channels, out_channels, 1, 1, act=False)
        self.shortcut = (
            ConvFrozenBN(cin, out_channels, 1, stride, act=False)
            if stride != 1 or cin != out_channels else None
        )

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
RES2_BOTTLENECK = 64  # width_per_group x groups, doubling per stage


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 101
    stem_channels: int = 64
    res2_out_channels: int = 256


RESNET101_FPN = ResNetConfig(depth=101)
RESNET_TINY = ResNetConfig(depth=50, stem_channels=8, res2_out_channels=16)


class ResNetBackbone(nn.Module):
    """7x7 stem + max-pool + res2..res5; returns {res_i: NCHW features}."""

    def __init__(self, config: ResNetConfig = RESNET101_FPN):
        super().__init__()
        self.config = config
        self.stem = ConvFrozenBN(3, config.stem_channels, 7, 2)
        cin = config.stem_channels
        out_ch = config.res2_out_channels
        bottleneck = RES2_BOTTLENECK
        self.stages = []
        for si, n_blocks in enumerate(RESNET_STAGE_BLOCKS[config.depth]):
            blocks = []
            for bi in range(n_blocks):
                m = BottleneckX(cin, out_ch, bottleneck, 2 if si > 0 and bi == 0 else 1)
                self.add_module(f"res{si + 2}_b{bi}", m)
                blocks.append(m)
                cin = out_ch
            self.stages.append(blocks)
            out_ch *= 2
            bottleneck *= 2

    @property
    def out_channels(self) -> dict[str, int]:
        c = self.config.res2_out_channels
        return {f"res{i + 2}": c * 2**i for i in range(4)}

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        feats = {}
        for si, blocks in enumerate(self.stages):
            for m in blocks:
                x = m(x)
            feats[f"res{si + 2}"] = x
        return feats
