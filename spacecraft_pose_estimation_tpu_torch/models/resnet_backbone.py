"""ResNet / ResNeXt detection backbone with frozen BN (port of ``models/resnet_backbone.py``).

The dense Caffe2-style trunks (stride in the 1x1, ``groups=1``:
``RESNET101_FPN``, ``RESNET_TINY``) and the ResNeXt one
(``RESNEXT101_32x8d``: 32 groups of 8 in res2, stride in the grouped
3x3). Module names mirror the Flax tree (``stem.conv``, ``stem.norm``,
``res2_b0.conv1`` ...). NCHW inside. ``FrozenBN`` is the JAX package's:
a fixed affine whose four tensors are parameters that get no gradient, in
train mode too; ``freeze_at`` stops the gradient after the stem and the
first stages as the JAX module does. Both leave the frozen parameters to
the optimizer, whose weight decay still moves them, as optax's does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BN_EPS, Conv


class FrozenBN(nn.Module):
    """y = x * mul + add from frozen BN statistics (FrozenBatchNorm2d).

    ``scale``, ``bias``, ``mean`` and ``var`` are parameters, as in the
    JAX package's ``params`` tree, and the forward detaches them, as its
    ``stop_gradient`` does: their gradient is zero whatever the module's
    mode. The affine is computed in float32 and applied in the input's
    dtype, in the JAX module's operand order.
    """

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        scale, bias, mean, var = (t.detach() for t in (self.scale, self.bias, self.mean, self.var))
        inv = torch.rsqrt(var + self.eps)
        mul = (scale * inv).to(x.dtype)
        add = (bias - mean * scale * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class MergedGroupConv(Conv):
    """The grouped conv of the JAX package's ``MergedGroupConv``, as a plain
    ``groups=`` conv with the compact (out, in // groups, k, k) weight.

    The JAX module merges groups block-diagonally into 128-lane groups, a
    TPU packing: the zeros it adds change nothing but the order of the
    sums, so the port does not copy it.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, groups: int, dilation: int = 1):
        super().__init__(cin, cout, kernel, stride, dilation * (kernel - 1) // 2, bias=False, groups=groups,
                         dilation=dilation)


class ConvFrozenBN(nn.Module):
    """Conv (no bias, padding ``dilation * (kernel - 1) // 2``) -> FrozenBN -> optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, act: bool = True,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        self.act = act
        self.conv = (MergedGroupConv(cin, cout, kernel, stride, groups, dilation) if groups > 1
                     else Conv(cin, cout, kernel, stride, dilation * (kernel - 1) // 2, bias=False,
                               dilation=dilation))
        self.norm = FrozenBN(cout)

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


class BottleneckX(nn.Module):
    """Detectron2 BottleneckBlock: 1x1 -> 3x3 (groups) -> 1x1 + shortcut.

    The stride sits on the 1x1 (Caffe2 trunks) or, with ``stride_in_1x1``
    False, on the 3x3 (ResNeXt). ``dilation`` dilates the 3x3 alone (the
    DeepLab trunks' res4 / res5)."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int, stride: int = 1,
                 groups: int = 1, stride_in_1x1: bool = True, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvFrozenBN(cin, bottleneck_channels, 1, s1)
        self.conv2 = ConvFrozenBN(bottleneck_channels, bottleneck_channels, 3, s3, groups=groups, dilation=dilation)
        self.conv3 = ConvFrozenBN(bottleneck_channels, out_channels, 1, 1, act=False)
        self.shortcut = (
            ConvFrozenBN(cin, out_channels, 1, stride, act=False)
            if stride != 1 or cin != out_channels else None
        )

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 101
    stem_channels: int = 64
    res2_out_channels: int = 256
    groups: int = 1  # 32 for ResNeXt
    width_per_group: int = 64  # 8 for X101-32x8d; res2's bottleneck is groups x width, doubling per stage
    stride_in_1x1: bool = True  # False for the ResNeXt zoo weights
    freeze_at: int = 2  # no gradient through the stem (>= 1) and res2..res{freeze_at} (the zoo default)


RESNET101_FPN = ResNetConfig(depth=101)
# The reference's flagship trunk (config_4: X101-FPN).
RESNEXT101_32x8d = ResNetConfig(depth=101, groups=32, width_per_group=8, stride_in_1x1=False)
RESNET_TINY = ResNetConfig(depth=50, stem_channels=8, res2_out_channels=16, freeze_at=0)


class ResNetBackbone(nn.Module):
    """7x7 stem + max-pool + res2..res5; returns {res_i: NCHW features}."""

    def __init__(self, config: ResNetConfig = RESNET101_FPN):
        super().__init__()
        self.config = config
        self.stem = ConvFrozenBN(3, config.stem_channels, 7, 2)
        cin = config.stem_channels
        out_ch = config.res2_out_channels
        bottleneck = config.width_per_group * config.groups
        self.stages = []
        for si, n_blocks in enumerate(RESNET_STAGE_BLOCKS[config.depth]):
            blocks = []
            for bi in range(n_blocks):
                m = BottleneckX(cin, out_ch, bottleneck, 2 if si > 0 and bi == 0 else 1,
                                config.groups, config.stride_in_1x1)
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
        freeze_at = self.config.freeze_at
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        if freeze_at >= 1:
            x = x.detach()
        feats = {}
        for si, blocks in enumerate(self.stages):
            for m in blocks:
                x = m(x)
            if freeze_at >= si + 2:
                x = x.detach()
            feats[f"res{si + 2}"] = x
        return feats
