"""Conv building blocks in eval mode (port of ``models/layers.py``).

Module and parameter names mirror the Flax modules of the JAX package
(``conv``, ``bn`` with ``scale``/``bias``/``mean``/``var``, ``conv1``...,
``down``), so ``convert.py`` maps a Flax variable tree onto a
``state_dict`` by name. Tensors inside the modules are NCHW; the compute
dtype is the input's (the models cast once at their entry), parameters
stay float32 and are cast per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class Conv(nn.Module):
    """Conv2d with a (out, in, k, k) ``weight`` and optional ``bias``,
    cast to the input's dtype; explicit symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm: y = (x - mean) / sqrt(var + eps) * scale + bias,
    applied as one per-channel affine in the input's dtype."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        add = self.bias - self.mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class ConvBN(nn.Module):
    """Conv (no bias, k//2 symmetric padding) -> BN -> optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 3, stride, act=True)
        self.conv2 = ConvBN(features, features, 3, 1, act=False)
        self.down = (
            ConvBN(cin, features, 1, stride, act=False)
            if stride != 1 or cin != features else None
        )

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return F.relu(y + (x if self.down is None else self.down(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = ConvBN(cin, features, 1, 1, act=True)
        self.conv2 = ConvBN(features, features, 3, stride, act=True)
        self.conv3 = ConvBN(features, out, 1, 1, act=False)
        self.down = ConvBN(cin, out, 1, stride, act=False) if stride != 1 or cin != out else None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + (x if self.down is None else self.down(x)))


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def upsample_nearest(x, factor: int):
    """Nearest-neighbour x``factor`` upsample of NCHW (keeps its memory format)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: N(0, 1/fan_in) for conv and linear
    weights (Flax's lecun scale), zero biases; BN keeps its identity init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) * fan_in**-0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
