"""Conv building blocks (port of ``models/layers.py``).

Module and parameter names mirror the Flax modules of the JAX package
(``conv``, ``bn`` with ``scale``/``bias``/``mean``/``var``, ``conv1``...,
``down``), so ``convert.py`` maps a Flax variable tree onto a
``state_dict`` by name. Tensors inside the modules are NCHW; the compute
dtype is the input's (the models cast once at their entry), parameters
stay float32 and are cast per call. ``BatchNorm`` follows the module's
mode: running statistics under ``.eval()``, batch statistics under
``.train()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # Flax's momentum: running = 0.9 * running + 0.1 * batch


class Conv(nn.Module):
    """Conv2d with a (out, in // groups, k, k) ``weight`` and optional
    ``bias``, cast to the input's dtype; explicit symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding, 1, self.groups)


class ConvTranspose(nn.Module):
    """Flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) with an
    explicit ``(lo, hi)`` padding per side: the input dilated by ``stride``,
    padded by ``lo`` before and ``hi`` after on each spatial axis, then
    convolved with the kernel as Flax stores it. ``weight`` is that kernel
    in ``F.conv_transpose2d``'s form, flipped in space and laid out
    (in, out, kh, kw): Flax ``kernel[a, b, i, o]`` is
    ``weight[i, o, kh - 1 - a, kw - 1 - b]`` (``convert.py`` maps it). In
    torch's terms the padding is ``k - 1 - lo`` and the output padding
    ``hi - lo``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, padding: tuple[int, int],
                 bias: bool = True):
        super().__init__()
        lo, hi = padding
        if not (0 <= lo <= kernel - 1 and 0 <= hi - lo < stride):
            raise ValueError(f"padding {padding} has no torch form for kernel {kernel}, stride {stride}")
        self.stride, self.padding, self.output_padding = stride, kernel - 1 - lo, hi - lo
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding, self.output_padding)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """BatchNorm over NCHW. Eval mode: y = (x - mean) / sqrt(var + eps) *
    scale + bias with the running statistics, applied as one per-channel
    affine in the input's dtype. Train mode, as Flax's ``nn.BatchNorm``
    (``force_float32_reductions``): the batch mean and biased variance over
    N, H, W in float32 for any input dtype, the normalization in float32
    cast to the input's dtype, gradients through the statistics (PyTorch's
    fused ``native_batch_norm`` and its backward; Flax computes the
    variance as E[x^2] - E[x]^2, this kernel by Welford's sums: the same
    quantity, rounded differently); then the running statistics
    ``0.9 * running + 0.1 * batch`` with the biased variance, not the
    unbiased one ``nn.BatchNorm2d`` would store. It is built in eval mode,
    so the port's models serve as built; ``model.train()`` switches it."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.training = False
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            # no running statistics handed in: the kernel would update them with the unbiased variance
            y, mean, invstd = torch.ops.aten.native_batch_norm(x, self.scale, self.bias, None, None, True, 0.0,
                                                               self.eps)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * (invstd.pow(-2) - self.eps))
            return y
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


def upsample_bilinear(x, factor: int):
    """Bilinear x``factor`` upsample of NCHW with half-pixel centres
    (``jax.image.resize(..., "bilinear")``, upsampling only: the source
    coordinate is clamped at the edges, where ``jax.image.resize`` keeps the
    one tap inside the image, the same value)."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: N(0, 1/fan_in) for conv, transposed
    conv and linear weights (Flax's lecun scale), zero biases; BN keeps its
    identity init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, ConvTranspose, Linear)):
                fan_in = (m.weight[:, 0] if isinstance(m, ConvTranspose) else m.weight[0]).numel()
                w = torch.randn(m.weight.shape, generator=generator) * fan_in**-0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
