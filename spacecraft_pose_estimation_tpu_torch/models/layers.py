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

import warnings

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # Flax's momentum: running = 0.9 * running + 0.1 * batch
FLAX_NORM_EPS = 1e-6  # Flax's nn.LayerNorm and nn.GroupNorm default epsilon (PyTorch's is 1e-5)


class Conv(nn.Module):
    """Conv2d with a (out, in // groups, k, k) ``weight`` and optional
    ``bias``, cast to the input's dtype; explicit symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups, self.dilation = stride, padding, groups, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding, self.dilation, self.groups)


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
    so the port's models serve as built; ``model.train()`` switches it.

    ``process_group`` (set by ``parallel.data_parallel``): train mode then
    takes its statistics over the whole batch of every rank in the group,
    as the JAX package's ``jit`` over a sharded batch does. Each rank's
    float32 sums of x and x^2 and its count go through one differentiable
    all-reduce, and the mean and biased variance are Flax's E[x],
    E[x^2] - E[x]^2; the normalization and the running statistics follow
    as above."""

    process_group = None

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.training = False
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training and self.process_group is not None:
            return self._global_batch_norm(x)
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

    def _global_batch_norm(self, x):
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        count = torch.full((1,), xf.numel() / xf.shape[1], dtype=torch.float32, device=x.device)
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])
        with warnings.catch_warnings():  # newer PyTorch names a successor without autograd
            warnings.simplefilter("ignore", FutureWarning)
            total = all_reduce(local, group=self.process_group)
        c = xf.shape[1]
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        return y.to(x.dtype)


def _flax_stats(xf, dims):
    """Flax's ``_compute_stats`` of float32 ``xf`` over ``dims``: the mean and
    the fast variance max(0, E[x^2] - E[x]^2), kept as dims of size 1."""
    mu = xf.mean(dims, keepdim=True)
    return mu, torch.clamp((xf * xf).mean(dims, keepdim=True) - mu * mu, min=0.0)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis of a channels-last tensor:
    ``scale`` and ``bias`` parameters, epsilon 1e-6, the statistics in
    float32 with the fast variance E[x^2] - E[x]^2 (``use_fast_variance``),
    the output in the input's dtype."""

    def __init__(self, features: int, eps: float = FLAX_NORM_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mu, var = _flax_stats(xf, -1)
        return ((xf - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm`` (``num_groups`` groups of consecutive
    channels) on NCHW: ``scale`` and ``bias`` parameters, epsilon 1e-6, each
    group's statistics over its channels and H, W in float32 with the fast
    variance, the output in the input's dtype."""

    def __init__(self, features: int, num_groups: int = 32, eps: float = FLAX_NORM_EPS):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {features} channels")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        n, c = x.shape[:2]
        g = (self.num_groups, c // self.num_groups) + (1,) * (x.ndim - 2)
        xg = x.float().reshape(n, *g[:2], *x.shape[2:])
        mu, var = _flax_stats(xg, tuple(range(2, xg.ndim)))
        y = (xg - mu) * (torch.rsqrt(var + self.eps) * self.scale.reshape(g)) + self.bias.reshape(g)
        return y.reshape(x.shape).to(x.dtype)


def gelu(x):
    """Flax's ``nn.gelu`` (``approximate=True``): the tanh form."""
    return F.gelu(x, approximate="tanh")


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


class ConvSeq(nn.Module):
    """A plain sequence of ``ConvBN`` layers ``seq0``, ``seq1`` ... from
    (features, kernel, stride, act) specs."""

    def __init__(self, cin: int, specs):
        super().__init__()
        self.n = len(specs)
        for i, (f, k, s, a) in enumerate(specs):
            self.add_module(f"seq{i}", ConvBN(cin, f, k, s, act=a))
            cin = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"seq{i}")(x)
        return x


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
