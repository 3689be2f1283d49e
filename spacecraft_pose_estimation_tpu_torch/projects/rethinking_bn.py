"""Rethinking-BatchNorm (port of ``projects/rethinking_bn.py``).

Semantic contract of the reference ``projects/Rethinking-BatchNorm/`` (and
the ``CycleBatchNormList`` layer it adds to detectron2,
layers/batch_norm.py:233-278), as the JAX module keeps it: a shared head
whose BN keeps one set of statistics per FPN level (a "domain") with ONE
shared affine. The domain is an argument (the level's index), as in the
JAX module, which stands for the reference's cycling through its states
once per level in level order.

* :class:`CycleBatchNorm`: ``scale`` and ``bias`` shared; ``mean`` and
  ``var`` buffers of (num_domains, C) (Flax's ``batch_stats``). In train
  mode a batch is normalized by its own float32 mean and biased variance,
  and its domain's running statistics move by momentum 0.9 towards the
  mean and the UNBIASED variance, as ``nn.BatchNorm2d`` tracks it; in eval
  mode the domain's running statistics normalize. Epsilon 1e-5.
* :class:`BNConvTower`: ``num_convs`` shared 3x3 convs, each followed by a
  CycleBatchNorm and ReLU, over every level: ``variant="cycle"`` keeps a
  set of statistics per level, ``"shared"`` one for all.

Both follow the module's mode (``.train()`` / ``.eval()``) and are built in
eval mode, as ``layers.BatchNorm`` is; maps are (N, H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import BN_EPS, BN_MOMENTUM, Conv, init_params


class CycleBatchNorm(nn.Module):
    """Per-domain BN statistics with a shared affine, over the last axis of
    (..., C) (or, with ``channel_dim=1``, over NCHW). Output in the input's
    dtype."""

    def __init__(self, num_domains: int, features: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
                 device=None):
        super().__init__()
        self.num_domains, self.momentum, self.eps = num_domains, momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(num_domains, features))
        self.register_buffer("var", torch.ones(num_domains, features))
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: Tensor, domain: int, channel_dim: int = -1) -> Tensor:
        if not 0 <= domain < self.num_domains:
            raise ValueError(f"domain {domain} is not in [0, {self.num_domains})")
        xf = x.float()
        cd = channel_dim % x.ndim
        axes = tuple(a for a in range(x.ndim) if a != cd)
        shape = [1] * x.ndim
        shape[cd] = x.shape[cd]
        if self.training:
            m = xf.mean(axes)
            v = xf.var(axes, unbiased=False)
            n = x.numel() // x.shape[cd]
            with torch.no_grad():
                self.mean[domain] = self.momentum * self.mean[domain] + (1 - self.momentum) * m
                self.var[domain] = self.momentum * self.var[domain] + (1 - self.momentum) * (v * (n / max(n - 1, 1)))
        else:
            m, v = self.mean[domain], self.var[domain]
        y = (xf - m.reshape(shape)) * torch.rsqrt(v + self.eps).reshape(shape)
        return (y * self.scale.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class BNConvTower(nn.Module):
    """``conv0``... (3x3, bias, shared by the levels) each followed by
    ``norm{i}`` (a CycleBatchNorm of ``num_levels`` domains for "cycle", of
    one for "shared") and ReLU: ``num_levels`` maps (N, H_l, W_l, Cin) ->
    the same maps at ``features`` channels. ``dtype`` is the compute dtype;
    parameters stay float32. Runs on ``device`` (CUDA unless given
    another); built in eval mode."""

    def __init__(self, num_levels: int, in_channels: int, features: int, num_convs: int = 4, variant: str = "cycle",
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if variant not in ("cycle", "shared"):
            raise ValueError(f"variant must be 'cycle' or 'shared', got {variant!r}")
        self.num_levels, self.num_convs, self.variant, self.dtype = num_levels, num_convs, variant, dtype
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv(in_channels if i == 0 else features, features, 3, 1, 1))
            self.add_module(f"norm{i}", CycleBatchNorm(num_levels if variant == "cycle" else 1, features,
                                                       device="cpu"))
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, feats: list[Tensor]) -> list[Tensor]:
        if len(feats) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(feats)}")
        outs = []
        for lvl, x in enumerate(feats):
            dom = lvl if self.variant == "cycle" else 0
            x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
            for i in range(self.num_convs):
                x = F.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x), dom, channel_dim=1))
            outs.append(x.permute(0, 2, 3, 1))
        return outs
