"""HRNet with the classic 1/4-resolution heatmap head (port of ``models/hrnet.py``).

Configs are the JAX package's (``POSE_HRNET_W32``, ``HRNET_TINY``); module
names mirror its Flax tree (``stem1``, ``layer1.block0``, ``transition1``,
``stage2_m0.branch0``, ``stage2_m0.fuse.up0_1`` ...). The CMS heads are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import BLOCKS, Conv, ConvBN, init_params, upsample_nearest


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One parallel multi-resolution stage (a chain of HR modules)."""

    num_modules: int
    num_branches: int
    num_blocks: Sequence[int]
    num_channels: Sequence[int]
    block: str = "BASIC"


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    num_joints: int = 17
    stem_channels: int = 64
    stage1_blocks: int = 4
    stage2: StageSpec = StageSpec(1, 2, (4, 4), (32, 64))
    stage3: StageSpec = StageSpec(4, 3, (4, 4, 4), (32, 64, 128))
    stage4: StageSpec = StageSpec(3, 4, (4, 4, 4, 4), (32, 64, 128, 256))
    final_conv_kernel: int = 1

    def with_joints(self, num_joints: int) -> "HRNetConfig":
        return dataclasses.replace(self, num_joints=num_joints)


POSE_HRNET_W32 = HRNetConfig()
HRNET_TINY = HRNetConfig(
    stem_channels=8,
    stage1_blocks=1,
    stage2=StageSpec(1, 2, (1, 1), (4, 8)),
    stage3=StageSpec(1, 3, (1, 1, 1), (4, 8, 16)),
    stage4=StageSpec(1, 4, (1, 1, 1, 1), (4, 8, 16, 32)),
)


class Branch(nn.Module):
    """One resolution branch: a chain of residual blocks ``block0..``."""

    def __init__(self, block: str, cin: int, features: int, num_blocks: int):
        super().__init__()
        blk = BLOCKS[block]
        self.blocks = []
        for i in range(num_blocks):
            m = blk(cin, features)
            self.add_module(f"block{i}", m)
            self.blocks.append(m)
            cin = features * blk.expansion
        self.out_channels = cin

    def forward(self, x):
        for m in self.blocks:
            x = m(x)
        return x


class FuseLayer(nn.Module):
    """Cross-resolution exchange: each output branch sums every input,
    coarser ones through 1x1 ConvBN + nearest upsample, finer ones through
    chained stride-2 3x3 ConvBNs (ReLU on all but the last)."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int]):
        super().__init__()
        self.n_in, self.n_out = len(in_channels), len(out_channels)
        for i, ci in enumerate(out_channels):
            for j, cj in enumerate(in_channels):
                if j > i:
                    self.add_module(f"up{i}_{j}", ConvBN(cj, ci, 1, 1, act=False))
                elif j < i:
                    c_prev = cj
                    for k in range(i - j):
                        last = k == i - j - 1
                        c_next = ci if last else in_channels[j]
                        self.add_module(
                            f"down{i}_{j}_{k}", ConvBN(c_prev, c_next, 3, 2, act=not last)
                        )
                        c_prev = c_next

    def forward(self, xs):
        outs = []
        for i in range(self.n_out):
            acc = None
            for j, x in enumerate(xs):
                y = x
                if j > i:
                    y = upsample_nearest(getattr(self, f"up{i}_{j}")(x), 2 ** (j - i))
                for k in range(i - j):  # none when j >= i
                    y = getattr(self, f"down{i}_{j}_{k}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    """Parallel branches + fuse exchange (HighResolutionModule)."""

    def __init__(self, spec: StageSpec, in_channels: Sequence[int], multi_scale_output: bool):
        super().__init__()
        exp = BLOCKS[spec.block].expansion
        chans = [c * exp for c in spec.num_channels]
        self.branches = []
        for i, cin in enumerate(in_channels):
            m = Branch(spec.block, cin, chans[i], spec.num_blocks[i])
            self.add_module(f"branch{i}", m)
            self.branches.append(m)
        outs = [m.out_channels for m in self.branches]
        self.fuse = (
            FuseLayer(outs, outs if multi_scale_output else outs[:1]) if len(outs) > 1 else None
        )
        self.out_channels = outs if multi_scale_output or self.fuse is None else outs[:1]

    def forward(self, xs):
        ys = [m(x) for m, x in zip(self.branches, xs)]
        return ys if self.fuse is None else self.fuse(ys)


class Transition(nn.Module):
    """Adapt the previous stage's branches to the next stage's widths/count."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int]):
        super().__init__()
        self.in_channels, self.out_channels = list(in_channels), list(out_channels)
        n_pre = len(in_channels)
        for i, ci in enumerate(out_channels):
            if i < n_pre:
                if in_channels[i] != ci:
                    self.add_module(f"adapt{i}", ConvBN(in_channels[i], ci, 3, 1, act=True))
            else:
                c_prev = in_channels[-1]
                for j in range(i + 1 - n_pre):
                    ch = ci if j == i - n_pre else in_channels[-1]
                    self.add_module(f"new{i}_{j}", ConvBN(c_prev, ch, 3, 2, act=True))
                    c_prev = ch

    def forward(self, xs):
        n_pre = len(xs)
        outs = []
        for i in range(len(self.out_channels)):
            if i < n_pre:
                m = getattr(self, f"adapt{i}", None)
                outs.append(xs[i] if m is None else m(xs[i]))
            else:
                y = xs[-1]
                for j in range(i + 1 - n_pre):
                    y = getattr(self, f"new{i}_{j}")(y)
                outs.append(y)
        return outs


class HRNet(nn.Module):
    """HRNet trunk + classic head. Input (B, H, W, 3) NHWC, already
    normalized; output (B, H/4, W/4, J) float32 heatmaps.

    ``dtype`` is the compute dtype (bfloat16 for serving); parameters are
    float32. ``device`` defaults to CUDA (see ``resolve_device``).
    """

    consumes_raw_pixels = False

    def __init__(self, config: HRNetConfig = POSE_HRNET_W32, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        c = config.stem_channels
        self.stem1 = ConvBN(3, c, 3, 2)
        self.stem2 = ConvBN(c, c, 3, 2)
        self.layer1 = Branch("BOTTLENECK", c, c, config.stage1_blocks)
        widths_prev = [self.layer1.out_channels]
        self.stages = []
        for si, spec in enumerate((config.stage2, config.stage3, config.stage4)):
            exp = BLOCKS[spec.block].expansion
            widths = [ch * exp for ch in spec.num_channels]
            trans = Transition(widths_prev, widths)
            self.add_module(f"transition{si + 1}", trans)
            modules = []
            chans = widths
            for m in range(spec.num_modules):
                multi = not (si == 2 and m == spec.num_modules - 1)
                mod = HRModule(spec, chans, multi_scale_output=multi)
                self.add_module(f"stage{si + 2}_m{m}", mod)
                modules.append(mod)
                chans = mod.out_channels
            self.stages.append((trans, modules))
            widths_prev = chans
        k = config.final_conv_kernel
        self.final_layer = Conv(widths_prev[0], config.num_joints, k, 1, k // 2, bias=True)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():  # the heatmap head starts at N(0, 0.001), as in the JAX package
            self.final_layer.weight.normal_(0.0, 0.001, generator=generator)
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.layer1(self.stem2(self.stem1(x)))
        xs = [x]
        for trans, modules in self.stages:
            xs = trans(xs)
            for mod in modules:
                xs = mod(xs)
        return self.final_layer(xs[0]).float().permute(0, 2, 3, 1)
