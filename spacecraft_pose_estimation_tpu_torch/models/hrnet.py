"""HRNet with the classic 1/4-resolution heatmap head or the CMS heads (port of ``models/hrnet.py``).

Configs are the JAX package's (``POSE_HRNET_W32``, ``HRNET_CMS``,
``HRNET_CMS_384``, ``HRNET_GOLDEN``, ``HRNET_TINY``); module names mirror
its Flax tree (``stem1``, ``layer1.block0``, ``transition1``,
``stage2_m0.branch0``, ``stage2_m0.fuse.up0_1``, ``head0.deconv`` ...).

``head="classic"``: one conv on branch 0, (B, H/4, W/4, J) heatmaps.
``head="cms"`` / ``"cms_half"``: stage 4 keeps its four branches, each gets
a transposed conv (stride 4, k 5 / stride 2, k 3) and a conv up to the
input's (half) resolution, and the four heads are fused top-down with
bilinear x2 upsampling; in train mode (or with ``return_all_scales``) the
four fused maps come back, finest first.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import BLOCKS, Conv, ConvBN, ConvTranspose, init_params, upsample_bilinear, upsample_nearest


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
    head: str = "classic"  # classic | cms | cms_half
    head_deconv_channels: int = 32

    def with_joints(self, num_joints: int) -> "HRNetConfig":
        return dataclasses.replace(self, num_joints=num_joints)


POSE_HRNET_W32 = HRNetConfig(head="classic")
HRNET_CMS = HRNetConfig(head="cms")
HRNET_CMS_384 = HRNetConfig(head="cms_half")
# the golden-parity harness: the torch reference's hard-coded stem and layer1, small stages
HRNET_GOLDEN = HRNetConfig(
    stem_channels=64,
    stage1_blocks=4,
    stage2=StageSpec(1, 2, (1, 1), (8, 16)),
    stage3=StageSpec(1, 3, (1, 1, 1), (8, 16, 32)),
    stage4=StageSpec(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
)
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


class CMSHead(nn.Module):
    """A transposed conv (stride 4, k 5 or stride 2, k 3; padding (k - 2,
    k - 1) per side, torch's ``padding=1, output_padding=1``) and a conv,
    lifting one branch to (half) the input's resolution."""

    def __init__(self, cin: int, num_joints: int, stride: int, deconv_channels: int, final_kernel: int):
        super().__init__()
        k = 5 if stride == 4 else 3
        self.deconv = ConvTranspose(cin, deconv_channels, k, stride, (k - 2, k - 1))
        self.conv = Conv(deconv_channels, num_joints, final_kernel, 1, final_kernel // 2)

    def forward(self, x):
        return self.conv(self.deconv(x))


class HRNet(nn.Module):
    """HRNet trunk + the config's head. Input (B, H, W, 3) NHWC, already
    normalized; output float32 NHWC heatmaps: (B, H/4, W/4, J) from the
    classic head; from the CMS heads the fused finest map, or in train mode
    or with ``return_all_scales`` the four fused maps (x1, x2, x3, x4),
    each half the resolution of the one before.

    ``dtype`` is the compute dtype (bfloat16 for serving); parameters are
    float32. ``device`` defaults to CUDA (see ``resolve_device``). Built in
    eval mode; under ``.train()`` its BatchNorms take the batch statistics
    and update the running ones.
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
                multi = not (si == 2 and m == spec.num_modules - 1 and config.head == "classic")
                mod = HRModule(spec, chans, multi_scale_output=multi)
                self.add_module(f"stage{si + 2}_m{m}", mod)
                modules.append(mod)
                chans = mod.out_channels
            self.stages.append((trans, modules))
            widths_prev = chans
        k = config.final_conv_kernel
        if config.head == "classic":
            self.final_layer = Conv(widths_prev[0], config.num_joints, k, 1, k // 2, bias=True)
            head_weights = [self.final_layer.weight]
        elif config.head in ("cms", "cms_half"):
            stride = 4 if config.head == "cms" else 2
            self.heads = []
            for i, cin in enumerate(widths_prev):
                h = CMSHead(cin, config.num_joints, stride, config.head_deconv_channels, k)
                self.add_module(f"head{i}", h)
                self.heads.append(h)
            head_weights = [w for h in self.heads for w in (h.deconv.weight, h.conv.weight)]
        else:
            raise ValueError(f"unknown HRNet head {config.head!r}")
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():  # the heatmap heads start at N(0, 0.001), as in the JAX package
            for w in head_weights:
                w.normal_(0.0, 0.001, generator=generator)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x, return_all_scales: bool = False):
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.layer1(self.stem2(self.stem1(x)))
        xs = [x]
        for trans, modules in self.stages:
            xs = trans(xs)
            for mod in modules:
                xs = mod(xs)
        if self.config.head == "classic":
            return self.final_layer(xs[0]).float().permute(0, 2, 3, 1)
        h1, h2, h3, h4 = (head(x).float() for head, x in zip(self.heads, xs))
        # top-down fusion: each coarser map upsampled x2 into the next finer one
        x3 = h3 + upsample_bilinear(h4, 2)
        x2 = h2 + upsample_bilinear(x3, 2)
        x1 = h1 + upsample_bilinear(x2, 2)
        if self.training or return_all_scales:
            return tuple(o.permute(0, 2, 3, 1) for o in (x1, x2, x3, h4))
        return x1.permute(0, 2, 3, 1)
