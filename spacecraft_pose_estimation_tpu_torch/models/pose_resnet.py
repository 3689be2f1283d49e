"""SimpleBaseline pose network: ResNet trunk + 3 transposed convs + heatmap conv (port of ``models/pose_resnet.py``).

The reference's ``lib/models/pose_resnet.py:103-271``: a ResNet-50-style
encoder (7x7 stem, max-pool, 4 stages), three ConvTranspose(k4, s2) + BN +
ReLU layers back to 1/4 resolution, then a conv to ``num_joints`` heatmaps.
Module names mirror the JAX package's Flax tree (``stem_conv``,
``stem_bn``, ``layer1_b0``, ``deconv0``, ``deconv_bn0``, ``final_layer``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import BLOCKS, BatchNorm, Conv, ConvTranspose, init_params

RESNET_SPECS = {
    18: ("BASIC", (2, 2, 2, 2)),
    34: ("BASIC", (3, 4, 6, 3)),
    50: ("BOTTLENECK", (3, 4, 6, 3)),
    101: ("BOTTLENECK", (3, 4, 23, 3)),
    152: ("BOTTLENECK", (3, 8, 36, 3)),
}


@dataclasses.dataclass(frozen=True)
class PoseResNetConfig:
    num_joints: int = 17
    depth: int = 50
    num_deconv_layers: int = 3
    deconv_channels: int = 256
    final_conv_kernel: int = 1


class PoseResNet(nn.Module):
    """Input (B, H, W, 3) NHWC, already normalized; output (B, H/4, W/4, J)
    float32 heatmaps. ``dtype``, ``device``, ``generator`` and the BN modes
    as in ``hrnet.HRNet``."""

    consumes_raw_pixels = False

    def __init__(self, config: PoseResNetConfig = PoseResNetConfig(), dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        block_name, stage_blocks = RESNET_SPECS[config.depth]
        blk = BLOCKS[block_name]
        self.stem_conv = Conv(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        cin = 64
        for si, (w, n) in enumerate(zip((64, 128, 256, 512), stage_blocks)):
            for bi in range(n):
                m = blk(cin, w, 2 if (si > 0 and bi == 0) else 1)
                self.add_module(f"layer{si + 1}_b{bi}", m)
                self.blocks.append(m)
                cin = w * blk.expansion
        self.deconvs = []
        for di in range(config.num_deconv_layers):
            # Flax's "SAME" for k 4, stride 2: 2 on each side of the dilated input
            deconv = ConvTranspose(cin, config.deconv_channels, 4, 2, (2, 2), bias=False)
            bn = BatchNorm(config.deconv_channels)
            self.add_module(f"deconv{di}", deconv)
            self.add_module(f"deconv_bn{di}", bn)
            self.deconvs.append((deconv, bn))
            cin = config.deconv_channels
        k = config.final_conv_kernel
        self.final_layer = Conv(cin, config.num_joints, k, 1, k // 2, bias=True)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():  # the head starts at N(0, 0.001), as in the JAX package
            for w in [d.weight for d, _ in self.deconvs] + [self.final_layer.weight]:
                w.normal_(0.0, 0.001, generator=generator)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for m in self.blocks:
            x = m(x)
        for deconv, bn in self.deconvs:
            x = F.relu(bn(deconv(x)))
        return self.final_layer(x).float().permute(0, 2, 3, 1)
