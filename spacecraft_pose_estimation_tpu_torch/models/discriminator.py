"""Multi-scale domain discriminator of the adversarial domain adaptation (port of ``models/discriminator.py``).

The reference's ``lib/models/multi_scale_discriminator.py:69-114``
(resnet34_ms): the four per-scale heatmaps of a CMS HRNet are upsampled
bilinearly to the finest resolution and concatenated (4 x J channels),
then a CIFAR-style ResNet-34 (3x3 stem, no max-pool, basic blocks
(3, 4, 6, 3) of widths 64-512) and a global mean feed a linear layer of
``num_classes`` domain logits. It computes in float32, as the JAX trainer
builds it. Module names mirror the Flax tree (``stem_conv``, ``stem_bn``,
``layer1_b0``, ``linear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import BasicBlock, BatchNorm, Conv, Linear, init_params, upsample_bilinear


class MultiScaleDiscriminator(nn.Module):
    """forward(h1, h2, h3, h4): NHWC maps of J channels each, h1 at the
    finest resolution and each next one half of it -> (B, num_classes)
    float32 logits. Built in eval mode (running BN statistics); under
    ``.train()`` it takes the batch statistics, as ``hrnet.HRNet``."""

    def __init__(self, num_joints: int, num_classes: int = 2, stage_blocks=(3, 4, 6, 3), dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(4 * num_joints, 64, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        cin = 64
        for si, (w, n) in enumerate(zip((64, 128, 256, 512), stage_blocks)):
            for bi in range(n):
                m = BasicBlock(cin, w, 2 if (si > 0 and bi == 0) else 1)
                self.add_module(f"layer{si + 1}_b{bi}", m)
                self.blocks.append(m)
                cin = w
        self.linear = Linear(cin, num_classes)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, h1, h2, h3, h4):
        maps = [h.permute(0, 3, 1, 2) for h in (h1, h2, h3, h4)]
        maps = [maps[0]] + [upsample_bilinear(h, 2 ** i) for i, h in enumerate(maps[1:], 1)]
        x = torch.cat(maps, dim=1).to(self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for m in self.blocks:
            x = m(x)
        return self.linear(x.mean(dim=(2, 3))).float()
