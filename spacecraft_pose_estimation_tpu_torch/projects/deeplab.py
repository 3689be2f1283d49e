"""DeepLab: DeepLabV3 / V3+ semantic segmentation (port of ``projects/deeplab.py``).

Semantic contract of the reference ``projects/DeepLab/deeplab/``, as the
JAX module keeps it:

* ``deeplab_ce_loss`` (DeepLabCE): per-pixel CE with an ignore label (an
  exact zero at ignored pixels, which stay in the pool), the per-pixel
  weights applied, then the mean of the top-k% largest over ALL pixels of
  the batch;
* ``DeepLabStem``: three 3x3 convs (s2, s1, s1) and a 3x3/s2 max-pool in
  place of the 7x7 ResNet stem;
* ``DeepLabResNet``: dilated res4 / res5 with multi-grid dilations
  (output stride 16 at ``res5_dilation`` 2). Unlike the detector's
  ``ResNetBackbone`` it stops no gradient: the JAX module ignores
  ``freeze_at``;
* ``DeepLabV3Head``: ASPP on one level + a 1x1 predictor, upsampled by
  ``common_stride``; ``DeepLabV3PlusHead``: ASPP at the deepest level, then
  per shallower level a 1x1 projection, the running state upsampled to it,
  a concat and two 3x3 fuse convs;
* ``warmup_poly_schedule``: WarmupPolyLR, computed in float32.

Features and logits are NHWC, as in the JAX module; the convs run NCHW
views of them (channels_last memory). Logits are upsampled in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.extra_layers import ASPP
from ..models.layers import Conv, init_params
from ..models.resnet_backbone import RESNET_STAGE_BLOCKS, BottleneckX, ConvFrozenBN, ResNetConfig
from .point_rend import init_prediction, upsample_bilinear

# ---------------------------------------------------------------------------
# loss and schedule


def deeplab_ce_loss(logits: Tensor, labels: Tensor, ignore_label: int = -1, top_k_percent: float = 1.0,
                    weights: Tensor | None = None) -> Tensor:
    """DeepLabCE on (N, H, W, C) logits and (N, H, W) int labels: ignored
    pixels give a loss of exactly 0 and stay in the top-k pool; ``weights``
    (N, H, W) multiply before the top-k; k = int(p · N·H·W), at least 1."""
    valid = labels != ignore_label
    tgt = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if weights is not None:
        nll = nll * weights
    flat = nll.reshape(-1)
    if top_k_percent >= 1.0:
        return torch.mean(flat)
    k = int(top_k_percent * flat.shape[0])
    return torch.mean(torch.topk(flat, max(k, 1)).values)


def warmup_poly_schedule(base_lr: float, max_iters: int, warmup_iters: int = 1000, warmup_factor: float = 0.001,
                         power: float = 0.9, constant_ending: float = 0.0):
    """WarmupPolyLR: step -> a 0-d float32 learning rate, ``base_lr`` times
    the linear warmup times ``(1 - step / max_iters)^power``, held at
    ``constant_ending`` once past the warmup and below it."""

    def schedule(step) -> Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        alpha = torch.clamp(step / max(warmup_iters, 1), 0.0, 1.0)
        warm = torch.where(step < warmup_iters, warmup_factor * (1 - alpha) + alpha, torch.ones_like(alpha))
        poly = torch.pow(torch.clamp(1.0 - step / max_iters, min=0.0), power)
        if constant_ending > 0:
            poly = torch.where((warm >= 1.0) & (poly < constant_ending), torch.full_like(poly, constant_ending), poly)
        return base_lr * warm * poly

    return schedule


# ---------------------------------------------------------------------------
# trunk


class DeepLabStem(nn.Module):
    """3x3 (s2) -> 3x3 -> 3x3 ConvFrozenBN + 3x3/s2 max-pool; the first two
    convs at half of ``out_channels``. NCHW."""

    def __init__(self, out_channels: int = 128, in_channels: int = 3):
        super().__init__()
        h = out_channels // 2
        self.conv1 = ConvFrozenBN(in_channels, h, 3, 2)
        self.conv2 = ConvFrozenBN(h, h, 3, 1)
        self.conv3 = ConvFrozenBN(h, out_channels, 3, 1)

    def forward(self, x: Tensor) -> Tensor:
        return F.max_pool2d(self.conv3(self.conv2(self.conv1(x))), 3, 2, 1)


@dataclasses.dataclass(frozen=True)
class DeepLabResNetConfig:
    resnet: ResNetConfig = ResNetConfig(depth=50)
    stem_channels: int = 128
    res4_dilation: int = 1
    res5_dilation: int = 2
    res5_multi_grid: tuple[int, ...] = (1, 2, 4)


DEEPLAB_R50 = DeepLabResNetConfig()
DEEPLAB_TINY = DeepLabResNetConfig(
    resnet=ResNetConfig(depth=50, stem_channels=8, res2_out_channels=16, freeze_at=0),
    stem_channels=16,
)


def _stage_stride_dilation(cfg: DeepLabResNetConfig, stage: int) -> tuple[int, int]:
    if stage == 4:
        return (1, cfg.res4_dilation) if cfg.res4_dilation > 1 else (2, 1)
    if stage == 5:
        return (1 if cfg.res5_dilation > 1 else 2), cfg.res5_dilation
    return (1 if stage == 2 else 2), 1


class DeepLabResNet(nn.Module):
    """ResNet with the DeepLab stem and dilated res4 / res5 on the port's
    ``BottleneckX``: (N, H, W, 3) -> {"res2".."res5": (N, h, w, C)}, NHWC.
    res5 block ``bi`` is dilated ``res5_dilation * res5_multi_grid[bi % 3]``;
    its first block keeps the 1x1 shortcut. Module names mirror the Flax
    tree (``stem.conv1``, ``res5_b2.conv2`` ...). ``dtype`` is the compute
    dtype; parameters stay float32. Nothing is frozen. Runs on ``device``
    (CUDA unless given another)."""

    def __init__(self, config: DeepLabResNetConfig = DEEPLAB_R50, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        rc = config.resnet
        self.stem = DeepLabStem(config.stem_channels)
        cin, out_ch, bottleneck = config.stem_channels, rc.res2_out_channels, rc.width_per_group * rc.groups
        self.stages = []
        for si, n_blocks in enumerate(RESNET_STAGE_BLOCKS[rc.depth]):
            stage = si + 2
            stride, dilation = _stage_stride_dilation(config, stage)
            blocks = []
            for bi in range(n_blocks):
                grid = config.res5_multi_grid[bi % len(config.res5_multi_grid)] if stage == 5 else 1
                m = BottleneckX(cin, out_ch, bottleneck, stride if bi == 0 else 1, rc.groups, rc.stride_in_1x1,
                                dilation * grid)
                self.add_module(f"res{stage}_b{bi}", m)
                blocks.append(m)
                cin = out_ch
            self.stages.append(blocks)
            out_ch *= 2
            bottleneck *= 2
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    @property
    def out_channels(self) -> dict[str, int]:
        c = self.config.resnet.res2_out_channels
        return {f"res{i + 2}": c * 2**i for i in range(4)}

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        x = self.stem(x.permute(0, 3, 1, 2).to(self.dtype))
        feats = {}
        for si, blocks in enumerate(self.stages):
            for m in blocks:
                x = m(x)
            feats[f"res{si + 2}"] = x.permute(0, 2, 3, 1)
        return feats


# ---------------------------------------------------------------------------
# heads


def _sem_seg_losses(y: Tensor, targets: Tensor, loss_type: str, ignore_value: int, loss_weight: float,
                    weights: Tensor | None = None) -> dict[str, Tensor]:
    topk = 0.2 if loss_type == "hard_pixel_mining" else 1.0
    return {"loss_sem_seg": deeplab_ce_loss(y, targets, ignore_value, topk, weights) * loss_weight}


class DeepLabV3Head(nn.Module):
    """ASPP on one level + a 1x1 predictor. ``forward(features, targets,
    train)``: inference -> (logits (N, H, W, C) upsampled by
    ``common_stride`` in float32, {}); train -> (None, {"loss_sem_seg"}).
    ``in_channels``: the level's channels."""

    def __init__(self, num_classes: int, in_channels: int, in_feature: str = "res5", aspp_channels: int = 256,
                 aspp_dilations: tuple[int, ...] = (6, 12, 18), common_stride: int = 16,
                 loss_type: str = "hard_pixel_mining", ignore_value: int = -1, loss_weight: float = 1.0,
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.in_feature, self.common_stride, self.dtype = in_feature, common_stride, dtype
        self.loss_type, self.ignore_value, self.loss_weight = loss_type, ignore_value, loss_weight
        self.aspp = ASPP(in_channels, aspp_channels, aspp_dilations, dtype=dtype, device="cpu")
        self.predictor = Conv(aspp_channels, num_classes, 1)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        init_prediction(self.predictor, generator)
        self.to(resolve_device(device))

    def forward(self, features: dict[str, Tensor], targets: Tensor | None = None, train: bool = False):
        x = self.predictor(self.aspp(features[self.in_feature]).permute(0, 3, 1, 2))
        y = upsample_bilinear(x.permute(0, 2, 3, 1), self.common_stride)
        if train:
            return None, _sem_seg_losses(y, targets, self.loss_type, self.ignore_value, self.loss_weight)
        return y, {}


class DeepLabV3PlusHead(nn.Module):
    """Encoder-decoder head: ASPP (``aspp_<f>``) at the deepest of
    ``in_features``, then top-down per shallower level ``f``: ``project_<f>``
    (1x1 + ReLU), the running state upsampled to its stride in float32, a
    concat and ``fuse_<f>_0`` / ``fuse_<f>_1`` (3x3 + ReLU). With
    ``num_classes`` None it returns the decoder's (N, h, w, C) state (the
    Panoptic-DeepLab heads reuse it); else a 1x1 ``predictor`` and the
    float32 upsample by ``common_stride``, as :class:`DeepLabV3Head`.
    ``in_channels``: each of ``in_features``' channels."""

    def __init__(self, num_classes: int | None, in_channels: Sequence[int],
                 in_features: tuple[str, ...] = ("res2", "res5"), in_strides: tuple[int, ...] = (4, 16),
                 project_channels: tuple[int, ...] = (48,), aspp_channels: int = 256,
                 aspp_dilations: tuple[int, ...] = (6, 12, 18), decoder_channels: tuple[int, ...] = (256, 256),
                 common_stride: int = 4, loss_type: str = "hard_pixel_mining", ignore_value: int = -1,
                 loss_weight: float = 1.0, dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if len(project_channels) != len(in_features) - 1 or len(decoder_channels) != len(in_features):
            raise ValueError("project_channels needs one entry fewer than in_features, decoder_channels one each")
        self.in_features, self.in_strides, self.common_stride = tuple(in_features), tuple(in_strides), common_stride
        self.loss_type, self.ignore_value, self.loss_weight, self.dtype = loss_type, ignore_value, loss_weight, dtype
        y_ch = aspp_channels
        for idx in reversed(range(len(in_features))):
            f = in_features[idx]
            if idx == len(in_features) - 1:
                self.add_module(f"aspp_{f}", ASPP(in_channels[idx], aspp_channels, aspp_dilations, dtype=dtype,
                                                  device="cpu"))
                continue
            self.add_module(f"project_{f}", Conv(in_channels[idx], project_channels[idx], 1))
            self.add_module(f"fuse_{f}_0", Conv(project_channels[idx] + y_ch, decoder_channels[idx], 3, 1, 1))
            self.add_module(f"fuse_{f}_1", Conv(decoder_channels[idx], decoder_channels[idx], 3, 1, 1))
            y_ch = decoder_channels[idx]
        self.out_channels = y_ch
        self.predictor = Conv(y_ch, num_classes, 1) if num_classes is not None else None
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        if self.predictor is not None:
            init_prediction(self.predictor, generator)
        self.to(resolve_device(device))

    def decode(self, features: dict[str, Tensor]) -> Tensor:
        """The decoder's state, NCHW in the compute dtype."""
        last = len(self.in_features) - 1
        y = getattr(self, f"aspp_{self.in_features[last]}")(features[self.in_features[last]]).permute(0, 3, 1, 2)
        for idx in reversed(range(last)):
            f = self.in_features[idx]
            proj = F.relu(getattr(self, f"project_{f}")(features[f].permute(0, 3, 1, 2).to(self.dtype)))
            factor = self.in_strides[idx + 1] // self.in_strides[idx]
            y = upsample_bilinear(y.permute(0, 2, 3, 1), factor).permute(0, 3, 1, 2).to(proj.dtype)
            y = torch.cat([proj, y], dim=1)
            y = F.relu(getattr(self, f"fuse_{f}_0")(y))
            y = F.relu(getattr(self, f"fuse_{f}_1")(y))
        return y

    def forward(self, features: dict[str, Tensor], targets: Tensor | None = None, train: bool = False):
        y = self.decode(features)
        if self.predictor is None:
            return y.permute(0, 2, 3, 1)
        y = upsample_bilinear(self.predictor(y).permute(0, 2, 3, 1), self.common_stride)
        if train:
            return None, _sem_seg_losses(y, targets, self.loss_type, self.ignore_value, self.loss_weight)
        return y, {}
