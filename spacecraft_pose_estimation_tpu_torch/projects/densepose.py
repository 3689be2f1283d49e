"""DensePose, chart-based (port of ``projects/densepose.py``).

Semantic contract of the reference ``projects/DensePose/densepose/``, as
the JAX module keeps it:

* ``DensePoseV1ConvXHead``: N_STACKED_CONVS (8) 3x3 convs of
  CONV_HEAD_DIM (512) channels, ReLU after each;
* ``DensePoseDeepLabHead``: ASPP at dilations (6, 12, 56), then the same
  stacked convs without bias, each with GroupNorm(32) and ReLU;
* ``DensePoseChartPredictor``: four ConvTranspose2d(4, stride 2, padding
  1) heads (coarse segmentation, fine segmentation, U, V), each upsampled
  bilinearly by UP_SCALE (2);
* ``DensePoseDecoder``: each FPN level brought to stride 4 by ``max(1, i)``
  steps of 3x3 conv + ReLU (+ 2x bilinear), summed, then a 1x1;
* :func:`densepose_roi_forward`: with the decoder, the merged stride-4 map
  pooled on its own; without it, the FPN levels by the multilevel
  assignment; both at P 28, sampling ratio 2, every tap on the map (the
  JAX package's gather read);
* the chart loss (smooth-L1 U / V at the annotated foreground points,
  cross-entropy of the fine labels at the valid points, pixel-mean
  cross-entropy of the coarse segmentation on the estimate's grid) and the
  converter to labels and UV on a fixed grid.

The pooling is K2's gather read on CUDA tensors (``roi_align_multilevel``,
one level with the decoder, four without it), and its gradient K2b's; the
CPU takes the plain versions: ``roi_align_maps`` on the merged map, the
multilevel plain gather on the pyramid. Heads run NCHW views of
channels-last memory; inputs and outputs keep the JAX layout (N, H, W, C).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.extra_layers import ASPP
from ..models.layers import Conv, ConvTranspose, GroupNorm, init_params
from ..ops import roi_align
from .point_rend import interpolate_bilinear, upsample_bilinear


@dataclasses.dataclass(frozen=True)
class DensePoseConfig:
    """Defaults mirror densepose/config.py:167-199."""

    num_coarse_segm_channels: int = 2
    num_patches: int = 24
    num_stacked_convs: int = 8
    conv_head_dim: int = 512
    conv_head_kernel: int = 3
    deconv_kernel: int = 4
    up_scale: int = 2
    heatmap_size: int = 112
    index_weights: float = 5.0  # w_segm (coarse)
    part_weights: float = 1.0  # w_part (fine)
    point_regression_weights: float = 0.01  # w_points (U / V)
    decoder_channels: int = 256
    head: str = "v1convx"  # or "deeplab"


class DensePoseChartPredictorOutput(NamedTuple):
    """(N, S, S, K) coarse segmentation and (N, S, S, C) fine segmentation, U, V."""

    coarse_segm: Tensor
    fine_segm: Tensor
    u: Tensor
    v: Tensor


def _nchw(x: Tensor, dtype) -> Tensor:
    return x.permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)


class DensePoseV1ConvXHead(nn.Module):
    """``body_conv_fcn1``... : stacked 3x3 conv + ReLU. (N, H, W, Cin) ->
    (N, H, W, conv_head_dim) in ``dtype``. Built on the CPU:
    :class:`DensePoseHead` initialises and places it."""

    def __init__(self, config: DensePoseConfig, in_channels: int, dtype=torch.float32):
        super().__init__()
        self.n, self.dtype = config.num_stacked_convs, dtype
        k, cin = config.conv_head_kernel, in_channels
        for i in range(self.n):
            self.add_module(f"body_conv_fcn{i + 1}", Conv(cin, config.conv_head_dim, k, 1, k // 2))
            cin = config.conv_head_dim

    def forward(self, x: Tensor) -> Tensor:
        x = _nchw(x, self.dtype)
        for i in range(self.n):
            x = F.relu(getattr(self, f"body_conv_fcn{i + 1}")(x))
        return x.permute(0, 2, 3, 1)


class DensePoseDeepLabHead(nn.Module):
    """``aspp`` (dilations 6, 12, 56) then ``body_conv_fcn{i}`` (no bias) +
    ``gn{i}`` (GroupNorm 32) + ReLU. (N, H, W, Cin) -> (N, H, W, conv_head_dim).
    Built on the CPU: :class:`DensePoseHead` initialises and places it."""

    def __init__(self, config: DensePoseConfig, in_channels: int, dtype=torch.float32):
        super().__init__()
        self.n, self.dtype = config.num_stacked_convs, dtype
        d, k = config.conv_head_dim, config.conv_head_kernel
        self.aspp = ASPP(in_channels, d, (6, 12, 56), dtype=dtype, device="cpu")
        for i in range(self.n):
            self.add_module(f"body_conv_fcn{i + 1}", Conv(d, d, k, 1, k // 2, bias=False))
            self.add_module(f"gn{i + 1}", GroupNorm(d, 32))

    def forward(self, x: Tensor) -> Tensor:
        x = _nchw(self.aspp(x), self.dtype)
        for i in range(self.n):
            x = F.relu(getattr(self, f"gn{i + 1}")(getattr(self, f"body_conv_fcn{i + 1}")(x)))
        return x.permute(0, 2, 3, 1)


PREDICTOR_HEADS = ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres")


class DensePoseChartPredictor(nn.Module):
    """Four stride-2 transposed convs (``ann_index_lowres`` to K channels,
    ``index_uv_lowres``, ``u_lowres``, ``v_lowres`` to num_patches + 1),
    Flax's explicit padding (2, 2) at k 4, each upsampled bilinearly by
    ``up_scale``: (N, S, S, Cin) -> outputs at 2 S · up_scale, float32.
    Built on the CPU: :class:`DensePoseHead` initialises and places it."""

    def __init__(self, config: DensePoseConfig, in_channels: int, dtype=torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        k = config.deconv_kernel
        p = k - 1 - (k // 2 - 1)  # torch ConvTranspose2d(k, 2, k / 2 - 1) as XLA's explicit padding
        c = config.num_patches + 1
        for name, ch in zip(PREDICTOR_HEADS, (config.num_coarse_segm_channels, c, c, c)):
            self.add_module(name, ConvTranspose(in_channels, ch, k, 2, (p, p)))

    def forward(self, x: Tensor) -> DensePoseChartPredictorOutput:
        x = _nchw(x, self.dtype)
        return DensePoseChartPredictorOutput(*(
            upsample_bilinear(getattr(self, name)(x).permute(0, 2, 3, 1), self.config.up_scale)
            for name in PREDICTOR_HEADS))


class DensePoseDecoder(nn.Module):
    """Semantic-FPN merge of the levels (fine to coarse, strides 4 · 2^i) at
    stride 4: level i takes ``max(1, i)`` steps ``scale_head{i}_conv{s}``
    (3x3 + ReLU, then 2x bilinear when i > 0); the sum goes through a 1x1
    ``predictor`` to ``decoder_channels``. [(B, H_i, W_i, Cin)] ->
    (B, H_0, W_0, decoder_channels) in ``dtype``, channels-last memory."""

    def __init__(self, config: DensePoseConfig, in_channels: int, num_levels: int = 4, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        d = config.decoder_channels
        for i in range(num_levels):
            for step in range(max(1, i)):
                self.add_module(f"scale_head{i}_conv{step}", Conv(in_channels if step == 0 else d, d, 3, 1, 1))
        self.predictor = Conv(d, d, 1)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, features: Sequence[Tensor]) -> Tensor:
        merged = None
        for i, f in enumerate(features):
            x = _nchw(f, self.dtype)
            for step in range(max(1, i)):
                x = F.relu(getattr(self, f"scale_head{i}_conv{step}")(x.to(self.dtype)))
                if i > 0:
                    x = upsample_bilinear(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
            merged = x if merged is None else merged + x
        return self.predictor(merged.to(self.dtype)).permute(0, 2, 3, 1)


class DensePoseHead(nn.Module):
    """``densepose_head`` (v1convx or deeplab, by ``config.head``) +
    ``densepose_predictor``: pooled (R, P, P, in_channels) ->
    :class:`DensePoseChartPredictorOutput` at 2 P · up_scale."""

    def __init__(self, config: DensePoseConfig, in_channels: int, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        body = DensePoseDeepLabHead if config.head == "deeplab" else DensePoseV1ConvXHead
        self.densepose_head = body(config, in_channels, dtype)
        self.densepose_predictor = DensePoseChartPredictor(config, config.conv_head_dim, dtype)
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x: Tensor) -> DensePoseChartPredictorOutput:
        return self.densepose_predictor(self.densepose_head(x))


# ---------------------------------------------------------------------------
# ROI integration


def pool_merged(merged: Tensor, boxes: Tensor, batch_idx: Tensor, output_size: int, stride: int) -> Tensor:
    """The JAX ``roi_align(merged[b], boxes, P, 1 / stride, sampling_ratio=2)``
    on the decoder's (B, H, W, C) map: on CUDA tensors K2's gather read on
    one level (K2b its gradient), on the CPU its plain version
    ``roi_align_maps``. (R, P, P, C) float32."""
    if boxes.device.type == "cpu":
        return roi_align.roi_align_maps(merged, batch_idx, boxes, output_size, 1.0 / stride, sampling_ratio=2)
    return roi_align.roi_align_multilevel([merged.contiguous()], boxes, batch_idx, output_size, (stride,),
                                          sampling_ratio=2, impl="gather")


def densepose_roi_forward(head: DensePoseHead, features: Sequence[Tensor], boxes: Tensor, *,
                          decoder: DensePoseDecoder | None = None, pooler_resolution: int = 28,
                          strides: tuple[int, ...] = (4, 8, 16, 32),
                          batch_idx: Tensor | None = None) -> DensePoseChartPredictorOutput:
    """Pool box features and run the DensePose head. With ``decoder``
    (DECODER_ON, the default) the levels are merged to one stride-4 map and
    pooled there; otherwise by the multilevel assignment. ``features``: the
    FPN maps (B, H_i, W_i, C), fine to coarse; ``boxes`` (R, 4) XYXY image
    pixels, fixed R (padded boxes give padded outputs); ``batch_idx`` (R,)
    the image of each box (all 0 when omitted: one image, the JAX
    function's unit)."""
    if batch_idx is None:
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    batch_idx = batch_idx.to(torch.int32)
    if decoder is not None:
        pooled = pool_merged(decoder(features), boxes, batch_idx, pooler_resolution, strides[0])
    else:
        pooled = roi_align.roi_align_multilevel([f.contiguous() for f in features], boxes, batch_idx,
                                                pooler_resolution, tuple(strides), sampling_ratio=2, impl="gather")
    return head(pooled)


# ---------------------------------------------------------------------------
# chart loss


class PackedChartAnnotations(NamedTuple):
    """Flat annotated points of a batch, padded to P, with validity masks.
    ``x_gt`` / ``y_gt`` are 0..256-normalized offsets in the GT box;
    ``point_instance`` maps each point to its row of the predictor output
    and of the box arrays."""

    x_gt: Tensor  # (P,)
    y_gt: Tensor  # (P,)
    u_gt: Tensor  # (P,)
    v_gt: Tensor  # (P,)
    fine_segm_labels_gt: Tensor  # (P,) int 0..C-1
    point_instance: Tensor  # (P,) int
    point_valid: Tensor  # (P,) bool
    bbox_xywh_gt: Tensor  # (N, 4)
    bbox_xywh_est: Tensor  # (N, 4)
    coarse_segm_gt: Tensor  # (N, Hg, Wg) int labels on the GT box's grid
    instance_valid: Tensor  # (N,) bool


def resample_data_nearest(z: Tensor, bbox_xywh_src: Tensor, bbox_xywh_dst: Tensor,
                          out_hw: tuple[int, int]) -> Tensor:
    """``resample_data(mode='nearest', padding_mode='zeros')``: data on the
    source box's grid re-expressed on the destination box's, grid_sample
    with ``align_corners=True``, positions rounded half to even. z (N, H, W,
    C) -> (N, hout, wout, C); taps outside the source are zero."""
    n, h, w, _ = z.shape
    hout, wout = out_hw
    x0s, y0s, ws, hs = bbox_xywh_src.unbind(1)
    x0d, y0d, wd, hd = bbox_xywh_dst.unbind(1)
    x0n, y0n = 2.0 * (x0d - x0s) / ws - 1.0, 2.0 * (y0d - y0s) / hs - 1.0
    x1n, y1n = 2.0 * (x0d + wd - x0s) / ws - 1.0, 2.0 * (y0d + hd - y0s) / hs - 1.0
    gw = torch.arange(wout, dtype=torch.float32, device=z.device) / wout
    gh = torch.arange(hout, dtype=torch.float32, device=z.device) / hout
    gx = gw[None, None, :] * (x1n - x0n)[:, None, None] + x0n[:, None, None]
    gy = gh[None, :, None] * (y1n - y0n)[:, None, None] + y0n[:, None, None]
    px = torch.round((gx + 1.0) * 0.5 * (w - 1))
    py = torch.round((gy + 1.0) * 0.5 * (h - 1))
    valid = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    ix = torch.clamp(px, 0, w - 1).long()
    iy = torch.clamp(py, 0, h - 1).long()
    bidx = torch.arange(n, device=z.device)[:, None, None]
    return z[bidx, iy, ix, :] * valid[..., None].to(z.dtype)


def _linear_interpolation_utilities(v_norm, v0_src, size_src, v0_dst, size_dst, size_z: int):
    """losses/utils.py:16-59, the clamp-then-min weight at the right edge included."""
    v = v0_src + v_norm * size_src / 256.0
    j_valid = (v - v0_dst >= 0) & (v - v0_dst < size_dst)
    v_grid = (v - v0_dst) * size_z / torch.clamp(size_dst, min=1e-12)
    v_lo = torch.clamp(torch.floor(v_grid), 0, size_z - 1).long()
    v_hi = torch.clamp(v_lo + 1, max=size_z - 1)
    v_grid = torch.minimum(v_hi.to(v_grid.dtype), v_grid)
    return v_lo, v_hi, v_grid - v_lo.to(v_grid.dtype), j_valid


def _smooth_l1(x: Tensor) -> Tensor:
    """``F.smooth_l1_loss(beta=1)`` elementwise."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def densepose_chart_loss(out: DensePoseChartPredictorOutput, ann: PackedChartAnnotations,
                         cfg: DensePoseConfig) -> dict[str, Tensor]:
    """losses/chart.py:66-290 as one fixed-shape masked computation:
    ``loss_densepose_{U,V,I,S}``, each exactly 0 where there is no valid
    foreground point (and, for S, no valid instance)."""
    s = out.u.shape[1]
    inst = ann.point_instance.long()
    x0g, y0g, wg, hg = ann.bbox_xywh_gt[inst].unbind(1)
    x0e, y0e, we, he = ann.bbox_xywh_est[inst].unbind(1)
    x_lo, x_hi, x_w, jx = _linear_interpolation_utilities(ann.x_gt, x0g, wg, x0e, we, s)
    y_lo, y_hi, y_w, jy = _linear_interpolation_utilities(ann.y_gt, y0g, hg, y0e, he, s)
    j_valid = jx & jy & ann.point_valid
    w00, w01 = (1.0 - x_w) * (1.0 - y_w), x_w * (1.0 - y_w)
    w10, w11 = (1.0 - x_w) * y_w, x_w * y_w
    label = ann.fine_segm_labels_gt.long()

    def extract(z, channel):  # z (N, S, S, C); channel (P,), or None for every channel -> (P, C)
        if channel is None:
            tap = lambda ys, xs, wt: z[inst, ys, xs, :] * wt[:, None]  # noqa: E731
        else:
            tap = lambda ys, xs, wt: z[inst, ys, xs, channel] * wt  # noqa: E731
        return tap(y_lo, x_lo, w00) + tap(y_lo, x_hi, w01) + tap(y_hi, x_lo, w10) + tap(y_hi, x_hi, w11)

    fg = j_valid & (label > 0)
    fgf = fg.float()
    loss_u = torch.sum(_smooth_l1(extract(out.u, label) - ann.u_gt) * fgf)
    loss_v = torch.sum(_smooth_l1(extract(out.v, label) - ann.v_gt) * fgf)
    logp = F.log_softmax(extract(out.fine_segm, None), dim=-1)
    ce = -torch.gather(logp, 1, label[:, None])[:, 0]
    jvf = j_valid.float()
    loss_i = torch.sum(ce * jvf) / torch.clamp(torch.sum(jvf), min=1.0)
    seg_gt = resample_data_nearest(ann.coarse_segm_gt[..., None].float(), ann.bbox_xywh_gt, ann.bbox_xywh_est,
                                   (s, s))[..., 0].long()
    if out.coarse_segm.shape[-1] == 2:
        seg_gt = (seg_gt > 0).long()
    seg_ce = -torch.gather(F.log_softmax(out.coarse_segm, dim=-1), -1, seg_gt[..., None])[..., 0]
    ivf = ann.instance_valid.float()[:, None, None]
    loss_s = torch.sum(seg_ce * ivf) / torch.clamp(torch.sum(ivf) * s * s, min=1.0)
    any_fg = torch.any(fg).float()
    any_inst = torch.any(ann.instance_valid).float()
    return {
        "loss_densepose_U": loss_u * cfg.point_regression_weights * any_fg,
        "loss_densepose_V": loss_v * cfg.point_regression_weights * any_fg,
        "loss_densepose_I": loss_i * cfg.part_weights * any_fg,
        "loss_densepose_S": loss_s * cfg.index_weights * any_fg * any_inst,
    }


# ---------------------------------------------------------------------------
# inference converter


def chart_result_for_grid(out: DensePoseChartPredictorOutput, grid_hw: tuple[int, int]) -> tuple[Tensor, Tensor]:
    """The outputs resampled (plain bilinear, never antialiased) to a fixed
    ``grid_hw``: labels (N, h, w) int32 = argmax(fine) * (argmax(coarse) >
    0), first maximum on ties; uv (N, h, w, 2) at the winning part, 0 on
    the background."""
    rs = lambda z: interpolate_bilinear(z, grid_hw)  # noqa: E731
    coarse = torch.argmax(rs(out.coarse_segm), dim=-1)
    fine = torch.argmax(rs(out.fine_segm), dim=-1)
    labels = (fine * (coarse > 0)).to(torch.int32)
    idx = labels.long()[..., None]
    u = torch.gather(rs(out.u), -1, idx)[..., 0]
    v = torch.gather(rs(out.v), -1, idx)[..., 0]
    keep = (labels > 0).to(u.dtype)
    return labels, torch.stack([u * keep, v * keep], dim=-1)
