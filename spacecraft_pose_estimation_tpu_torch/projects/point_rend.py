"""PointRend: point-based mask refinement (port of ``projects/point_rend.py``).

Semantic contract of the reference
``projects/PointRend/point_rend/{point_features,point_head,mask_head,
semantic_seg}.py``, as the JAX module keeps it:

* ``point_sample`` == ``F.grid_sample(input, 2*coords-1,
  align_corners=False)`` on [0,1]²-normalized coords (zeros padding): the
  image position is ``x = u*W - 0.5``; written as the JAX module's four
  taps, so the two packages round alike.
* train-time point selection: oversample kP uniform points, keep the
  top-βP by uncertainty *of the sampled logits*, top up with (1-β)P fresh
  uniform points. The draws are arguments (``draws``, as
  :func:`point_draws` makes them from a ``torch.Generator``), so a test can
  hand the port JAX's.
* inference: adaptive subdivision, upsample 2x, re-predict the N most
  uncertain grid points and scatter them back.
* ties in every top-k that selects indices fall to the lowest index, as in
  ``jax.lax.top_k``: a stable descending sort, never ``torch.topk``.

Everything keeps the JAX layout: maps (N, H, W, C), points (R, P, C). The
heads work on ONE image's fixed-R padded boxes (the JAX module's vmap
unit); a map is sampled at all R·P points of an image in one call, never
broadcast to R copies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import Conv, Linear, init_params
from ..models.layers import upsample_bilinear as upsample_bilinear_nchw

# ---------------------------------------------------------------------------
# point sampling ops


def point_sample(feat: Tensor, coords: Tensor) -> Tensor:
    """Bilinear-sample ``feat`` (N, H, W, C) at ``coords`` (N, P, 2) of
    [0,1]²-normalized (x, y) points -> (N, P, C); taps outside the map
    contribute zero. A bf16 map gives float32, as the JAX module's float32
    fractions promote it."""
    n, h, w, _ = feat.shape
    xs = coords[..., 0] * w - 0.5
    ys = coords[..., 1] * h - 0.5
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    bidx = torch.arange(n, device=feat.device)[:, None].expand(xs.shape)

    def tap(yi, xi):
        val = feat[bidx, yi.long().clamp(0, h - 1), xi.long().clamp(0, w - 1)]
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        return val * inside[..., None]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def point_sample_nearest(feat: Tensor, coords: Tensor) -> Tensor:
    """Nearest-neighbour variant (``mode="nearest"``), used for GT targets:
    the continuous position rounded half to even, as torch and JAX do."""
    n, h, w, _ = feat.shape
    xs = torch.round(coords[..., 0] * w - 0.5).long()
    ys = torch.round(coords[..., 1] * h - 0.5).long()
    bidx = torch.arange(n, device=feat.device)[:, None].expand(xs.shape)
    return feat[bidx, ys.clamp(0, h - 1), xs.clamp(0, w - 1)]


def regular_grid_coords(r: int, side: int, device=None) -> Tensor:
    """(R, side², 2) regular grid of cell-centred [0,1]² points as (x, y)."""
    ax = (torch.arange(side, dtype=torch.float32, device=resolve_device(device)) + 0.5) * (1.0 / side)
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return grid[None].expand(r, side * side, 2)


def top_k_indices(x: Tensor, k: int) -> Tensor:
    """The indices of the ``k`` largest entries of each row of ``x``, ties
    to the lowest index (``jax.lax.top_k``'s rule)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def calculate_uncertainty(logits: Tensor, classes: Tensor | None = None) -> Tensor:
    """-|logit of the foreground class|. logits (R, ..., C) channels-last,
    classes (R,) or None when C == 1 -> (R, ..., 1)."""
    if logits.shape[-1] == 1:
        fg = logits[..., 0]
    else:
        idx = classes.long().reshape(classes.shape[0], *([1] * (logits.ndim - 1)))
        fg = torch.gather(logits, -1, idx.expand(*logits.shape[:-1], 1))[..., 0]
    return -torch.abs(fg)[..., None]


def sem_seg_uncertainty(logits: Tensor) -> Tensor:
    """Semantic-seg uncertainty: second-best minus best logit; (N, ..., C)
    -> (N, ..., 1). Values only, so ``torch.topk`` serves."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 1] - top2[..., 0])[..., None]


def point_draws(r: int, num_points: int, oversample_ratio: float, importance_sample_ratio: float,
                device, generator: torch.Generator | None = None) -> dict[str, Tensor]:
    """The uniform draws of :func:`uncertain_point_coords_with_randomness`:
    ``candidates`` (R, kP, 2) and ``fresh`` (R, P - βP, 2), from
    ``generator`` (on ``device``) or the default generator."""
    num_sampled = int(num_points * oversample_ratio)
    k_rand = num_points - int(importance_sample_ratio * num_points)
    return {"candidates": torch.rand((r, num_sampled, 2), generator=generator, device=device),
            "fresh": torch.rand((r, k_rand, 2), generator=generator, device=device)}


def uncertain_point_coords_with_randomness(
    coarse_logits: Tensor,  # (R, Hm, Wm, C)
    classes: Tensor | None,
    num_points: int,
    oversample_ratio: float,
    importance_sample_ratio: float,
    uncertainty_fn: Callable[[Tensor], Tensor] | None = None,
    draws: dict[str, Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> Tensor:
    """Train-time biased point selection -> (R, num_points, 2): the
    ``importance_sample_ratio`` share of the most uncertain of the sampled
    ``candidates``, then the ``fresh`` points. ``uncertainty_fn`` defaults
    to -|fg logit|; the semseg head passes :func:`sem_seg_uncertainty`."""
    r = coarse_logits.shape[0]
    k_unc = int(importance_sample_ratio * num_points)
    if draws is None:
        draws = point_draws(r, num_points, oversample_ratio, importance_sample_ratio, coarse_logits.device,
                            generator)
    cand = draws["candidates"]
    logits = point_sample(coarse_logits, cand)  # (R, S, C)
    unc = (calculate_uncertainty(logits, classes) if uncertainty_fn is None else uncertainty_fn(logits))[..., 0]
    idx = top_k_indices(unc, k_unc)
    picked = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2))
    if num_points - k_unc > 0:
        picked = torch.cat([picked, draws["fresh"]], dim=1)
    return picked


def uncertain_point_coords_on_grid(uncertainty_map: Tensor, num_points: int) -> tuple[Tensor, Tensor]:
    """Top-``num_points`` cells of a (R, H, W, 1) uncertainty map ->
    (indices (R, P) into H*W, cell-centred coords (R, P, 2))."""
    r, h, w, _ = uncertainty_map.shape
    idx = top_k_indices(uncertainty_map.reshape(r, h * w), min(h * w, num_points))
    xs = (idx % w).float() * (1.0 / w) + 0.5 / w
    ys = torch.div(idx, w, rounding_mode="floor").float() * (1.0 / h) + 0.5 / h
    return idx, torch.stack([xs, ys], dim=-1)


def point_coords_wrt_image(boxes: Tensor, coords: Tensor) -> Tensor:
    """Box-normalized [0,1]² -> image pixels. boxes (R, 4) xyxy, coords (R, P, 2)."""
    wh = boxes[:, None, 2:4] - boxes[:, None, 0:2]
    return coords * wh + boxes[:, None, 0:2]


def sample_fine_grained_features(feats: Sequence[Tensor], strides: Sequence[int], boxes: Tensor,
                                 coords: Tensor) -> Tensor:
    """Concat of per-level point samples at image positions -> (R, P, sum C).
    ``feats``: per-level (H, W, C) maps of ONE image; each is sampled at the
    R·P points in one call."""
    img_pts = point_coords_wrt_image(boxes, coords)  # (R, P, 2) pixels
    r, p = coords.shape[:2]
    outs = []
    for f, s in zip(feats, strides):
        h, w = f.shape[0], f.shape[1]
        norm = img_pts / (torch.tensor([w, h], dtype=torch.float32, device=f.device) * s)
        outs.append(point_sample(f[None], norm.reshape(1, r * p, 2)).reshape(r, p, -1))
    return torch.cat(outs, dim=-1)


def _clamp_border_exactly(y: Tensor, x: Tensor) -> Tensor:
    """Rewrite the output rows (columns) of the NCHW resize ``y`` of ``x``
    whose source position lies past the last input row (column) as that
    row's (column's) own interpolation, and the corner as the last input
    pixel. There both taps are one pixel, and the JAX function's fused
    multiply-adds give it exactly: a plateau of equal values, which the
    two-product form PyTorch's kernels round can break by an ulp (and
    ``find_instance_center`` would keep other maxima)."""
    (h, w), (oh, ow) = x.shape[-2:], y.shape[-2:]
    r0 = next((i for i in range(oh) if (i + 0.5) * h / oh - 0.5 > h - 1), oh)
    c0 = next((j for j in range(ow) if (j + 0.5) * w / ow - 0.5 > w - 1), ow)
    if r0 == oh and c0 == ow:
        return y
    y = y.clone()
    if r0 < oh:
        y[..., r0:, :] = F.interpolate(x[..., -1:, :], size=(1, ow), mode="bilinear", align_corners=False)
    if c0 < ow:
        y[..., :, c0:] = F.interpolate(x[..., :, -1:], size=(oh, 1), mode="bilinear", align_corners=False)
    if r0 < oh and c0 < ow:
        y[..., r0:, c0:] = x[..., -1:, -1:]
    return y


def interpolate_bilinear(x: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """torch ``F.interpolate(size=out_hw, mode='bilinear',
    align_corners=False, antialias=False)`` on (N, H, W, C), float32 out:
    plain 2-tap bilinear at half-pixel centres in both directions, never
    the letterbox's antialiased shrink; the clamped border exact, as in the
    JAX function."""
    xc = x.float().permute(0, 3, 1, 2)
    y = F.interpolate(xc, size=(int(out_hw[0]), int(out_hw[1])), mode="bilinear", align_corners=False,
                      antialias=False)
    return _clamp_border_exactly(y, xc).permute(0, 2, 3, 1)


def upsample_bilinear(x: Tensor, factor: int = 2) -> Tensor:
    """Integer-factor bilinear upsample of (N, H, W, C), float32 out:
    ``models.layers.upsample_bilinear`` (target pixel i samples source
    (i + 0.5) / factor - 0.5), the clamped border exact."""
    xc = x.float().permute(0, 3, 1, 2)
    return _clamp_border_exactly(upsample_bilinear_nchw(xc, factor), xc).permute(0, 2, 3, 1)


def upsample2x_bilinear(x: Tensor) -> Tensor:
    return upsample_bilinear(x, 2)


def _scatter_points(mask: Tensor, idx: Tensor, pts: Tensor) -> Tensor:
    """``mask`` (R, H, W, C) with the cells ``idx`` (R, P) of the flattened
    H*W replaced by ``pts`` (R, P, C); the indices of a row are distinct."""
    r, h, w, ch = mask.shape
    flat = mask.reshape(r, h * w, ch).scatter(1, idx[..., None].expand(-1, -1, ch), pts.to(mask.dtype))
    return flat.reshape(r, h, w, ch)


# ---------------------------------------------------------------------------
# heads


class StandardPointHead(nn.Module):
    """k=1 conv MLP over per-point features (R, P, C), the coarse logits
    concatenated to every layer's input. ``in_channels``: the fine
    features' channels; the coarse logits have 1 channel when
    ``cls_agnostic``, else ``num_classes``. Module names ``fc1``...,
    ``predictor``; ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int, num_classes: int = 1, fc_dim: int = 256, num_fc: int = 3,
                 cls_agnostic: bool = True, coarse_pred_each_layer: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_fc, self.coarse_pred_each_layer, self.dtype = num_fc, coarse_pred_each_layer, dtype
        out = 1 if cls_agnostic else num_classes
        cin = in_channels + out
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", Linear(cin, fc_dim))
            cin = fc_dim + (out if coarse_pred_each_layer else 0)
        self.predictor = Linear(cin, out)

    def forward(self, fine: Tensor, coarse: Tensor) -> Tensor:
        x = torch.cat([fine, coarse], dim=-1)
        for k in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x.to(self.dtype)))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], dim=-1)
        return self.predictor(x.to(self.dtype))


class ConvFCHead(nn.Module):
    """Coarse head: 1x1 channel reduce (only above ``conv_dim`` channels),
    2x2/s2 spatial reduce, FC stack, flat prediction reshaped to
    ``output_shape``. (R, side, side, in_channels) -> (R, *output_shape);
    the flatten is in the JAX module's NHWC order."""

    def __init__(self, in_channels: int, input_side: int, output_shape: tuple[int, ...] = (7, 7, 1),
                 conv_dim: int = 256, fc_dims: tuple[int, ...] = (1024, 1024), dtype=torch.float32):
        super().__init__()
        self.output_shape, self.n_fc, self.dtype = tuple(output_shape), len(fc_dims), dtype
        self.reduce_c = Conv(in_channels, conv_dim, 1) if in_channels > conv_dim else None
        self.reduce_s = Conv(conv_dim if self.reduce_c is not None else in_channels, conv_dim, 2, 2)
        cin = conv_dim * (input_side // 2) ** 2
        for k, d in enumerate(fc_dims):
            self.add_module(f"fc{k + 1}", Linear(cin, d))
            cin = d
        self.prediction = Linear(cin, math.prod(self.output_shape))

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        if self.reduce_c is not None:
            x = F.relu(self.reduce_c(x))
        x = F.relu(self.reduce_s(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for k in range(self.n_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
        return self.prediction(x).reshape((x.shape[0],) + self.output_shape)


def init_prediction(layer: Linear | Conv, generator: torch.Generator) -> None:
    """The JAX heads' ``normal(0.001)`` kernel init of a last layer."""
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) * 0.001)


class ImplicitPointHead(nn.Module):
    """Per-instance dynamic MLP: its weights come from ``parameters`` (one
    flat vector an instance: every layer's (co, ci) weight, then every
    bias), with an optional Fourier positional encoding. It has no
    parameters of its own; ``positional_encoding_gaussian_matrix`` (2, 128)
    is a buffer in Flax's ``buffers`` collection (``FLAX_BUFFERS``), drawn
    here from ``generator`` and carried from JAX by ``convert``."""

    FLAX_BUFFERS = ("positional_encoding_gaussian_matrix",)

    def __init__(self, num_classes: int = 1, channels: int = 256, num_layers: int = 3, in_channels: int = 256,
                 image_feature_enabled: bool = True, positional_encoding_enabled: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes, self.channels, self.num_layers = num_classes, channels, num_layers
        self.image_feature_enabled = image_feature_enabled
        self.positional_encoding_enabled = positional_encoding_enabled
        cin = in_channels if image_feature_enabled else 0
        if positional_encoding_enabled:
            cin += 256
            self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, 128), generator=generator))
        self.cin = cin
        self.layer_shapes = [(num_classes if i == num_layers - 1 else channels, cin if i == 0 else channels)
                             for i in range(num_layers)]  # (co, ci)
        self.num_params = sum(co * ci + co for co, ci in self.layer_shapes)

    def forward(self, fine: Tensor, coords: Tensor, parameters: Tensor) -> Tensor:
        """fine (R, P, Cf), coords (R, P, 2), parameters (R, num_params) -> (R, P, num_classes)."""
        r = fine.shape[0]
        if self.positional_encoding_enabled:
            loc = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix  # (R, P, 128)
            loc = 2.0 * math.pi * loc
            loc = torch.cat([torch.sin(loc), torch.cos(loc)], dim=-1)
            fine = torch.cat([loc, fine], dim=-1) if self.image_feature_enabled else loc
        dt = torch.promote_types(fine.dtype, parameters.dtype)
        x, parameters = fine.to(dt), parameters.to(dt)
        ws, off = [], 0
        for co, ci in self.layer_shapes:
            ws.append(parameters[:, off:off + ci * co].reshape(r, co, ci))
            off += ci * co
        for i, (co, _) in enumerate(self.layer_shapes):
            x = torch.bmm(x, ws[i].transpose(1, 2)) + parameters[:, off:off + co].reshape(r, 1, co)
            off += co
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


# ---------------------------------------------------------------------------
# losses


def roi_mask_point_loss(point_logits: Tensor, point_labels: Tensor, gt_classes: Tensor | None,
                        valid: Tensor | None = None) -> Tensor:
    """Point BCE with -1-ignore semantics: the mean over all R·P points
    (ignored ones count in the denominator), R the valid rows when
    ``valid`` masks padded instances. point_logits (R, P, C), point_labels
    (R, P) in {0, 1} or -1."""
    if point_logits.shape[-1] == 1:
        logits = point_logits[..., 0]
    else:
        idx = gt_classes.long()[:, None, None].expand(-1, point_logits.shape[1], 1)
        logits = torch.gather(point_logits, -1, idx)[..., 0]
    labels = point_labels.float()
    weight = (point_labels != -1).float()
    if valid is not None:
        weight = weight * valid[:, None].float()
    per = torch.clamp(logits, min=0) - logits * torch.clamp(labels, 0, 1) + torch.log1p(torch.exp(-torch.abs(logits)))
    p = point_labels.shape[1]
    rows = valid.float().sum() if valid is not None else torch.tensor(float(point_labels.shape[0]))
    return torch.sum(per * weight) / torch.clamp(rows.to(per.device) * p, min=1.0)


def sem_seg_point_loss(point_logits: Tensor, point_targets: Tensor, ignore_value: int = 255) -> Tensor:
    """Cross-entropy over sampled points with ``ignore_value``: (N, P, C)
    logits, (N, P) int targets."""
    valid = point_targets != ignore_value
    tgt = torch.where(valid, point_targets, torch.zeros_like(point_targets))
    logp = F.log_softmax(point_logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


# ---------------------------------------------------------------------------
# mask heads (one image's fixed-R boxes)


@dataclasses.dataclass(frozen=True)
class PointRendConfig:
    num_classes: int = 1
    cls_agnostic: bool = True
    coarse_resolution: int = 14  # ROI_MASK_HEAD.POOLER_RESOLUTION
    coarse_output_side: int = 7  # OUTPUT_SIDE_RESOLUTION
    train_num_points: int = 14 * 14
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    subdivision_steps: int = 5
    subdivision_num_points: int = 28 * 28
    point_in_strides: tuple[int, ...] = (4,)  # p2
    coarse_in_strides: tuple[int, ...] = (4,)
    fc_dim: int = 256
    num_fc: int = 3

    def _skipped(self) -> tuple[int, int]:
        """The skip-useless-subdivision rule: double the start while 4·res²
        still fits in the point budget."""
        res, steps = self.coarse_output_side, self.subdivision_steps
        while 4 * res * res <= self.subdivision_num_points and steps > 0:
            res *= 2
            steps -= 1
        return res, steps

    @property
    def init_resolution(self) -> int:
        return self._skipped()[0]

    @property
    def effective_steps(self) -> int:
        return self._skipped()[1]


def _pool(feats, boxes, cfg: PointRendConfig) -> Tensor:
    """RoI pooling by regular-grid point sampling (RoIAlign with
    sampling_ratio 1) -> (R, res, res, C)."""
    r, res = boxes.shape[0], cfg.coarse_resolution
    grid = regular_grid_coords(r, res, boxes.device)
    pooled = sample_fine_grained_features(feats, cfg.coarse_in_strides, boxes, grid)
    return pooled.reshape(r, res, res, pooled.shape[-1])


def _gt_point_labels(gt_masks: Tensor, boxes: Tensor, coords: Tensor) -> Tensor:
    """The GT bitmasks (R, Hi, Wi) bilinearly sampled at the box points."""
    h, w = gt_masks.shape[1], gt_masks.shape[2]
    norm = point_coords_wrt_image(boxes, coords) / torch.tensor([w, h], dtype=torch.float32, device=boxes.device)
    return point_sample(gt_masks[..., None].float(), norm)[..., 0]


class PointRendMaskHead(nn.Module):
    """Coarse ConvFC mask head + point-refinement head on ONE image's
    fixed-R padded boxes. ``feats``: per-level (H, W, C) maps at
    ``cfg.point_in_strides``; ``in_channels``: C.

    Train (``train=True``): -> (coarse logits (R, S, S, C), point logits
    (R, P, C), point labels (R, P)); the point selection takes ``draws``
    (:func:`point_draws`) or draws from ``generator``. Inference -> (R, M,
    M, C) refined logits by adaptive subdivision, M = init_resolution ·
    2^effective_steps. Runs on ``device`` (CUDA unless given another)."""

    def __init__(self, cfg: PointRendConfig = PointRendConfig(), in_channels: int = 256, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        out_c = 1 if cfg.cls_agnostic else cfg.num_classes
        self.coarse_head = ConvFCHead(in_channels * len(cfg.coarse_in_strides), cfg.coarse_resolution,
                                      (cfg.coarse_output_side, cfg.coarse_output_side, out_c), dtype=dtype)
        self.point_head = StandardPointHead(in_channels * len(cfg.point_in_strides), cfg.num_classes, cfg.fc_dim,
                                            cfg.num_fc, cfg.cls_agnostic, dtype=dtype)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        init_prediction(self.coarse_head.prediction, generator)
        init_prediction(self.point_head.predictor, generator)
        self.to(resolve_device(device))

    def forward(self, feats: Sequence[Tensor], boxes: Tensor, gt_masks: Tensor | None = None,
                gt_classes: Tensor | None = None, valid: Tensor | None = None, train: bool = False,
                draws: dict[str, Tensor] | None = None, generator: torch.Generator | None = None):
        c = self.cfg
        coarse = self.coarse_head(_pool(feats, boxes, c))  # (R, S, S, C)
        if not train:
            return self.subdivide(feats, boxes, coarse, gt_classes)
        coords = uncertain_point_coords_with_randomness(
            coarse.detach(), gt_classes, c.train_num_points, c.oversample_ratio, c.importance_sample_ratio,
            draws=draws, generator=generator)
        fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, coords)
        point_logits = self.point_head(fine, point_sample(coarse, coords))  # trains the coarse head too
        return coarse, point_logits, _gt_point_labels(gt_masks, boxes, coords)

    def subdivide(self, feats, boxes: Tensor, coarse: Tensor, classes: Tensor | None) -> Tensor:
        """Adaptive subdivision inference from the coarse logits."""
        c = self.cfg
        r, res = boxes.shape[0], c.init_resolution
        grid = regular_grid_coords(r, res, boxes.device)
        fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, grid)
        mask = self.point_head(fine, point_sample(coarse, grid)).reshape(r, res, res, -1)
        for _ in range(c.effective_steps):
            mask = self.subdivision_step(feats, boxes, coarse, classes, mask)
        return mask

    def subdivision_step(self, feats, boxes: Tensor, coarse: Tensor, classes: Tensor | None, mask: Tensor) -> Tensor:
        """One step: upsample 2x, re-predict the most uncertain cells."""
        c = self.cfg
        mask = upsample2x_bilinear(mask)
        idx, coords = uncertain_point_coords_on_grid(calculate_uncertainty(mask, classes), c.subdivision_num_points)
        fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, coords)
        return _scatter_points(mask, idx, self.point_head(fine, point_sample(coarse, coords)))


class ImplicitPointRendMaskHead(nn.Module):
    """Implicit PointRend on ONE image's fixed-R boxes: a ConvFCHead
    (``parameter_head``) predicts each instance's MLP parameters, the
    point head evaluates that MLP at query points. Train -> (point logits,
    point labels, l2 of the parameters); the points are ``draws["coords"]``
    (R, train_num_points, 2) or uniform draws from ``generator``. Inference
    runs the subdivision from a sqrt(P) grid for ``subdivision_steps``."""

    def __init__(self, cfg: PointRendConfig = PointRendConfig(), in_channels: int = 256, params_l2: float = 0.00001,
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.params_l2 = cfg, params_l2
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.point_head = ImplicitPointHead(1 if cfg.cls_agnostic else cfg.num_classes, cfg.fc_dim, cfg.num_fc + 1,
                                            in_channels, generator=generator)
        self.parameter_head = ConvFCHead(in_channels * len(cfg.coarse_in_strides), cfg.coarse_resolution,
                                         (self.point_head.num_params,), dtype=dtype)
        init_params(self, generator)
        init_prediction(self.parameter_head.prediction, generator)
        self.to(resolve_device(device))

    def forward(self, feats: Sequence[Tensor], boxes: Tensor, gt_masks: Tensor | None = None,
                valid: Tensor | None = None, train: bool = False, classes: Tensor | None = None,
                draws: dict[str, Tensor] | None = None, generator: torch.Generator | None = None):
        c = self.cfg
        if not train and not c.cls_agnostic and c.num_classes > 1 and classes is None:
            raise ValueError("ImplicitPointRendMaskHead inference with cls_agnostic=False needs per-instance "
                             "`classes` to select the foreground channel")
        params = self.parameter_head(_pool(feats, boxes, c))  # (R, num_params)
        r = boxes.shape[0]
        if train:
            coords = draws["coords"] if draws is not None else torch.rand(
                (r, c.train_num_points, 2), generator=generator, device=boxes.device)
            fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, coords)
            logits = self.point_head(fine, coords, params)
            return logits, _gt_point_labels(gt_masks, boxes, coords), self.params_l2 * torch.mean(params ** 2)
        res = math.isqrt(c.subdivision_num_points)
        grid = regular_grid_coords(r, res, boxes.device)
        fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, grid)
        mask = self.point_head(fine, grid, params).reshape(r, res, res, -1)
        for _ in range(c.subdivision_steps):
            mask = self.subdivision_step(feats, boxes, params, classes, mask)
        return mask

    def subdivision_step(self, feats, boxes: Tensor, params: Tensor, classes: Tensor | None, mask: Tensor) -> Tensor:
        """One step: upsample 2x, re-evaluate the most uncertain cells."""
        c = self.cfg
        mask = upsample2x_bilinear(mask)
        idx, coords = uncertain_point_coords_on_grid(calculate_uncertainty(mask, classes), c.subdivision_num_points)
        fine = sample_fine_grained_features(feats, c.point_in_strides, boxes, coords)
        return _scatter_points(mask, idx, self.point_head(fine, coords, params))


# ---------------------------------------------------------------------------
# semantic-seg variant


class PointRendSemSegHead(nn.Module):
    """Point refinement of a coarse semantic-seg head's logits. ``forward(
    coarse_logits (N, Hc, Wc, C), fine_feats [(N, H, W, Cf) at in_strides],
    targets (N, Hi, Wi) int, train)``: train -> (None, point CE loss) on
    points chosen by ``draws`` (:func:`point_draws`) or ``generator``;
    inference -> (logits upsampled ``subdivision_steps`` times, None).
    ``in_channels``: the fine maps' channels together."""

    def __init__(self, num_classes: int, in_channels: int, in_strides: tuple[int, ...] = (4,),
                 train_num_points: int = 2048, oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
                 subdivision_steps: int = 2, subdivision_num_points: int = 8192, ignore_value: int = 255,
                 fc_dim: int = 256, num_fc: int = 3, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes, self.in_strides = num_classes, in_strides
        self.train_num_points, self.oversample_ratio = train_num_points, oversample_ratio
        self.importance_sample_ratio, self.ignore_value = importance_sample_ratio, ignore_value
        self.subdivision_steps, self.subdivision_num_points = subdivision_steps, subdivision_num_points
        self.point_head = StandardPointHead(in_channels, num_classes, fc_dim, num_fc, cls_agnostic=False, dtype=dtype)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        init_prediction(self.point_head.predictor, generator)
        self.to(resolve_device(device))

    def forward(self, coarse_logits: Tensor, fine_feats: Sequence[Tensor], targets: Tensor | None = None,
                train: bool = False, draws: dict[str, Tensor] | None = None,
                generator: torch.Generator | None = None):
        if train:
            coords = uncertain_point_coords_with_randomness(
                coarse_logits.detach(), None, self.train_num_points, self.oversample_ratio,
                self.importance_sample_ratio, uncertainty_fn=sem_seg_uncertainty, draws=draws, generator=generator)
            fine = torch.cat([point_sample(f, coords) for f in fine_feats], dim=-1)
            logits = self.point_head(fine, point_sample(coarse_logits, coords))
            tgt = point_sample_nearest(targets[..., None].float(), coords)[..., 0].long()
            return None, sem_seg_point_loss(logits, tgt, self.ignore_value)
        sem = coarse_logits
        for _ in range(self.subdivision_steps):
            sem = self.subdivision_step(coarse_logits, fine_feats, sem)
        return sem, None

    def subdivision_step(self, coarse_logits: Tensor, fine_feats: Sequence[Tensor], sem: Tensor) -> Tensor:
        """One step: upsample 2x, re-predict the most uncertain pixels."""
        sem = upsample2x_bilinear(sem)
        idx, coords = uncertain_point_coords_on_grid(sem_seg_uncertainty(sem), self.subdivision_num_points)
        fine = torch.cat([point_sample(f, coords) for f in fine_feats], dim=-1)
        return _scatter_points(sem, idx, self.point_head(fine, point_sample(coarse_logits, coords)))
