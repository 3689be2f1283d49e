"""ROIAlign: the FPN pooler (K2) and the single-level op (K3), windowed or not.

Port of ``spacecraft_pose_estimation_tpu/ops/pallas_pooler.py`` with its
semantics (``level_mats`` / ``window_matrices``): aligned ROIAlign whose
taps are limited to a (window, window + 8) read window per box, its x
origin rounded down to a multiple of 8. K2 also takes the read window of
the JAX package's windowed XLA pooler (``ops/roi_align.py:101``,
``roi_align_windowed``: (window, window), no rounding), the one its
trainer differentiates: ``impl="windowed"``. The two pick the same taps
wherever a box fits the window and the x origin needs no rounding; near
the right edge of a map whose width less (window + 8) is not a multiple of
8 (P3 at 800^2: 100 columns), the Pallas window drops the last columns.
``impl="gather"`` is the JAX package's default pooler, the bilinear
gather over the whole level (``ops/roi_align.py:194``,
``multilevel_roi_align(impl="gather")``), which the mask and keypoint heads
and the cascade's stages call: every tap of the box on its level counts,
the level's own extent bounds the reads. :func:`roi_align` is that
gather's single-map ROIAlign (``ops/roi_align.py:49``) in plain PyTorch:
the mask head's GT crops run it on one-channel bitmasks, which no kernel
takes (K3 reads 8 channels at a time).

* :func:`roi_align_multilevel` (``multilevel_roi_align_pallas``): per-box
  level assignment, one pass over all images, kernel K2; differentiable in
  the features: on CUDA tensors its gradient is a kernel of its own,
  :func:`roi_align_multilevel_backward`
  (``csrc/roi_align_multilevel_backward.cu``), which no TPU kernel has: it
  is the gradient of the windowed XLA pooler the JAX trainer
  differentiates (``ops/roi_align.py:194``);
* :func:`roi_align_single` (``roi_align_pallas``): one (H, W, C) map, any
  spatial scale, kernel K3. Nothing in the JAX package calls it; it is
  held to ``roi_align_windowed``.

K3 is K2's kernel with one level, the caller's scale and no level
assignment: on a map smaller than the window, K3's shrunk window and K2's
padded one pick the same taps, so both entries of
``csrc/roi_align_multilevel.cu`` launch one kernel. The ``*_plain``
functions compute the same in eager PyTorch and are taken for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from types import SimpleNamespace

import torch

from .. import _cuda
from .boxes import box_area

Tensor = torch.Tensor

KERNEL = _cuda.Kernel(
    "roi_align_multilevel", "roi_align_multilevel.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
BACKWARD = _cuda.Kernel(
    "roi_align_multilevel_backward", "roi_align_multilevel_backward.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
SINGLE = _cuda.Kernel(
    "roi_align_single", "roi_align_multilevel.cu",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
# K2's and K2b's launches in the gather read (the heads' and the cascade's),
# counted where they launch, beside KERNEL's and BACKWARD's, which count them all
GATHER = SimpleNamespace(launches=0)
GATHER_BACKWARD = SimpleNamespace(launches=0)
MAX_LEVELS = 4
MAX_SAMPLES = 64  # output_size * sampling_ratio, per axis
# the reads of the JAX package's three poolers, by K2's read code: the two
# windowed ones (the box heads take these) and the unwindowed gather
READS = {"windowed": 0, "pallas": 1, "gather": 2}


def assign_levels(boxes: Tensor, num_levels: int, lvl_min: int,
                  canonical_size: float = 224.0, canonical_level: int = 4) -> Tensor:
    """Pyramid level index in [0, num_levels) per box (pallas_pooler.py:165-171)."""
    areas = box_area(boxes)
    target = torch.floor(canonical_level + torch.log2(torch.sqrt(areas) / canonical_size + 1e-8))
    target = torch.clamp(target, lvl_min, lvl_min + num_levels - 1)
    return target.to(torch.int64) - lvl_min


def check_window_covers(level_hw, canonical_size, canonical_level, window):
    """Warn when ``window`` cannot hold the largest box a level can get
    (roi_align._check_window_covers): such boxes lose their outer taps."""
    mid_extent = int(math.ceil(2.0 * canonical_size / (2 ** canonical_level))) + 2
    coarse_extent = max(level_hw[-1]) + 2
    worst = max(mid_extent, coarse_extent)
    if window < worst:
        warnings.warn(
            f"windowed ROI pooler: window={window} cannot cover the worst-case box "
            f"extent ({worst} cells at the coarsest level {tuple(level_hw[-1])}); "
            "oversized boxes will lose outer bilinear taps",
            stacklevel=3,
        )


def _axis_taps(coord: Tensor, limit: int, origin: Tensor, win: int):
    """Two taps (index, weight) per sample coordinate, window-masked.

    coord (R, M), origin (R,) -> k (R, M, 2) int64, w (R, M, 2) float32.
    """
    inb = (coord > -1.0) & (coord < limit)
    cc = torch.clamp(coord, 0.0, limit - 1)
    k0 = torch.floor(cc)
    rel = cc - origin[:, None].to(torch.float32)
    kk = k0[..., None] + torch.tensor([0.0, 1.0], device=coord.device)
    local = kk - origin[:, None, None].to(torch.float32)
    w = torch.clamp(1.0 - torch.abs(rel[..., None] - local), min=0.0)
    ok = inb[..., None] & (local >= 0) & (local < win) & (kk < limit)
    return torch.where(ok, kk, 0.0).to(torch.int64), torch.where(ok, w, 0.0)


def window_taps(boxes: Tensor, h: int, w: int, spatial_scale: float, output_size: int,
                sampling_ratio: int, win_h: int, win_w: int, round_x8: bool = True):
    """Taps of boxes (n, 4) on one (h, w) map at ``spatial_scale``:
    ((ky, wy), (kx, wx)), each (n, P*S, 2), limited to a (win_h, win_w)
    read window per box whose origin is clamped to the map (to 0 where the
    map is smaller) and, along x with ``round_x8``, rounded down to a
    multiple of 8."""
    p, s = output_size, sampling_ratio
    # divisors as device tensors: PyTorch's CUDA division by a Python
    # number multiplies by its reciprocal, which rounds other than a / p
    p_t, s_t = (torch.tensor(float(v), device=boxes.device) for v in (p, s))
    grid = (torch.arange(p, device=boxes.device)[:, None]
            + (torch.arange(s, device=boxes.device)[None, :] + 0.5) / s_t).reshape(-1)
    x0, y0, x1, y1 = (boxes * spatial_scale - 0.5).unbind(-1)
    sy = y0[:, None] + grid[None, :] * (y1 - y0)[:, None] / p_t
    sx = x0[:, None] + grid[None, :] * (x1 - x0)[:, None] / p_t
    oy = torch.clamp(torch.floor(y0).to(torch.int64) - 1, 0, max(h - win_h, 0))
    ox = torch.clamp(torch.floor(x0).to(torch.int64) - 1, 0, max(w - win_w, 0))
    if round_x8:
        ox = (ox // 8) * 8
    return _axis_taps(sy, h, oy, win_h), _axis_taps(sx, w, ox, win_w)


def level_taps(boxes: Tensor, h: int, w: int, stride: int, output_size: int,
               sampling_ratio: int, window: int, impl: str = "pallas"):
    """K2's taps of boxes (n, 4) on one (h, w) level: ``"pallas"``, the
    (window, window + 8) read window of the level padded up to it
    (pallas_pooler.py:213-218); ``"windowed"``, the (window, window) one of
    ``roi_align_windowed`` (its ``min(window, w)`` slice from an origin
    clamped to 0 where the map is smaller picks the same taps);
    ``"gather"``, every tap on the level (``_bilinear``, ops/roi_align.py:22:
    a window of the whole level, at origin 0)."""
    if impl == "gather":
        return window_taps(boxes, h, w, 1.0 / stride, output_size, sampling_ratio, h, w, round_x8=False)
    pallas = impl == "pallas"
    return window_taps(boxes, h, w, 1.0 / stride, output_size, sampling_ratio, window,
                       window + 8 if pallas else window, round_x8=pallas)


def single_taps(boxes: Tensor, h: int, w: int, spatial_scale: float, output_size: int,
                sampling_ratio: int, window: int):
    """K3's taps of boxes (n, 4) on an (h, w) map: the (min(window, h),
    min(window + 8, w)) read window of ``window_matrices``
    (pallas_pooler.py:55-62)."""
    return window_taps(boxes, h, w, spatial_scale, output_size, sampling_ratio,
                       min(window, h), min(window + 8, w))


def _pool(flat: Tensor, base: Tensor, w: int, taps, p: int, s: int) -> Tensor:
    """(n, P, P, C) f32 bins from the (rows, C) cells of ``flat`` under the
    taps of n boxes whose map starts at row ``base`` (n,) of ``flat``."""
    (ky, wy), (kx, wx) = taps  # (n, P*S, 2)
    c = flat.shape[-1]
    idx = (base[:, None, None, None, None] + ky[:, :, :, None, None] * w
           + kx[:, None, None, :, :])  # (n, PSy, 2, PSx, 2)
    vals = flat[idx].to(torch.float32)  # (n, PSy, 2, PSx, 2, C)
    # x taps first, then y taps, then the S x S mean, as the kernels sum
    xsum = (vals * wx[:, None, None, :, :, None]).sum(-2)  # (n, PSy, 2, PSx, C)
    ysum = (xsum * wy[:, :, :, None, None]).sum(2)  # (n, PSy, PSx, C)
    return ysum.reshape(-1, p, s, p, s, c).sum((2, 4)) * (1.0 / (s * s))


def roi_align_multilevel_plain(
    feats: list[Tensor], boxes: Tensor, batch_idx: Tensor, output_size: int,
    strides: tuple[int, ...], sampling_ratio: int = 2, window: int = 48,
    canonical_size: float = 224.0, canonical_level: int = 4, impl: str = "pallas",
) -> Tensor:
    """Plain PyTorch K2. feats: per level (B, H_l, W_l, C); boxes (R, 4);
    batch_idx (R,) -> (R, P, P, C) float32; ``impl`` the read (``READS``)."""
    p, s = output_size, sampling_ratio
    r, c = boxes.shape[0], feats[0].shape[-1]
    lvl_min = int(math.log2(strides[0]))
    levels = assign_levels(boxes, len(feats), lvl_min, canonical_size, canonical_level)
    out = torch.zeros((r, p, p, c), dtype=torch.float32, device=boxes.device)
    for li, (f, stride) in enumerate(zip(feats, strides)):
        sel = torch.nonzero(levels == li).flatten()
        if sel.numel() == 0:
            continue
        h, w = f.shape[1], f.shape[2]
        taps = level_taps(boxes[sel], h, w, stride, p, s, window, impl)
        out[sel] = _pool(f.reshape(-1, c), batch_idx[sel].to(torch.int64) * (h * w), w, taps, p, s)
    return out


def _check_pyramid(shapes, dtype, strides, output_size, sampling_ratio, impl) -> int:
    """Raise on what K2 and its backward do not take; returns lvl_min."""
    if impl not in READS:
        raise ValueError(f"impl must be one of {tuple(READS)}, got {impl!r}")
    num_levels = len(shapes)
    lvl_min = int(math.log2(strides[0]))
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"roi_align_multilevel takes 1..{MAX_LEVELS} levels, got {num_levels}")
    if tuple(strides) != tuple(2 ** (lvl_min + i) for i in range(num_levels)):
        raise ValueError(f"strides must be consecutive powers of two, got {strides}")
    if output_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"output_size * sampling_ratio must be <= {MAX_SAMPLES}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats: expected float32 or bfloat16, got {dtype}")
    b, c = shapes[0][0], shapes[0][-1]
    if any(len(sh) != 4 or sh[0] != b or sh[-1] != c for sh in shapes):
        raise ValueError("all levels need the same dtype, batch and channels")
    if c % 8:
        raise ValueError(f"roi_align_multilevel reads 8 channels at a time: C must be a multiple of 8, got {c}")
    return lvl_min


def _check_boxes(boxes: Tensor, batch_idx: Tensor) -> None:
    _cuda.check_cuda_tensor("boxes", boxes, torch.float32, 2)
    _cuda.check_cuda_tensor("batch_idx", batch_idx, torch.int32, 1)
    if boxes.shape[1] != 4 or batch_idx.shape[0] != boxes.shape[0]:
        raise ValueError(f"boxes {tuple(boxes.shape)} and batch_idx {tuple(batch_idx.shape)} disagree")


def _forward_kernel(feats, boxes, batch_idx, output_size, strides, sampling_ratio, window,
                    canonical_size, canonical_level, impl) -> Tensor:
    dtype = feats[0].dtype
    for i, f in enumerate(feats):
        _cuda.check_cuda_tensor(f"feats[{i}]", f, (torch.float32, torch.bfloat16), 4)
        if f.dtype != dtype:
            raise ValueError("all levels need the same dtype, batch and channels")
        if f.data_ptr() % 16:
            raise ValueError(f"feats[{i}]: expected a tensor starting on a 16-byte boundary")
    _check_boxes(boxes, batch_idx)
    lvl_min = _check_pyramid([tuple(f.shape) for f in feats], dtype, strides, output_size, sampling_ratio, impl)
    r, c, num_levels = boxes.shape[0], feats[0].shape[-1], len(feats)
    out = torch.empty((r, output_size, output_size, c), dtype=torch.float32, device=boxes.device)
    padded = list(feats) + [feats[-1]] * (MAX_LEVELS - num_levels)
    hw = [d for f in padded for d in (f.shape[1], f.shape[2])]
    KERNEL.launch(
        *[_cuda.ptr(f) for f in padded], *hw, num_levels, lvl_min,
        int(dtype == torch.bfloat16), _cuda.ptr(boxes), _cuda.ptr(batch_idx), _cuda.ptr(out),
        r, c, output_size, sampling_ratio, window, READS[impl], float(canonical_size), canonical_level,
    )
    if impl == "gather":
        GATHER.launches += 1
    return out


def roi_align_multilevel_backward(
    grad_out: Tensor, shapes: list[tuple[int, ...]], dtype: torch.dtype, boxes: Tensor, batch_idx: Tensor,
    output_size: int, strides: tuple[int, ...], sampling_ratio: int = 2, window: int = 48,
    canonical_size: float = 224.0, canonical_level: int = 4, impl: str = "pallas",
) -> list[Tensor]:
    """K2's backward on the card: the gradient of :func:`roi_align_multilevel`
    with respect to each level's features, from ``grad_out`` (R, P, P, C).

    ``shapes`` are the levels' (B, H_l, W_l, C) and ``dtype`` their type
    (the gradient's). The gradient does not depend on the features' values:
    the op is linear in them. A first pass writes each ROI's footprint (its
    level, image and the cells its nonzero taps span) and its folded tap
    weights into an int32 scratch; then each warp owns a column of 8 cells
    of one level of one image and 256 channels, sums the ROIs that touch it
    in float32 registers and writes it once in ``dtype``, the same bits on
    every call. CUDA tensors only: there is no fallback.
    """
    _cuda.check_cuda_tensor("grad_out", grad_out, torch.float32, 4)
    if grad_out.data_ptr() % 16:
        raise ValueError("grad_out: expected a tensor starting on a 16-byte boundary")
    _check_boxes(boxes, batch_idx)
    lvl_min = _check_pyramid([tuple(sh) for sh in shapes], dtype, strides, output_size, sampling_ratio, impl)
    r, c, num_levels = boxes.shape[0], shapes[0][-1], len(shapes)
    if tuple(grad_out.shape) != (r, output_size, output_size, c):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not ({r}, {output_size}, {output_size}, {c})")
    dev = boxes.device
    outs = [torch.empty(tuple(sh), dtype=dtype, device=dev) for sh in shapes]
    # each ROI's footprint (4 words) and table (csrc's Table(P, span)): its
    # bins' spans, then Ay and Ax over its read window at an 8-aligned origin;
    # the gather reads a whole level, so its span is the largest level side
    span = max(max(sh[1], sh[2]) for sh in shapes) if impl == "gather" else window
    up = lambda v, m: (v + m - 1) // m * m
    table = up(2 * output_size, 4) + output_size * (up(span + 15, 8) + up(span + 15, 4))
    scratch = torch.empty(r * (4 + table), dtype=torch.int32, device=dev)
    pad = lambda ts: list(ts) + [ts[-1]] * (MAX_LEVELS - num_levels)
    hw = [d for sh in pad(shapes) for d in (sh[1], sh[2])]
    BACKWARD.launch(
        _cuda.ptr(grad_out), *[_cuda.ptr(t) for t in pad(outs)], _cuda.ptr(scratch), *hw,
        shapes[0][0], num_levels, lvl_min, int(dtype == torch.bfloat16), _cuda.ptr(boxes), _cuda.ptr(batch_idx),
        r, c, output_size, sampling_ratio, window, READS[impl], float(canonical_size), canonical_level,
    )
    if impl == "gather":
        GATHER_BACKWARD.launches += 1
    return outs


def roi_align_multilevel_backward_plain(
    grad_out: Tensor, shapes: list[tuple[int, ...]], dtype: torch.dtype, boxes: Tensor, batch_idx: Tensor,
    output_size: int, strides: tuple[int, ...], sampling_ratio: int = 2, window: int = 48,
    canonical_size: float = 224.0, canonical_level: int = 4, impl: str = "pallas",
) -> list[Tensor]:
    """Plain PyTorch K2 backward: autograd of :func:`roi_align_multilevel_plain`
    on float32 features of ``shapes``, summed in float32 and cast to
    ``dtype``, as the kernel does."""
    feats = [torch.zeros(tuple(sh), dtype=torch.float32, device=boxes.device, requires_grad=True) for sh in shapes]
    with torch.enable_grad():
        out = roi_align_multilevel_plain(feats, boxes, batch_idx, output_size, strides, sampling_ratio, window,
                                         canonical_size, canonical_level, impl)
        grads = torch.autograd.grad(out, feats, grad_out, allow_unused=True)  # a level no box pools from: None
    return [(torch.zeros_like(f) if g is None else g).to(dtype) for f, g in zip(feats, grads)]


class _RoIAlignMultilevel(torch.autograd.Function):
    """K2 forward, K2 backward: the features get a gradient, the boxes and
    ``batch_idx`` none (the JAX trainer stops the gradient through the
    proposals, ``models/rcnn.py:191``)."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, args, *feats):
        ctx.save_for_backward(boxes, batch_idx)
        ctx.args = args
        ctx.shapes = [tuple(f.shape) for f in feats]
        ctx.dtype = feats[0].dtype
        return _forward_kernel(feats, boxes, batch_idx, *args)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, batch_idx = ctx.saved_tensors
        grads = roi_align_multilevel_backward(grad_out.contiguous(), ctx.shapes, ctx.dtype, boxes, batch_idx,
                                              *ctx.args)
        return (None, None, None, *grads)


def roi_align_multilevel(
    feats: list[Tensor], boxes: Tensor, batch_idx: Tensor, output_size: int,
    strides: tuple[int, ...], sampling_ratio: int = 2, window: int = 48,
    canonical_size: float = 224.0, canonical_level: int = 4, impl: str = "pallas",
) -> Tensor:
    """FPN ROIAlign: (R, P, P, C) float32 from per-level NHWC features.

    feats: fine-to-coarse list of (B, H_l, W_l, C), float32 or bfloat16,
    strides consecutive powers of two; boxes (R, 4) XYXY image pixels;
    batch_idx (R,) image of each box. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors launch K2, one block per (box,
    output row) and one warp per bin, each lane reading 8 channels as one
    16-byte vector: C must be a multiple of 8 and every level 16-byte
    aligned. On CUDA tensors the features' gradient, where autograd asks for
    it, is K2's backward kernel (:func:`roi_align_multilevel_backward`).
    ``impl``: the read, the Pallas pooler's or the windowed one's read
    window, or ``"gather"``, the whole level (``window`` unused).
    """
    if impl != "gather":
        check_window_covers([tuple(f.shape[1:3]) for f in feats], canonical_size, canonical_level, window)
    if boxes.device.type == "cpu":
        return roi_align_multilevel_plain(
            feats, boxes, batch_idx, output_size, strides, sampling_ratio, window,
            canonical_size, canonical_level, impl,
        )
    args = (output_size, tuple(strides), sampling_ratio, window, canonical_size, canonical_level, impl)
    return _RoIAlignMultilevel.apply(boxes, batch_idx, args, *feats)


# --------------------------------------------------------------------------- K3


def roi_align_single_plain(feat: Tensor, boxes: Tensor, output_size: int, spatial_scale: float,
                           sampling_ratio: int = 2, window: int = 48) -> Tensor:
    """Plain PyTorch K3. feat (H, W, C); boxes (R, 4) -> (R, P, P, C) float32."""
    h, w, c = feat.shape
    taps = single_taps(boxes, h, w, spatial_scale, output_size, sampling_ratio, window)
    base = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    return _pool(feat.reshape(-1, c), base, w, taps, output_size, sampling_ratio)


def roi_align_single(feat: Tensor, boxes: Tensor, output_size: int, spatial_scale: float,
                     sampling_ratio: int = 2, window: int = 48) -> Tensor:
    """Single-level windowed ROIAlign (K3): (R, P, P, C) float32.

    feat (H, W, C) NHWC float32 or bfloat16, one image; boxes (R, 4) XYXY
    image pixels, mapped by ``spatial_scale`` (any float, not only
    1 / stride); each box reads its (min(window, H), min(window + 8, W))
    window, as ``roi_align_pallas`` does. CPU tensors take the plain
    version, which takes any C; CUDA tensors launch K2's kernel on one
    level (a block per (box, output row), a warp per bin, each lane reading
    8 channels as one 16-byte vector): C must be a multiple of 8 and
    ``feat`` 16-byte aligned.
    """
    if boxes.device.type == "cpu":
        return roi_align_single_plain(feat, boxes, output_size, spatial_scale, sampling_ratio, window)
    if output_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"output_size * sampling_ratio must be <= {MAX_SAMPLES}")
    _cuda.check_cuda_tensor("feat", feat, (torch.float32, torch.bfloat16), 3)
    _cuda.check_cuda_tensor("boxes", boxes, torch.float32, 2)
    if boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (R, 4), got {tuple(boxes.shape)}")
    h, w, c = feat.shape
    if c % 8:
        raise ValueError(f"roi_align_single reads 8 channels at a time: C must be a multiple of 8, got {c}")
    if feat.data_ptr() % 16:
        raise ValueError("feat: expected a tensor starting on a 16-byte boundary")
    r = boxes.shape[0]
    out = torch.empty((r, output_size, output_size, c), dtype=torch.float32, device=boxes.device)
    SINGLE.launch(_cuda.ptr(feat), h, w, c, int(feat.dtype == torch.bfloat16), _cuda.ptr(boxes), _cuda.ptr(out),
                  r, output_size, float(spatial_scale), sampling_ratio, window)
    return out


# ------------------------------------------------------------ whole-map ROIAlign


def roi_align_maps(maps: Tensor, map_idx: Tensor, boxes: Tensor, output_size: int, spatial_scale: float,
                   sampling_ratio: int = 2) -> Tensor:
    """Aligned ROIAlign of box r on map ``map_idx[r]`` of ``maps`` (N, H, W, C), any
    dtype (a bool bitmask reads as 0 / 1): (R, P, P, C) float32, every tap on
    the map (the JAX ``roi_align``, ops/roi_align.py:49-98, one map per box,
    in its arithmetic: each sample's four corners weighted as ``_bilinear``
    weighs them, a sample outside (-1, size) 0, then the S x S mean). Plain
    PyTorch on any device: the taps are gathered from the maps where they
    lie, so no per-box copy of a map is made."""
    _, h, w, c = maps.shape
    p, s = output_size, sampling_ratio
    dev = boxes.device
    p_t, s_t = (torch.tensor(float(v), device=dev) for v in (p, s))
    grid = (torch.arange(p, device=dev)[:, None] + (torch.arange(s, device=dev)[None, :] + 0.5) / s_t).reshape(-1)
    x0, y0, x1, y1 = (boxes.to(torch.float32) * spatial_scale - 0.5).unbind(-1)
    bw, bh = x1 - x0, y1 - y0
    sy = (y0[:, None] + grid[None, :] * (bh / p_t)[:, None])[:, :, None]  # (R, PS, 1)
    sx = (x0[:, None] + grid[None, :] * (bw / p_t)[:, None])[:, None, :]  # (R, 1, PS)
    inb = (sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)
    sy, sx = torch.clamp(sy, 0.0, h - 1), torch.clamp(sx, 0.0, w - 1)
    ky0, kx0 = torch.floor(sy).to(torch.int64), torch.floor(sx).to(torch.int64)
    ky1, kx1 = torch.clamp(ky0 + 1, max=h - 1), torch.clamp(kx0 + 1, max=w - 1)
    fy, fx = (sy - ky0)[..., None], (sx - kx0)[..., None]
    flat = maps.reshape(-1, c)
    base = (map_idx.to(torch.int64) * (h * w))[:, None, None]
    at = lambda ky, kx: flat[base + ky * w + kx].to(torch.float32)  # (R, PS, PS, C)
    v = (at(ky0, kx0) * (1 - fy) * (1 - fx) + at(ky0, kx1) * (1 - fy) * fx
         + at(ky1, kx0) * fy * (1 - fx) + at(ky1, kx1) * fy * fx) * inb[..., None]
    v = v.reshape(-1, p, s, p, s, c)
    acc = v[:, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = acc + v[:, :, i, :, j]
    return acc / (s * s)

