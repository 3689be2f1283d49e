"""Axis-aligned bilinear crop of uint8 frames (zero border), and the window clamp.

Port of the serving crop of ``spacecraft_pose_estimation_tpu``: the
windowed paths ``ops/warp.crop_and_resize_mxu_windowed`` (XLA) and
``ops/pallas_crop.crop_and_resize_window`` (Pallas) both equal the
full-frame ``ops/warp.crop_and_resize_mxu`` once the crop scale is clamped
to the window's coverage (:func:`clamp_scales_to_window`). So the port has
one crop, kernel K1 (``csrc/crop_bilinear.cu``), which samples the frame
directly; :func:`crop_bilinear_plain` is the same function in eager
PyTorch, taken for CPU tensors. Both sit behind one registered operator,
``torch.ops.spe_port.crop_bilinear`` (:data:`crop_bilinear_op`), so that
``torch.export`` records the crop as one node (``tools/export_model.py``).

Training crops at a random rotation, which is not separable: that is the
JAX package's gather path (``ops/warp.affine_warp`` and the rotated
``crop_and_resize``, which ``batched_crop_and_resize`` takes whenever the
rotations are traced), an XLA gather and not a Pallas kernel. Here it is
:func:`affine_warp` and :func:`rotated_crop_and_resize`, plain tensor
code on any device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from . import geometry

Tensor = torch.Tensor

_ALIGN_Y = 32  # the Pallas window's row alignment (pallas_crop.py:41)
_ALIGN_X = 128  # and column alignment, in pixels

KERNEL = _cuda.Kernel(
    "crop_bilinear", "crop_bilinear.cu",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


def window_coverage(window: tuple[int, int]) -> tuple[int, int]:
    """Usable (h, w) of the Pallas DMA window after alignment slack and the
    bilinear +1 tap (pallas_crop.py:45-49)."""
    wh, ww = window
    return wh - _ALIGN_Y - 1, ww - _ALIGN_X - 1


def clamp_scales_to_window(
    scales: Tensor, out_size: tuple[int, int], window: tuple[int, int],
    coverage: tuple[int, int] | None = None,
) -> Tensor:
    """Shrink (B, 2) scales so the square source crop fits the coverage.

    ``coverage`` defaults to :func:`window_coverage`; the XLA window path
    uses (window - 2) on each axis (pipeline.py:86-92).
    """
    cov_h, cov_w = coverage if coverage is not None else window_coverage(window)
    out_w, out_h = out_size
    smax_x = cov_w / geometry.PIXEL_STD
    smax_y = cov_h / geometry.PIXEL_STD * (out_w / max(out_h, 1))
    factor = torch.clamp(
        min(smax_x, smax_y) / torch.clamp(scales[:, :1], min=1e-6), max=1.0
    )
    return scales * factor


def crop_params(centers: Tensor, scales: Tensor, out_size: tuple[int, int]) -> Tensor:
    """(B, 4) [ax, bx, ay, by]: source x = ax * x + bx, y = ay * y + by.

    The rot=0 entries of ``geometry.crop_affine_matrix(inv=True)``.
    """
    M = geometry.crop_affine_matrix(centers, scales, 0.0, out_size, inv=True)
    return torch.stack([M[:, 0, 0], M[:, 0, 2], M[:, 1, 1], M[:, 1, 2]], dim=-1).contiguous()


def crop_bilinear_plain(frames: Tensor, params: Tensor, out_size: tuple[int, int]) -> Tensor:
    """Plain PyTorch K1: (B, H, W, 3) frames, (B, 4) params -> (B, OH, OW, 3) f32."""
    b, h, w, _ = frames.shape
    out_w, out_h = int(out_size[0]), int(out_size[1])
    dev = frames.device
    xs = params[:, 0:1] * torch.arange(out_w, dtype=torch.float32, device=dev) + params[:, 1:2]
    ys = params[:, 2:3] * torch.arange(out_h, dtype=torch.float32, device=dev) + params[:, 3:4]

    def taps(s: Tensor, size: int):
        k0 = torch.floor(s)
        k = k0[..., None] + torch.tensor([0.0, 1.0], device=dev)  # (B, n, 2)
        wgt = torch.clamp(1.0 - torch.abs(s[..., None] - k), min=0.0)
        ok = (k >= 0) & (k < size) & ((s > -1.0) & (s < size))[..., None]
        return torch.where(ok, k, 0.0).to(torch.int64), torch.where(ok, wgt, 0.0)

    kx, wx = taps(xs, w)  # (B, OW, 2)
    ky, wy = taps(ys, h)  # (B, OH, 2)
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    vals = frames[bi, ky[:, :, :, None, None], kx[:, None, None, :, :]].to(torch.float32)
    # (B, OH, 2, OW, 2, 3): x taps first, as the separable crop contracts W first
    rows = (vals * wx[:, None, None, :, :, None]).sum(-2)
    return (rows * wy[:, :, :, None, None]).sum(2)


# K1's operator, defined through ``torch.library.Library`` rather than
# ``torch.library.custom_op``: the same schema and one node under
# ``torch.export``, without custom_op's Python autograd and aliasing layers
# on every call (PERF.md: the host's cost of one K1 call).
_LIB = torch.library.Library("spe_port", "DEF")
_LIB.define("crop_bilinear(Tensor frames, Tensor params, SymInt out_w, SymInt out_h) -> Tensor")


def _crop_bilinear_cpu(frames: Tensor, params: Tensor, out_w: int, out_h: int) -> Tensor:
    """The CPU implementation of ``torch.ops.spe_port.crop_bilinear``: the plain version."""
    return crop_bilinear_plain(frames, params, (out_w, out_h))


def _crop_bilinear_cuda(frames: Tensor, params: Tensor, out_w: int, out_h: int) -> Tensor:
    """Launch K1: the CUDA implementation of ``torch.ops.spe_port.crop_bilinear``.
    ``frames`` may start at any byte offset."""
    _cuda.check_cuda_tensor("frames", frames, torch.uint8, 4)
    _cuda.check_cuda_tensor("params", params, torch.float32, 2)
    b, h, w, ch = frames.shape
    if ch != 3 or params.shape != (b, 4):
        raise ValueError(f"frames {tuple(frames.shape)} / params {tuple(params.shape)} disagree")
    out = frames.new_empty((b, out_h, out_w, 3), dtype=torch.float32)
    KERNEL.launch(frames.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w, out_h, out_w)
    return out


def _crop_bilinear_fake(frames: Tensor, params: Tensor, out_w: int, out_h: int) -> Tensor:
    return frames.new_empty((frames.shape[0], out_h, out_w, 3), dtype=torch.float32)


_LIB.impl("crop_bilinear", _crop_bilinear_cpu, "CPU")
_LIB.impl("crop_bilinear", _crop_bilinear_cuda, "CUDA")
torch.library.register_fake("spe_port::crop_bilinear", _crop_bilinear_fake, lib=_LIB)
# K1 as a registered operator, ``torch.ops.spe_port.crop_bilinear``: the
# plain version on CPU tensors, the kernel on CUDA ones, so that
# ``torch.export`` records it as one node. A program exported with it loads
# once this module is imported.
crop_bilinear_op = torch.ops.spe_port.crop_bilinear.default


def crop_bilinear(frames: Tensor, params: Tensor, out_size: tuple[int, int]) -> Tensor:
    """Bilinear crop of (B, H, W, 3) uint8 frames to (B, OH, OW, 3) float32.

    ``params`` (B, 4) from :func:`crop_params`. CPU tensors take the plain
    version; CUDA tensors launch K1; tensors on any other device raise. An
    eager call on plain CUDA tensors goes to the operator's CUDA
    implementation directly, past the dispatcher; under tracing (fake or
    functional tensors, a dispatch mode, ``torch.compile``) the call goes
    through :data:`crop_bilinear_op`, so ``torch.export`` records it.
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    if (frames.is_cuda and type(frames) is Tensor and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling()):
        return _crop_bilinear_cuda(frames, params, out_w, out_h)
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"frames: expected a CPU or CUDA tensor, got {frames.device}")
    return crop_bilinear_op(frames, params, out_w, out_h)


def crop_and_resize(
    frames: Tensor, centers: Tensor, scales: Tensor, out_size: tuple[int, int]
) -> Tensor:
    """Batched rot=0 crop of a center/scale box to ``out_size`` (w, h), float32."""
    return crop_bilinear(frames, crop_params(centers, scales, out_size), out_size)


def affine_warp(images: Tensor, M_inv: Tensor, out_size: tuple[int, int]) -> Tensor:
    """Bilinear warp of (B, H, W, C) images by (B, 2, 3) ``M_inv`` (output
    pixel -> source pixel) to (B, OH, OW, C) float32, cv2's
    ``warpAffine(INTER_LINEAR, BORDER_CONSTANT 0)``: each of the four taps
    off the frame is zeroed before the bilinear sum."""
    b, h, w, _ = images.shape
    out_w, out_h = int(out_size[0]), int(out_size[1])
    dev = images.device
    M = M_inv.to(torch.float32)[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    xd = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    yd = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = M[:, 0, 0] * xd + M[:, 0, 1] * yd + M[:, 0, 2]  # (B, OH, OW)
    ys = M[:, 1, 0] * xd + M[:, 1, 1] * yd + M[:, 1, 2]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    bi = torch.arange(b, device=dev)[:, None, None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = images[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)].to(torch.float32)
        return v * inb[..., None]

    return (tap(y0i, x0i) * (1 - wx) * (1 - wy) + tap(y0i, x0i + 1) * wx * (1 - wy)
            + tap(y0i + 1, x0i) * (1 - wx) * wy + tap(y0i + 1, x0i + 1) * wx * wy)


def rotated_crop_and_resize(frames: Tensor, centers: Tensor, scales: Tensor, rots: Tensor,
                            out_size: tuple[int, int]) -> Tensor:
    """Batched crop of a center/scale box rotated by ``rots`` degrees,
    resampled to ``out_size`` (w, h): (B, H, W, 3) frames of any dtype ->
    (B, OH, OW, 3) float32. The training transform's crop, at any angle;
    the axis-aligned serving crop is :func:`crop_and_resize` (K1)."""
    M_inv = geometry.crop_affine_matrix(centers, scales, rots, out_size, inv=True)
    return affine_warp(frames, M_inv, out_size)
