"""Axis-aligned bilinear crop of uint8 frames (zero border), and the window clamp.

Port of the serving crop of ``spacecraft_pose_estimation_tpu``: the
windowed paths ``ops/warp.crop_and_resize_mxu_windowed`` (XLA) and
``ops/pallas_crop.crop_and_resize_window`` (Pallas) both equal the
full-frame ``ops/warp.crop_and_resize_mxu`` once the crop scale is clamped
to the window's coverage (:func:`clamp_scales_to_window`). So the port has
one crop, kernel K1 (``csrc/crop_bilinear.cu``), which samples the frame
directly; :func:`crop_bilinear_plain` is the same function in eager
PyTorch, taken for CPU tensors.
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


def crop_bilinear(frames: Tensor, params: Tensor, out_size: tuple[int, int]) -> Tensor:
    """Bilinear crop of (B, H, W, 3) uint8 frames to (B, OH, OW, 3) float32.

    ``params`` (B, 4) from :func:`crop_params`. CPU tensors take the plain
    version; CUDA tensors launch K1.
    """
    if frames.device.type == "cpu":
        return crop_bilinear_plain(frames, params, out_size)
    _cuda.check_cuda_tensor("frames", frames, torch.uint8, 4)
    _cuda.check_cuda_tensor("params", params, torch.float32, 2)
    b, h, w, ch = frames.shape
    if ch != 3 or tuple(params.shape) != (b, 4):
        raise ValueError(f"frames {tuple(frames.shape)} / params {tuple(params.shape)} disagree")
    out_w, out_h = int(out_size[0]), int(out_size[1])
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.float32, device=frames.device)
    KERNEL.launch(_cuda.ptr(frames), _cuda.ptr(params), _cuda.ptr(out), b, h, w, out_h, out_w)
    return out


def crop_and_resize(
    frames: Tensor, centers: Tensor, scales: Tensor, out_size: tuple[int, int]
) -> Tensor:
    """Batched rot=0 crop of a center/scale box to ``out_size`` (w, h), float32."""
    return crop_bilinear(frames, crop_params(centers, scales, out_size), out_size)
