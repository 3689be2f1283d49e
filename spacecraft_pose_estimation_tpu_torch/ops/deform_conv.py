"""Deformable convolution v1 / v2 (port of ``ops/deform_conv.py``, detectron2's ``layers/deform_conv.py``).

The sampling points are the regular k x k grid plus learned offsets per
output location and tap; v2 ("modulated") scales each sample by a mask.
The JAX package computes this as XLA gathers, not a Pallas kernel, and so
does this port: one row gather of the NHWC input for each bilinear corner
of every (location, tap), then one matrix product with the kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..models.layers import Conv

Tensor = torch.Tensor


def _bilinear_taps(x: Tensor, y: Tensor, xx: Tensor) -> Tensor:
    """Sample NHWC ``x`` (B, H, W, C) at (B, ...) points (y, xx) -> (B, ..., C).

    The JAX package's edge rule: a point is clamped into [0, H-1] x [0, W-1]
    first, then zeroed only if it lay outside (-1, H) x (-1, W). So a tap at
    y = -0.5 reads row 0 at full weight (it is not blended with zeros).
    """
    b, h, w, c = x.shape
    inb = (y > -1.0) & (y < h) & (xx > -1.0) & (xx < w)
    y = torch.clamp(y, 0.0, h - 1)
    xx = torch.clamp(xx, 0.0, w - 1)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (y - y0)[..., None]
    fx = (xx - x0)[..., None]
    rows = x.reshape(b * h * w, c)
    base = (torch.arange(b, device=x.device) * (h * w)).reshape((b,) + (1,) * (y.dim() - 1))

    def corner(yi, xi):
        return rows[(base + yi * w + xi).reshape(-1)].reshape(*y.shape, c)

    # the JAX expression's order: ((f00 * (1 - fy)) * (1 - fx) + (f01 * (1 - fy)) * fx) + ...
    out = corner(y0, x0) * (1 - fy) * (1 - fx)
    out += corner(y0, x1) * (1 - fy) * fx
    out += corner(y1, x0) * fy * (1 - fx)
    out += corner(y1, x1) * fy * fx
    return out * inb[..., None]


def deform_conv2d(x: Tensor, offsets: Tensor, kernel: Tensor, mask: Tensor | None = None, stride: int = 1) -> Tensor:
    """Deformable conv of NHWC images.

    x (B, H, W, Cin); offsets (B, H, W, 2 K^2), [dy, dx] for tap
    t = i * K + j; kernel (K, K, Cin, Cout); mask (B, H, W, K^2) or None
    (v1). The output is (B, H // stride, W // stride, Cout): the offsets
    and the mask are taken at every ``stride``-th location of the full-size
    maps, as in the JAX package, whose stride-2 form needs even sizes.
    """
    kh, kw, cin, cout = kernel.shape
    b, h, w = x.shape[:3]
    if h % stride or w % stride:
        raise ValueError(f"deform_conv2d at stride {stride} takes sizes it divides, got {h}x{w}")
    oh, ow = h // stride, w // stride
    off = offsets[:, ::stride, ::stride].reshape(b, oh, ow, kh * kw, 2)
    grid_y = torch.arange(oh, dtype=torch.float32, device=x.device)[:, None] * stride
    grid_x = torch.arange(ow, dtype=torch.float32, device=x.device)[None, :] * stride
    tap_y = torch.arange(kh, device=x.device).repeat_interleave(kw).to(torch.float32) - kh // 2
    tap_x = torch.arange(kw, device=x.device).repeat(kh).to(torch.float32) - kw // 2
    yy = (grid_y[..., None] + tap_y) + off[..., 0]  # (B, oh, ow, K^2): base + (i - K // 2) + dy
    xx = (grid_x[..., None] + tap_x) + off[..., 1]
    sampled = _bilinear_taps(x, yy, xx)  # (B, oh, ow, K^2, Cin)
    if mask is not None:
        sampled *= mask[:, ::stride, ::stride, :, None]
    out = sampled.reshape(b * oh * ow, kh * kw * cin) @ kernel.reshape(kh * kw * cin, cout)
    return out.reshape(b, oh, ow, cout)


class DeformConv(nn.Module):
    """A learned-offset deformable conv (v2 when ``modulated``), float32,
    NHWC in and out: ``offset_conv`` (a K x K conv with a bias, starting at
    a zero kernel, so the layer starts as a regular conv) gives each
    location's offsets (and the v2 mask, 2 sigmoid(.)); ``weight`` is the
    main kernel, (Cout, Cin, K, K) with no bias (the Flax ``kernel``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1, modulated: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.stride, self.modulated = kernel, stride, modulated
        k2 = kernel * kernel
        self.offset_conv = Conv(cin, 2 * k2 + (k2 if modulated else 0), kernel, 1, kernel // 2)
        nn.init.zeros_(self.offset_conv.weight)
        fan_in = cin * k2  # He normal, as the Flax module's init
        self.weight = nn.Parameter(torch.randn(features, cin, kernel, kernel, generator=generator) * (2 / fan_in) ** 0.5)
        self.to(resolve_device(device))

    def forward(self, x):
        k2 = self.k * self.k
        off = self.offset_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        mask = torch.sigmoid(off[..., 2 * k2:]) * 2.0 if self.modulated else None
        return deform_conv2d(x, off[..., :2 * k2], self.weight.permute(2, 3, 1, 0), mask, self.stride)
