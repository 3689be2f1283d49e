"""SuperSloMo frame interpolation (v2e/v2ecore/slomo.py + model.py).

Port of the JAX package's ``events/slomo.py``: the two-UNet Super SloMo
network, a flow-computation UNet (2 frames -> bidirectional optical flow
F01/F10) and an arbitrary-time flow-interpolation UNet (-> refined flows +
visibility map), with ``backwarp`` bilinear warping (model.py:158-348) and
the midpoint schedule that turns a frame pair into n frames
(slomo.py:231-360).

The module names are those of the official ``SuperSloMo39.ckpt``
(``state_dictFC`` / ``state_dictAT`` with ``conv1``, ``conv2``,
``downK.convJ``, ``upK.convJ``, ``conv3``), so a checkpoint loads with
``load_state_dict(strict=True)`` (:func:`load_checkpoint`), and the JAX
package's variables through ``convert.flax_to_state_dict``. Public
functions take NHWC frames, as the JAX ones do; the UNets run NCHW.

:meth:`SuperSloMo.interpolate` computes the flow UNet once per pair (its
input does not depend on t) and runs the interpolation UNet on all n
values of t as one batch.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

Tensor = torch.Tensor


def leaky(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.1)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2)
        self.conv2 = nn.Conv2d(out_channels, out_channels, kernel, padding=kernel // 2)

    def forward(self, x: Tensor) -> Tensor:
        x = F.avg_pool2d(x, 2)
        return leaky(self.conv2(leaky(self.conv1(x))))


class Up(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(2 * out_channels, out_channels, 3, padding=1)

    def forward(self, x: Tensor, skip: Tensor) -> Tensor:
        # jax.image.resize(..., "bilinear") at 2x: half-pixel centres, edge taps clamped
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        x = leaky(self.conv1(x))
        return leaky(self.conv2(torch.cat([x, skip], 1)))


class UNet(nn.Module):
    """The Super SloMo UNet topology (model.py:229-307), NCHW."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 7, padding=3)
        self.conv2 = nn.Conv2d(32, 32, 7, padding=3)
        self.down1 = Down(32, 64, 5)
        self.down2 = Down(64, 128, 3)
        self.down3 = Down(128, 256, 3)
        self.down4 = Down(256, 512, 3)
        self.down5 = Down(512, 512, 3)
        self.up1 = Up(512, 512)
        self.up2 = Up(512, 256)
        self.up3 = Up(256, 128)
        self.up4 = Up(128, 64)
        self.up5 = Up(64, 32)
        self.conv3 = nn.Conv2d(32, out_channels, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        x1 = leaky(self.conv2(leaky(self.conv1(x))))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x6 = self.down5(x5)
        u = self.up1(x6, x5)
        u = self.up2(u, x4)
        u = self.up3(u, x3)
        u = self.up4(u, x2)
        u = self.up5(u, x1)
        return leaky(self.conv3(u))


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def backwarp(img: Tensor, flow: Tensor, mode: str = "exact") -> Tensor:
    """Warp img (B, H, W, C) backwards along flow (B, H, W, 2) [u, v].

    mode="exact": sample at (x+u, y+v), border taps clamped (zero flow is
    the identity). mode="torch": the reference backWarp's sampling
    (``grid_sample``, align_corners=False, zero padding): at
    (x+u-0.5, y+v-0.5) with out-of-image taps zeroed, which the official
    checkpoint was trained with. The taps are gathered as the JAX
    function gathers them, in the same arithmetic order.
    """
    b, h, w, _ = img.shape
    shift = 0.5 if mode == "torch" else 0.0
    dev = img.device
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) + flow[..., 0] - shift
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) + flow[..., 1] - shift
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    batch_idx = torch.arange(b, device=dev).view(b, 1, 1)

    def gather(yi, xi):
        yi_c = torch.clamp(yi.to(torch.int64), 0, h - 1)
        xi_c = torch.clamp(xi.to(torch.int64), 0, w - 1)
        val = img[batch_idx, yi_c, xi_c]
        if mode == "torch":  # zero padding: drop out-of-image taps
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            val = val * inside[..., None]
        return val

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


class SuperSloMo(nn.Module):
    """The flow-computation and arbitrary-time interpolation UNets.

    ``channels`` is the frames' channel count: 1 (luma, as v2e runs it) or
    3 (the official checkpoint's RGB). Weights are drawn from
    ``generator`` (PyTorch's default Conv2d init) until a checkpoint is
    loaded.
    """

    def __init__(self, channels: int = 1, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.flow_comp = UNet(2 * channels, 4)
        self.arb_interp = UNet(4 * channels + 8, 5)
        if generator is not None:
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, nn.Conv2d):
                        bound = 1.0 / math.sqrt(mod.weight[0].numel())
                        mod.weight.uniform_(-bound, bound, generator=generator)
                        mod.bias.uniform_(-bound, bound, generator=generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    def flow(self, frame0: Tensor, frame1: Tensor) -> Tensor:
        """The bidirectional flow (B, H, W, 4) [F01, F10] of NHWC frames in [0, 1]."""
        return _nhwc(self.flow_comp(_nchw(torch.cat([frame0, frame1], -1))))

    def _at(self, frame0: Tensor, frame1: Tensor, flow_out: Tensor, t: Tensor) -> Tensor:
        f01 = flow_out[..., 0:2]
        f10 = flow_out[..., 2:4]
        t = t.reshape(-1, 1, 1, 1)
        ft0_hat = -(1 - t) * t * f01 + t * t * f10
        ft1_hat = (1 - t) * (1 - t) * f01 - t * (1 - t) * f10
        # "torch" warp mode: the official checkpoint was trained with grid_sample's sampling
        g0 = backwarp(frame0, ft0_hat, mode="torch")
        g1 = backwarp(frame1, ft1_hat, mode="torch")
        interp_in = torch.cat([frame0, frame1, f01, f10, ft1_hat, ft0_hat, g1, g0], -1)
        interp_out = _nhwc(self.arb_interp(_nchw(interp_in)))
        ft0 = interp_out[..., 0:2] + ft0_hat
        ft1 = interp_out[..., 2:4] + ft1_hat
        v0 = torch.sigmoid(interp_out[..., 4:5])
        v1 = 1 - v0
        g0r = backwarp(frame0, ft0, mode="torch")
        g1r = backwarp(frame1, ft1, mode="torch")
        wgt0 = (1 - t) * v0
        wgt1 = t * v1
        return (wgt0 * g0r + wgt1 * g1r) / torch.clamp(wgt0 + wgt1, min=1e-8)

    def forward(self, frame0: Tensor, frame1: Tensor, t: Tensor, return_flow: bool = False) -> Tensor:
        """Interpolate at fractional times ``t`` (B,) in (0, 1) between NHWC
        frames in [0, 1]; ``return_flow``: the raw flow (B, H, W, 4) instead
        (the --auto_timestamp_resolution probe)."""
        flow_out = self.flow(frame0, frame1)
        if return_flow:
            return flow_out
        return self._at(frame0, frame1, flow_out, torch.as_tensor(t, dtype=frame0.dtype).to(frame0.device))

    def interpolate(self, frame0: Tensor, frame1: Tensor, ts: Tensor) -> Tensor:
        """(B, H, W, C) pairs -> (n, B, H, W, C) frames at the n times ``ts``:
        the flow once per pair, the interpolation UNet on all n x B at once."""
        n, b = ts.shape[0], frame0.shape[0]
        flow_out = self.flow(frame0, frame1)
        rep = lambda x: x.repeat(n, *([1] * (x.dim() - 1)))  # noqa: E731 — (n*B, ...), t-major
        out = self._at(rep(frame0), rep(frame1), rep(flow_out), ts.repeat_interleave(b))
        return out.reshape(n, b, *out.shape[1:])


def midpoint_times(n: int, device=None) -> Tensor:
    """The reference's schedule t = (i + 0.5) / n (slomo.py:407: [0, 1)
    covered, consecutive pairs tile the timeline without repeating the
    source frames), rounded as float32 divisions."""
    ts = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.from_numpy(ts).to(device)


def interpolate_pair(model: SuperSloMo, frame0: Tensor, frame1: Tensor, n: int) -> Tensor:
    """A frame pair -> n frames (n, B, H, W, C) at the midpoint schedule."""
    with torch.inference_mode():
        return model.interpolate(frame0, frame1, midpoint_times(n, frame0.device))


def auto_upsampling_factor(max_flow_px: float, limit_px: float = 1.0) -> int:
    """v2e --auto_timestamp_resolution: interpolate so the largest flow is
    at most ``limit_px`` per interpolated frame, a factor of at least 2
    (slomo.py:385-387)."""
    return max(int(math.ceil(float(np.float32(max_flow_px)) / limit_px)), 2)


def load_checkpoint(model: SuperSloMo, checkpoint: Mapping[str, Any]) -> SuperSloMo:
    """The official checkpoint's {'state_dictFC', 'state_dictAT'} into the
    model, names checked both ways (``strict=True``)."""
    model.flow_comp.load_state_dict(checkpoint["state_dictFC"], strict=True)
    model.arb_interp.load_state_dict(checkpoint["state_dictAT"], strict=True)
    return model


def checkpoint_channels(checkpoint: Mapping[str, Any]) -> int:
    """The frames' channel count a checkpoint was made for."""
    return int(checkpoint["state_dictFC"]["conv1.weight"].shape[1]) // 2
