"""The served int8 scheme in plain PyTorch, at any bit width.

The scheme the configurations state: BatchNorm folded into the conv
weights; symmetric per-output-channel weights and per-tensor activation
scales (abs-max over a bfloat16 calibration forward, over q_max =
2^(bits-1) - 1); integer sums requantized by y * m + b, rounded half to
even and clipped to [-q_max, q_max]; residual and fuse sums in float32 from
the integer operands; the first conv of each network in bfloat16 with its
output requantized; the HRNet head's 1x1 emitting float32; the trunk's
features dequantized for the FPN. Integers are held in float32 tensors and
the convolutions run in float32 (TF32 off, by the caller), so every product
is exact and only sums past 2^24 round.

``bits=8`` is the served form; ``bits=4`` is the control one step below.
:func:`fp8_layers` lowers the networks stated in bfloat16 one step, to
float8 e4m3, for the control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .nets import BN_EPS, BatchNorm, Conv, FrozenBN, Linear, residual_norms


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def requant(f, q):
    return torch.clamp(torch.round(f), -q, q)


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def fold(conv, norm, frozen: bool):
    """(HWIO float32 weight with the norm folded in, bias) in numpy, rounded
    as the scheme's host-side folding rounds: scale / sqrt(var + eps) for an
    eval BN, scale * (1 / sqrt(var + eps)) for a frozen one."""
    scale, bias, mean, var = (_np(getattr(norm, k)) for k in ("scale", "bias", "mean", "var"))
    mul = scale * (1.0 / np.sqrt(var + BN_EPS)) if frozen else scale / np.sqrt(var + BN_EPS)
    return np.ascontiguousarray(_np(conv.weight).transpose(2, 3, 1, 0)) * mul, bias - mean * mul


def quantize_weight(w: np.ndarray, q: float):
    """Symmetric per-output-channel integers of an HWIO kernel and their scales."""
    s = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(0), 1e-12) / q
    return np.clip(np.round(w / s), -q, q), s


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def amax_scales(net, x, run, q: float, floor: float) -> dict[str, float]:
    """abs-max / q of every named module's output (and of each element of
    a list output, as ``<name>/out<i>``) in one forward ``run(x)``."""
    scales: dict[str, float] = {}

    def amax(v):
        return max(float(v.float().abs().max()), floor) / q

    def hook(name):
        def record(_m, _i, out):
            if isinstance(out, (list, tuple)):
                for i, o in enumerate(out):
                    scales[f"{name}/out{i}"] = amax(o)
            elif isinstance(out, torch.Tensor):
                scales[name] = amax(out)
        return record

    handles = [m.register_forward_hook(hook(n.replace(".", "/"))) for n, m in net.named_modules() if n]
    try:
        with torch.no_grad():
            run(x)
    finally:
        for h in handles:
            h.remove()
    return scales


class Site:
    """One quantized conv: integer weights (OIHW, float32), requant vectors, stride, groups."""

    def __init__(self, conv, norm, s_in, s_out, q, frozen=False):
        w, beta = fold(conv, norm, frozen)
        w8, s_w = quantize_weight(w, q)
        dev = conv.weight.device
        self.w = _dev(w8.transpose(3, 2, 0, 1), dev)
        self.m, self.b = _dev(s_in * s_w / s_out, dev), _dev(beta / s_out, dev)
        self.stride, self.groups, self.pad = conv.stride, conv.groups, conv.pad
        self.q = q

    def __call__(self, x, relu):
        """x: NCHW integers (float32) -> requantized NCHW integers."""
        y = F.conv2d(x, self.w, None, self.stride, self.pad, 1, self.groups)
        f = y * self.m[:, None, None] + self.b[:, None, None]
        return requant(torch.clamp_min(f, 0.0) if relu else f, self.q)


class Stem:
    """The bfloat16 first conv, requantized; with ``raw_mean_std`` the
    ImageNet normalization folded into its weights and bias, so that it
    takes raw pixels. Its kernel is held (kh, kw, in, out) as the scheme's
    tree keeps it: a bfloat16 conv sums in an order set by its operands'
    layouts, and each rounding of its output moves the requantized value."""

    def __init__(self, conv, norm, s_out, q, frozen, raw_mean_std=None):
        w, beta = fold(conv, norm, frozen)
        if raw_mean_std is not None:
            mean, std = (np.asarray(v, np.float32) * 255.0 for v in raw_mean_std)
            w = w / std[None, None, :, None]
            beta = beta - (w * mean[None, None, :, None]).sum((0, 1, 2))
        dev = conv.weight.device
        self.w = _dev(w, dev).to(torch.bfloat16)
        self.m = _dev(np.full(w.shape[-1], 1.0 / s_out), dev)
        self.b = _dev(beta / s_out, dev)
        self.stride, self.pad, self.q = conv.stride, conv.pad, q

    def __call__(self, x):
        """x: NCHW float32 -> NCHW integers (float32)."""
        y = F.conv2d(x.to(torch.bfloat16), self.w.permute(3, 2, 0, 1), None, self.stride, self.pad)
        return requant(torch.clamp_min(y.float() * self.m[:, None, None] + self.b[:, None, None], 0.0), self.q)


class QuantTrunk:
    """The detector trunk (``nets.ResNet``) in the scheme: calibrated on
    normalized NHWC images ``calib_x``; called on normalized NHWC images,
    returns {res2..res5: NCHW float32} dequantized features."""

    def __init__(self, trunk, calib_x, bits: int = 8):
        q = self.q = qmax(bits)
        self.trunk = trunk
        sc = amax_scales(trunk, calib_x.permute(0, 3, 1, 2).to(torch.bfloat16), trunk, q, 1e-6)
        self.stem = Stem(trunk.stem.conv, trunk.stem.norm, sc["stem"], q, frozen=True)
        self.sites, self.coeffs, self.fscale = {}, {}, {}
        s_cur = sc["stem"]
        for stage, name, blk in trunk.blocks:
            s_in = s_cur
            s1, s2, s3 = (sc[f"{name}/conv{i}"] for i in (1, 2, 3))
            for part, s_a, s_b in (("conv1", s_in, s1), ("conv2", s1, s2), ("conv3", s2, s3)):
                mod = getattr(blk, part)
                self.sites[f"{name}/{part}"] = Site(mod.conv, mod.norm, s_a, s_b, q, frozen=True)
            s_sc = s_in
            if blk.shortcut is not None:
                s_sc = sc[f"{name}/shortcut"]
                self.sites[f"{name}/shortcut"] = Site(blk.shortcut.conv, blk.shortcut.norm, s_in, s_sc, q, frozen=True)
            s_cur = sc[name]
            self.coeffs[name] = (sc[f"{name}/conv3"] / s_cur, s_sc / s_cur)
            self.fscale[stage] = s_cur

    def __call__(self, x_norm):
        t = self.trunk
        x = self.stem(x_norm.permute(0, 3, 1, 2))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for stage, name, blk in t.blocks:
            h = self.sites[f"{name}/conv2"](self.sites[f"{name}/conv1"](x, True), True)
            r3 = self.sites[f"{name}/conv3"](h, False)
            r = self.sites[f"{name}/shortcut"](x, False) if blk.shortcut is not None else x
            c3, cr = self.coeffs[name]
            x = requant(torch.clamp_min(r3 * c3 + r * cr, 0.0), self.q)
            feats[stage] = x
        return {k: v * self.fscale[k] for k, v in feats.items()}


class QuantHRNet:
    """HRNet (``nets.HRNet``, classic head) in the scheme, its stem folding
    the ImageNet normalization so that it takes raw [0, 255] crops.
    Calibrated on normalized NHWC crops ``calib_x``; called on raw NHWC
    crops, returns (B, H/4, W/4, J) float32 heatmaps."""

    def __init__(self, net, calib_x, mean_std, bits: int = 8):
        self.net, self.q = net, qmax(bits)
        self.sc = amax_scales(net, calib_x, lambda x: net(x, torch.bfloat16), self.q, 1e-12)
        self.stem = Stem(net.stem1.conv, net.stem1.bn, self.sc["stem1"], self.q, False, mean_std)
        self.sites: dict[str, Site] = {}

    def _site(self, name, s_in):
        if name not in self.sites:
            mod = self.net.get_submodule(name.replace("/", "."))
            self.sites[name] = Site(mod.conv, mod.bn, s_in, self.sc[name], self.q)
        return self.sites[name]

    def _conv(self, name, h, relu):
        """h = (integers, scale) -> the site's (integers, scale)."""
        return self._site(name, h[1])(h[0], relu), self.sc[name]

    def _add(self, name, hs, relu=True):
        s_out = self.sc[name]
        f = hs[0][0] * (hs[0][1] / s_out)
        for v, s in hs[1:]:
            f = f + v * (s / s_out)
        return requant(torch.clamp_min(f, 0.0) if relu else f, self.q), s_out

    def __call__(self, crops_raw):
        net, cfg, q = self.net, self.net.cfg, self.q
        x = self.stem(crops_raw.permute(0, 3, 1, 2))
        h = self._conv("stem2", (x, self.sc["stem1"]), True)
        for i in range(cfg["stage1_blocks"]):
            p = f"layer1/block{i}"
            y = self._conv(f"{p}/conv3", self._conv(f"{p}/conv2", self._conv(f"{p}/conv1", h, True), True), False)
            r = self._conv(f"{p}/down", h, False) if net.get_submodule(p.replace("/", ".")).down is not None else h
            h = self._add(p, [y, r])
        xs = [h]
        for si, (trans, mods) in enumerate(net.stage_names):
            tmod = getattr(net, trans)
            n_pre, new = len(xs), []
            for i in range(len(tmod.cout)):
                if i < n_pre:
                    new.append(self._conv(f"{trans}/adapt{i}", xs[i], True) if hasattr(tmod, f"adapt{i}") else xs[i])
                else:
                    y = xs[-1]
                    for j in range(i + 1 - n_pre):
                        y = self._conv(f"{trans}/new{i}_{j}", y, True)
                    new.append(y)
            xs = new
            for mname in mods:
                mod = getattr(net, mname)
                ys = []
                for bi in range(mod.nb):
                    br, hc = getattr(mod, f"branch{bi}"), xs[bi]
                    for k in range(br.n):
                        bn = f"{mname}/branch{bi}/block{k}"
                        y = self._conv(f"{bn}/conv2", self._conv(f"{bn}/conv1", hc, True), False)
                        if getattr(br, f"block{k}").down is not None:
                            hc = self._conv(f"{bn}/down", hc, False)
                        hc = self._add(bn, [y, hc])
                    ys.append(hc)
                if mod.fuse is None:
                    xs = ys
                    continue
                outs = []
                for i in range(mod.fuse.n_out):
                    downs = []
                    for j in range(i):
                        y = ys[j]
                        for k in range(i - j):
                            y = self._conv(f"{mname}/fuse/down{i}_{j}_{k}", y, k != i - j - 1)
                        downs.append(y)
                    acc, ai = [ys[i]], 0
                    for j in range(len(ys)):
                        if j == i:
                            continue
                        if j > i:
                            v, s = self._conv(f"{mname}/fuse/up{i}_{j}", ys[j], False)
                            f = 2 ** (j - i)
                            acc.append((v.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3), s))
                        else:
                            acc.append(downs[ai])
                            ai += 1
                    outs.append(self._add(f"{mname}/fuse/out{i}", acc))
                xs = outs
        v, s_in = xs[0]
        fl = net.final_layer
        w8, s_w = quantize_weight(np.ascontiguousarray(_np(fl.weight).transpose(2, 3, 1, 0)), q)
        y = F.conv2d(v, _dev(w8.transpose(3, 2, 0, 1), v.device), None, 1, fl.pad)
        return (y * _dev(s_in * s_w, v.device)[:, None, None] + fl.bias[:, None, None]).permute(0, 2, 3, 1)


def calibrate_norms(net, x, run, residual_gain: float = 1.0) -> None:
    """Set every FrozenBN / eval BN of ``net`` to the statistics of its input
    in one forward ``run(x)``, in forward order, so that a seeded random
    network keeps its activations at about unit scale, as a trained
    network's folded BN does: bias 0, scale 1, and ``residual_gain`` for the
    norm that ends each residual branch (``nets.residual_norms``), which
    keeps the random network as little sensitive to a small change of its
    input as a trained one is."""
    damped = {id(m) for m in residual_norms(net)}

    def pre(mod, inputs):
        v = inputs[0].float()
        mod.mean.data.copy_(v.mean(dim=(0, 2, 3)))
        mod.var.data.copy_(v.var(dim=(0, 2, 3), unbiased=False))
        mod.scale.data.fill_(residual_gain if id(mod) in damped else 1.0)
        mod.bias.data.zero_()

    hooks = [m.register_forward_pre_hook(pre) for m in net.modules() if isinstance(m, (FrozenBN, BatchNorm))]
    try:
        with torch.no_grad():
            run(x)
    finally:
        for h in hooks:
            h.remove()



FP8_MAX = 448.0  # the largest float8 e4m3 value


def fake_fp8(x, dim=None):
    """x scaled to float8 e4m3's range by its abs-max (per tensor, or per
    slice along ``dim``), rounded to float8 and scaled back (float32)."""
    x = x.to(torch.float32)
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@contextlib.contextmanager
def fp8_layers(modules):
    """Within the block, every ``Conv`` and ``Linear`` of ``modules`` runs on
    float8 e4m3 operands held in float32: weights scaled per output channel,
    each input per tensor. Weights are restored after."""
    saved, hooks = [], []
    try:
        for net in modules:
            for layer in net.modules():
                if isinstance(layer, (Conv, Linear)):
                    w = layer.weight.data
                    saved.append((layer, w))
                    layer.weight.data = fake_fp8(w, dim=tuple(range(1, w.dim())))
                    hooks.append(layer.register_forward_pre_hook(lambda _m, args: (fake_fp8(args[0]),)))
        yield
    finally:
        for h in hooks:
            h.remove()
        for layer, w in saved:
            layer.weight.data = w
