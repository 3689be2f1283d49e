"""int8 x int8 -> int32 convolution with its requant epilogue (kernel K5a).

The per-op site of the JAX package's int8 walks: ``_Int8Ops.convbn`` and
``final`` (``models/hrnet_int8.py``) and ``_conv_i8`` (``models/backbone_int8.py``),
each an XLA conv with ``preferred_element_type=int32`` followed by
``f = y * m + b``. PyTorch has no int8 convolution on CUDA, so the conv is
``csrc/int8_conv_requant.cu``; :func:`int8_conv_plain` is the same function
in eager PyTorch (the conv in float64, exact for int8 sums), taken for CPU
tensors. Beside the SAME convs of the walks it runs the space-to-depth
convs of ``ops/s2d.py`` (kernel sizes 2 and 4, explicit padding), the
merged fuse convs of ``merge_fuse`` (a per-output-channel lower clip bound
``lo``) and the f32 epilogues that ``fold_residual`` hands to its adds.

Layouts are the JAX package's: NHWC activations, HWIO weights. The
kernel multiplies on the int8 tensor cores, which take both operands
K-major, so it reads a second copy of the weights, (Cout, k, k, Cin / groups)
(:func:`pack_kmajor`), that the model packs once when it is built
(:func:`with_kmajor`) and hands over as ``wk``.

A grouped conv's plain version is a plain ``groups=g`` conv on the compact
weight. The kernel's tiles hold whole groups of at least
``TILE_CHANNELS`` output channels, so its copy merges adjacent groups
block-diagonally until a merged group fills whole tiles
(:func:`pack_grouped_kmajor`; X101's res2 groups of 8 channels 4 to a
tile, res3's of 16 two to a tile), as the JAX backbone merges them into
128-wide groups for TPU lanes. The zeros change no int32 sum, so both
agree bit for bit; the kernel reads its group count off ``wk``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from .. import _cuda

Tensor = torch.Tensor

KERNEL = _cuda.Kernel(
    "int8_conv_requant", "int8_conv_requant.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
)
# K5a's launches at a (merged) group count above 1, the grouped 3x3 sites;
# given an explicit padding (the space-to-depth convs of ops/s2d.py), by
# kernel size; with a per-channel clip (merge_fuse); with the f32 epilogue
# (the heads, and the sites fold_residual hands to their adds): each counted
# where it launches, beside KERNEL.launches, which counts them all
GROUPED = SimpleNamespace(launches=0)
PADDED = {k: SimpleNamespace(launches=0) for k in (1, 2, 3, 4)}
CLIPPED = SimpleNamespace(launches=0)
F32 = SimpleNamespace(launches=0)
TILE_CHANNELS = 32  # the narrowest tile's output channels; a grouped conv's groups hold whole tiles


def pack_kmajor(w: Tensor) -> Tensor:
    """HWIO (..., k, k, Cin, Cout) int8 weights -> K-major (..., Cout, k, k, Cin),
    contiguous: each output channel's k * k * Cin weights in a row."""
    return w.movedim(-1, -4).contiguous()


def merged_groups(groups: int, cout_g: int) -> int:
    """The kernel's group count for a conv of ``groups`` groups of ``cout_g``
    output channels: the fewest adjacent groups merged that fill whole
    ``TILE_CHANNELS`` tiles (and divide ``groups``), or one dense group
    where no merge does."""
    for m in range(1, groups + 1):
        if groups % m == 0 and (m * cout_g) % TILE_CHANNELS == 0:
            return groups // m
    return 1


def pack_grouped_kmajor(w: Tensor, groups: int) -> Tensor:
    """Compact grouped HWIO weights (k, k, Cin / groups, Cout) -> the kernel's
    K-major copy (Cout, k, k, Cin / g) at ``g = merged_groups(...)``: the
    block-diagonal merge of each ``m = groups / g`` adjacent groups (merged
    group G's input channels are its groups' in turn, and group G m + p
    reads only the p-th of them), packed by :func:`pack_kmajor`."""
    k, k2, cin_g, cout = w.shape
    g = merged_groups(groups, cout // groups)
    m = groups // g
    if m == 1:
        return pack_kmajor(w)
    w5 = w.reshape(k, k2, cin_g, groups, cout // groups)
    merged = w.new_zeros(k, k2, m, cin_g, groups, cout // groups)
    for p in range(m):
        merged[:, :, p, :, p::m] = w5[:, :, :, p::m]
    return pack_kmajor(merged.reshape(k, k2, m * cin_g, cout))


def kernel_groups(cin: int, wk_shape) -> int:
    """The group count K5a runs a conv of ``cin`` input channels at: read off
    its K-major weights (Cout, k, k, Cin / g). Raises for what the kernel
    does not take: Cin / g not a multiple of 4, or groups of output
    channels that do not fill whole ``TILE_CHANNELS`` tiles."""
    cout, k, k2, cin_g = wk_shape
    groups = cin // cin_g if cin_g else 0
    if k != k2 or groups * cin_g != cin or cout % groups:
        raise ValueError(f"int8_conv: {cin} input channels and wk {tuple(wk_shape)} disagree")
    if cin_g % 4:
        raise ValueError(f"int8_conv: the kernel needs input channels per group a multiple of 4, got {cin_g}")
    if groups > 1 and (cout // groups) % TILE_CHANNELS:
        raise ValueError(f"int8_conv: grouped convs need output groups of a multiple of {TILE_CHANNELS} "
                         f"channels, got {cout // groups} (pack_grouped_kmajor merges them)")
    return groups


def unpack_kmajor(wk: Tensor) -> Tensor:
    """The inverse of :func:`pack_kmajor`: (..., Cout, k, k, Cin) -> (..., k, k, Cin, Cout)."""
    return wk.movedim(-4, -1).contiguous()


def with_kmajor(tree):
    """A quantized tree with ``w8k = pack_kmajor(w8)`` beside every ``w8``
    (and ``w8pk`` beside every space-to-depth ``w8p``) that has none: the
    kernels' copy of the weights, made once when a model is built. Other
    leaves are the same objects."""
    if not isinstance(tree, dict):
        return tree
    out = {k: with_kmajor(v) for k, v in tree.items()}
    for key in ("w8", "w8p"):
        if isinstance(out.get(key), torch.Tensor) and key + "k" not in out:
            out[key + "k"] = pack_kmajor(out[key])
    return out


def requant(f: Tensor, lo: Tensor | None = None) -> Tensor:
    """clip(round(f), lo, 127) as int8, rounding half to even as ``jnp.round``;
    ``lo`` -127, or a lower bound per channel (the last axis)."""
    r = torch.round(f)
    return (torch.clamp(r, -127, 127) if lo is None else torch.clamp(torch.maximum(r, lo), max=127)).to(torch.int8)


def epilogue(y: Tensor, m: Tensor, b: Tensor, relu: bool, out_f32: bool, lo: Tensor | None = None) -> Tensor:
    """int32 sums -> relu?(y * m + b) as f32, or requantized to int8 (clipped below at ``lo``)."""
    f = y.to(torch.float32) * m + b
    if relu:
        f = torch.clamp_min(f, 0.0)
    return f if out_f32 else requant(f, lo)


def conv_padding(k: int, padding=None) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) zero padding: ``padding`` as JAX's
    ``conv_general_dilated`` takes it, or k // 2 on every side (SAME at odd k)."""
    if padding is None:
        return (k // 2, k // 2), (k // 2, k // 2)
    (top, bottom), (left, right) = padding
    pad = (int(top), int(bottom)), (int(left), int(right))
    if min(pad[0] + pad[1]) < 0:
        raise ValueError(f"int8_conv: negative padding {padding}")
    return pad


def out_size(n: int, k: int, stride: int, pad: tuple[int, int] | None = None) -> int:
    """Output size along one axis of ``n`` inputs, padded by ``pad`` (k // 2 on both ends unless given)."""
    lo, hi = (k // 2, k // 2) if pad is None else pad
    return (n + lo + hi - k) // stride + 1


def _check_clip(lo: Tensor | None, out_f32: bool) -> None:
    if lo is not None and out_f32:
        raise ValueError("int8_conv: a lower clip bound lo applies to the int8 output, not to out_f32")


def int8_conv_plain(x: Tensor, w: Tensor, m: Tensor, b: Tensor, stride: int = 1, groups: int = 1,
                    relu: bool = False, out_f32: bool = False, padding=None, lo: Tensor | None = None) -> Tensor:
    """Plain PyTorch K5a. x (B, H, W, Cin) int8, w (k, k, Cin / groups, Cout) int8,
    m, b (Cout,) f32, lo (Cout,) f32 or None -> (B, Ho, Wo, Cout) int8 (or f32
    with ``out_f32``)."""
    _check_clip(lo, out_f32)
    (top, bottom), (left, right) = conv_padding(w.shape[0], padding)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (left, right, top, bottom))
    y = F.conv2d(xp, w.permute(3, 2, 0, 1).to(torch.float64), stride=stride, groups=groups)
    return epilogue(y.to(torch.int32).permute(0, 2, 3, 1), m, b, relu, out_f32, lo).contiguous()


def int8_conv(x: Tensor, w: Tensor, m: Tensor, b: Tensor, stride: int = 1, groups: int = 1,
              relu: bool = False, out_f32: bool = False, wk: Tensor | None = None, padding=None,
              lo: Tensor | None = None) -> Tensor:
    """int8 conv, zero padding ``padding`` (((top, bottom), (left, right));
    k // 2 on every side unless given), then relu?(y * m + b) per output
    channel, emitted as int8 ``clip(rint(f), lo, 127)`` (``lo`` -127 unless
    given per output channel) or, with ``out_f32``, as f32.

    x (B, H, W, Cin) int8 NHWC; w (k, k, Cin / groups, Cout) int8 HWIO;
    m, b (Cout,) f32; wk ``pack_grouped_kmajor(w, groups)``. CPU tensors
    take the plain version on ``w`` and ``groups``; CUDA tensors launch K5a
    on ``wk``, which they require, at the group count it holds
    (:func:`kernel_groups`).
    """
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, m, b, stride, groups, relu, out_f32, padding, lo)
    return _launch(x, wk, m, b, stride, relu, out_f32, padding, lo)


def _launch(x, wk, m, b, stride, relu, out_f32, padding=None, lo=None):
    if wk is None:
        raise ValueError("int8_conv: the CUDA kernel needs the K-major weights wk = pack_grouped_kmajor(w, groups), "
                         "packed once when the model is built (with_kmajor, backbone_int8.pack_backbone)")
    _cuda.check_cuda_tensor("x", x, torch.int8, 4)
    _cuda.check_word_aligned("x", x)
    _cuda.check_cuda_tensor("wk", wk, torch.int8, 4)
    _cuda.check_cuda_tensor("m", m, torch.float32, 1)
    _cuda.check_cuda_tensor("b", b, torch.float32, 1)
    bsz, h, wd, cin = x.shape
    cout, k = wk.shape[:2]
    groups = kernel_groups(cin, wk.shape)
    if m.shape[0] != cout or b.shape[0] != cout:
        raise ValueError(f"int8_conv: wk {tuple(wk.shape)}, m {tuple(m.shape)}, b {tuple(b.shape)} disagree")
    _check_clip(lo, out_f32)
    if lo is not None:
        _cuda.check_cuda_tensor("lo", lo, torch.float32, 1)
        if lo.shape[0] != cout:
            raise ValueError(f"int8_conv: lo {tuple(lo.shape)} for {cout} output channels")
    pad_y, pad_x = conv_padding(k, padding)
    ho, wo = out_size(h, k, stride, pad_y), out_size(wd, k, stride, pad_x)
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.float32 if out_f32 else torch.int8, device=x.device)
    KERNEL.launch(_cuda.ptr(x), _cuda.ptr(wk), _cuda.ptr(m), _cuda.ptr(b),
                  _cuda.ptr(lo) if lo is not None else ctypes.c_void_p(None), _cuda.ptr(out),
                  bsz, h, wd, cin, ho, wo, cout, k, stride, pad_y[0], pad_x[0], groups, int(relu), int(out_f32))
    for counter, on in ((GROUPED, groups > 1), (CLIPPED, lo is not None), (F32, out_f32)):
        counter.launches += int(on)
    if padding is not None and k in PADDED:
        PADDED[k].launches += 1
    return out
