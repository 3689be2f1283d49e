"""int8 x int8 -> int32 convolution with its requant epilogue (kernel K5a).

The per-op site of the JAX package's int8 walks: ``_Int8Ops.convbn`` and
``final`` (``models/hrnet_int8.py``) and ``_conv_i8`` (``models/backbone_int8.py``),
each an XLA conv with ``preferred_element_type=int32`` followed by
``f = y * m + b``. PyTorch has no int8 convolution on CUDA, so the conv is
``csrc/int8_conv_requant.cu``; :func:`int8_conv_plain` is the same function
in eager PyTorch (the conv in float64, exact for int8 sums), taken for CPU
tensors.

Layouts are the JAX package's: NHWC activations, HWIO weights. The
kernel multiplies on the int8 tensor cores, which take both operands
K-major, so it reads a second copy of the weights, (Cout, k, k, Cin / groups)
(:func:`pack_kmajor`), that the model packs once when it is built
(:func:`with_kmajor`) and hands over as ``wk``. A grouped conv is a plain
``groups=g`` conv: the JAX backbone's expansion to 128-wide block-diagonal
groups packs TPU lanes with zeros that change nothing.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda

Tensor = torch.Tensor

KERNEL = _cuda.Kernel(
    "int8_conv_requant", "int8_conv_requant.cu",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
)
TILE_CHANNELS = 32  # the narrowest tile's output channels; a grouped conv's groups hold whole tiles


def pack_kmajor(w: Tensor) -> Tensor:
    """HWIO (..., k, k, Cin, Cout) int8 weights -> K-major (..., Cout, k, k, Cin),
    contiguous: each output channel's k * k * Cin weights in a row."""
    return w.movedim(-1, -4).contiguous()


def unpack_kmajor(wk: Tensor) -> Tensor:
    """The inverse of :func:`pack_kmajor`: (..., Cout, k, k, Cin) -> (..., k, k, Cin, Cout)."""
    return wk.movedim(-4, -1).contiguous()


def with_kmajor(tree):
    """A quantized tree with ``w8k = pack_kmajor(w8)`` beside every ``w8``
    that has none: the kernels' copy of the weights, made once when a model
    is built. Other leaves are the same objects."""
    if not isinstance(tree, dict):
        return tree
    out = {k: with_kmajor(v) for k, v in tree.items()}
    if isinstance(out.get("w8"), torch.Tensor) and "w8k" not in out:
        out["w8k"] = pack_kmajor(out["w8"])
    return out


def requant(f: Tensor) -> Tensor:
    """clip(round(f), -127, 127) as int8, rounding half to even as ``jnp.round``."""
    return torch.clamp(torch.round(f), -127, 127).to(torch.int8)


def epilogue(y: Tensor, m: Tensor, b: Tensor, relu: bool, out_f32: bool) -> Tensor:
    """int32 sums -> relu?(y * m + b) as f32, or requantized to int8."""
    f = y.to(torch.float32) * m + b
    if relu:
        f = torch.clamp_min(f, 0.0)
    return f if out_f32 else requant(f)


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def int8_conv_plain(x: Tensor, w: Tensor, m: Tensor, b: Tensor, stride: int = 1, groups: int = 1,
                    relu: bool = False, out_f32: bool = False) -> Tensor:
    """Plain PyTorch K5a. x (B, H, W, Cin) int8, w (k, k, Cin / groups, Cout) int8,
    m, b (Cout,) f32 -> (B, Ho, Wo, Cout) int8 (or f32 with ``out_f32``)."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), w.permute(3, 2, 0, 1).to(torch.float64),
                 stride=stride, padding=k // 2, groups=groups)
    return epilogue(y.to(torch.int32).permute(0, 2, 3, 1), m, b, relu, out_f32).contiguous()


def int8_conv(x: Tensor, w: Tensor, m: Tensor, b: Tensor, stride: int = 1, groups: int = 1,
              relu: bool = False, out_f32: bool = False, wk: Tensor | None = None) -> Tensor:
    """int8 conv, zero padding k // 2, then relu?(y * m + b) per output channel,
    emitted as int8 ``clip(rint(f), -127, 127)`` or, with ``out_f32``, as f32.

    x (B, H, W, Cin) int8 NHWC; w (k, k, Cin / groups, Cout) int8 HWIO;
    m, b (Cout,) f32; wk ``pack_kmajor(w)``. CPU tensors take the plain
    version on ``w``; CUDA tensors launch K5a on ``wk``, which they require,
    with Cin / groups a multiple of 4 and, with groups > 1, Cout / groups a
    multiple of 32.
    """
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, m, b, stride, groups, relu, out_f32)
    return _launch(x, wk, m, b, stride, groups, relu, out_f32)


def _launch(x, wk, m, b, stride, groups, relu, out_f32):
    if wk is None:
        raise ValueError("int8_conv: the CUDA kernel needs the K-major weights wk = pack_kmajor(w), "
                         "packed once when the model is built (with_kmajor)")
    _cuda.check_cuda_tensor("x", x, torch.int8, 4)
    _cuda.check_word_aligned("x", x)
    _cuda.check_cuda_tensor("wk", wk, torch.int8, 4)
    _cuda.check_cuda_tensor("m", m, torch.float32, 1)
    _cuda.check_cuda_tensor("b", b, torch.float32, 1)
    bsz, h, wd, cin = x.shape
    cout, k, k2, cin_g = wk.shape
    if k != k2 or cin_g * groups != cin or cout % groups or m.shape[0] != cout or b.shape[0] != cout:
        raise ValueError(f"int8_conv: x {tuple(x.shape)}, wk {tuple(wk.shape)}, groups {groups} disagree")
    if cin_g % 4:
        raise ValueError(f"int8_conv: the kernel needs input channels per group a multiple of 4, got {cin_g}")
    if groups > 1 and (cout // groups) % TILE_CHANNELS:
        raise ValueError(f"int8_conv: grouped convs need output groups of a multiple of {TILE_CHANNELS} "
                         f"channels, got {cout // groups}")
    ho, wo = out_size(h, k, stride), out_size(wd, k, stride)
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.float32 if out_f32 else torch.int8, device=x.device)
    KERNEL.launch(_cuda.ptr(x), _cuda.ptr(wk), _cuda.ptr(m), _cuda.ptr(b), _cuda.ptr(out),
                  bsz, h, wd, cin, ho, wo, cout, k, stride, groups, int(relu), int(out_f32))
    return out
