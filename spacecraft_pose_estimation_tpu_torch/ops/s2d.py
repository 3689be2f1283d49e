"""Space-to-depth conv formulations of HRNet's high-resolution branch (port of ``ops/s2d.py``).

Branch 0 (32 channels at 128^2 in HRNet-W32) can run with its activations
packed 2x2 cells -> channels, so each of its convs is a conv over 4C
channels (the JAX package packs for the TPU's 128 lanes; on the card the
packed convs run K5a's TN = 128 tile instead of TN = 32). The layouts, the
JAX package's:

* even packing: cell (I, J) holds pixels (2I + dy, 2J + dx), dy, dx in
  {0, 1} -> (B, H / 2, W / 2, 4C);
* odd packing: cell (I, J) holds pixels (2I - 1 + dy, 2J - 1 + dx) ->
  (B, H / 2 + 1, W / 2 + 1, 4C); the slots of rows -1 and H (cols -1 and
  W) are structural zeros (:func:`odd_zero_mask`).

Packed channel index = (2 dy + dx) C + c (position-major).

The weight packs are pure index scatters of the int8 weights (numpy, copies
of the JAX package's), so a packed conv sums the same multiset of int32
products as the direct conv: bit-equal. The packed convs are K5a
(:func:`..int8_conv.int8_conv`) with the JAX convs' strides and paddings and
the requant epilogue fused; on CPU tensors its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import int8_conv

Tensor = torch.Tensor


# --------------------------------------------------------------------------- activation packing


def pack_even(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H / 2, W / 2, 4C) even-aligned cell packing, contiguous."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)  # B, H2, W2, dy, dx, C
    return y.reshape(b, h // 2, w // 2, 4 * c)


def unpack_even(y: Tensor) -> Tensor:
    """(B, H2, W2, 4C) -> (B, 2 H2, 2 W2, C), contiguous."""
    b, h2, w2, c4 = y.shape
    x = y.reshape(b, h2, w2, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c4 // 4)


def odd_zero_mask(h2p: int, w2p: int, c: int, dtype=torch.float32, device=None) -> Tensor:
    """(h2p, w2p, 4C) mask zeroing the out-of-image slots of an odd-packed
    tensor (rows -1 / H, cols -1 / W); h2p = H / 2 + 1, w2p = W / 2 + 1."""
    rows = torch.arange(h2p, device=device)[:, None, None]
    cols = torch.arange(w2p, device=device)[None, :, None]
    pos = torch.arange(4 * c, device=device)[None, None, :] // c
    dy, dx = pos // 2, pos % 2
    ok_r = ((rows > 0) | (dy == 1)) & ((rows < h2p - 1) | (dy == 0))
    ok_c = ((cols > 0) | (dx == 1)) & ((cols < w2p - 1) | (dx == 0))
    return (ok_r & ok_c).to(dtype)


def upsample_std_to_even(u: Tensor, factor: int) -> Tensor:
    """Nearest-upsample a standard (B, h, w, C) tensor by ``factor`` and
    deliver it even-packed at resolution factor * h: a spatial nearest
    upsample by factor / 2, then the 2x2 cell replication as a 4x channel tile."""
    if factor > 2:
        f = factor // 2
        u = u.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    return u.repeat(1, 1, 1, 4)


# --------------------------------------------------------------------------- weight packs (numpy)


def w3_pack_alt(w3) -> np.ndarray:
    """3x3 (3, 3, C, C') -> 2x2 packed (2, 2, 4C, 4C') for the alternating
    convs (even -> odd with padding (1, 1), odd -> even with none; one
    scatter serves both). Tap ky = 2 di + dyi - dyo (kx alike); taps
    outside 0..2 are zero."""
    w3 = np.asarray(w3)
    assert w3.shape[:2] == (3, 3)
    cin, cout = w3.shape[2], w3.shape[3]
    out = np.zeros((2, 2, 4 * cin, 4 * cout), dtype=w3.dtype)
    for di in range(2):
        for dj in range(2):
            for dyi in range(2):
                for dxi in range(2):
                    for dyo in range(2):
                        for dxo in range(2):
                            ky, kx = 2 * di + dyi - dyo, 2 * dj + dxi - dxo
                            if 0 <= ky <= 2 and 0 <= kx <= 2:
                                pin, pout = 2 * dyi + dxi, 2 * dyo + dxo
                                out[di, dj, pin * cin:(pin + 1) * cin, pout * cout:(pout + 1) * cout] = w3[ky, kx]
    return out


def w3_pack_from_std(w3, stride: int = 1) -> np.ndarray:
    """3x3 (3, 3, C, C') on a standard input -> (4, 4, C, 4C'): a stride-2
    conv with padding (1, 1) whose output is the even-packed 3x3 output
    (the entry into the packed domain, transition1/adapt0)."""
    assert stride == 1
    w3 = np.asarray(w3)
    cin, cout = w3.shape[2], w3.shape[3]
    out = np.zeros((4, 4, cin, 4 * cout), dtype=w3.dtype)
    for ky4 in range(4):
        for kx4 in range(4):
            for dyo in range(2):
                for dxo in range(2):
                    ky, kx = ky4 - dyo, kx4 - dxo
                    if 0 <= ky <= 2 and 0 <= kx <= 2:
                        pout = 2 * dyo + dxo
                        out[ky4, kx4, :, pout * cout:(pout + 1) * cout] = w3[ky, kx]
    return out


def w3_pack_down(w3) -> np.ndarray:
    """3x3 stride-2 (3, 3, C, C') from an even-packed input -> (2, 2, 4C, C'),
    a stride-1 conv with padding (1, 0) whose output is the standard
    half-resolution one (the exit, the fuse down chains). ky = 2 di + dyi - 1."""
    w3 = np.asarray(w3)
    cin, cout = w3.shape[2], w3.shape[3]
    out = np.zeros((2, 2, 4 * cin, cout), dtype=w3.dtype)
    for di in range(2):
        for dj in range(2):
            for dyi in range(2):
                for dxi in range(2):
                    ky, kx = 2 * di + dyi - 1, 2 * dj + dxi - 1
                    if 0 <= ky <= 2 and 0 <= kx <= 2:
                        pin = 2 * dyi + dxi
                        out[di, dj, pin * cin:(pin + 1) * cin, :] = w3[ky, kx]
    return out


def w1_pack(w1) -> np.ndarray:
    """1x1 (C, C') or (1, 1, C, C') -> block-diagonal (1, 1, 4C, 4C')."""
    w1 = np.asarray(w1)
    if w1.ndim == 4:
        w1 = w1[0, 0]
    cin, cout = w1.shape
    out = np.zeros((1, 1, 4 * cin, 4 * cout), dtype=w1.dtype)
    for p in range(4):
        out[0, 0, p * cin:(p + 1) * cin, p * cout:(p + 1) * cout] = w1
    return out


def tile_vec(v) -> np.ndarray:
    """Per-output-channel vector (C',) -> packed (4C',)."""
    return np.tile(np.asarray(v), 4)


def w3_pack_even3(w3) -> np.ndarray:
    """3x3 (3, 3, C, C') -> 3x3 packed (3, 3, 4C, 4C'), an even -> even conv
    with padding (1, 1): 4x the direct conv's multiply-adds (a 3x3-cell
    window covers 6x6 pixels of which 4x4 are used), no odd intermediate.
    ky = 2 di + dyi - dyo - 1."""
    w3 = np.asarray(w3)
    cin, cout = w3.shape[2], w3.shape[3]
    out = np.zeros((3, 3, 4 * cin, 4 * cout), dtype=w3.dtype)
    for di in range(3):
        for dj in range(3):
            for dyi in range(2):
                for dxi in range(2):
                    for dyo in range(2):
                        for dxo in range(2):
                            ky, kx = 2 * di + dyi - dyo - 1, 2 * dj + dxi - dxo - 1
                            if 0 <= ky <= 2 and 0 <= kx <= 2:
                                pin, pout = 2 * dyi + dxi, 2 * dyo + dxo
                                out[di, dj, pin * cin:(pin + 1) * cin, pout * cout:(pout + 1) * cout] = w3[ky, kx]
    return out


# --------------------------------------------------------------------------- packed convs (K5a)
#
# Each takes the packed int8 weights w (HWIO), the requant vectors m, b of
# its output channels and the kernel's K-major copy wk, and returns relu?(y
# m + b) requantized to int8 (f32 with out_f32).


def conv_even_to_odd(x_even: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
                     wk: Tensor | None = None) -> Tensor:
    """(B, H2, W2, 4C) even -> (B, H2 + 1, W2 + 1, 4C') odd. The caller zeros
    the structural slots (:func:`odd_zero_mask`)."""
    return int8_conv.int8_conv(x_even, w, m, b, relu=relu, out_f32=out_f32, wk=wk, padding=((1, 1), (1, 1)))


def conv_odd_to_even(x_odd: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
                     wk: Tensor | None = None) -> Tensor:
    """(B, H2 + 1, W2 + 1, 4C) odd -> (B, H2, W2, 4C') even (no padding)."""
    return int8_conv.int8_conv(x_odd, w, m, b, relu=relu, out_f32=out_f32, wk=wk, padding=((0, 0), (0, 0)))


def conv_std_to_even(x_std: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
                     wk: Tensor | None = None) -> Tensor:
    """(B, H, W, C) standard -> (B, H / 2, W / 2, 4C') even (k 4, stride 2)."""
    return int8_conv.int8_conv(x_std, w, m, b, stride=2, relu=relu, out_f32=out_f32, wk=wk, padding=((1, 1), (1, 1)))


def conv_even_down(x_even: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
                   wk: Tensor | None = None) -> Tensor:
    """(B, H2, W2, 4C) even -> (B, H2, W2, C') standard half resolution (the
    packed 3x3 stride-2 conv)."""
    return int8_conv.int8_conv(x_even, w, m, b, relu=relu, out_f32=out_f32, wk=wk, padding=((1, 0), (1, 0)))


def conv_even_1x1(x_even: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
                  wk: Tensor | None = None) -> Tensor:
    """Block-diagonal 1x1: even -> even."""
    return int8_conv.int8_conv(x_even, w, m, b, relu=relu, out_f32=out_f32, wk=wk, padding=((0, 0), (0, 0)))


def conv_even3(x_even: Tensor, w: Tensor, m: Tensor, b: Tensor, relu: bool = False, out_f32: bool = False,
               wk: Tensor | None = None) -> Tensor:
    """(B, H2, W2, 4C) even -> (B, H2, W2, 4C') even (3x3, padding (1, 1))."""
    return int8_conv.int8_conv(x_even, w, m, b, relu=relu, out_f32=out_f32, wk=wk, padding=((1, 1), (1, 1)))
