"""Bytes and operations of one K5a launch (the int8 conv with its requant
epilogue), from the site's shapes: every operand read once (the int8
input and weights, the float32 multipliers, biases and the per-channel
clip bound where there is one) and the output written once (int8, or
float32 for a head); two operations a multiply-add over the compact
(per-group) weights. The same arithmetic as the program's kernel table
uses for K5a."""

from __future__ import annotations

import math


def conv_padding(k: int, padding=None):
    if padding is None:
        return (k // 2, k // 2), (k // 2, k // 2)
    (top, bottom), (left, right) = padding
    return (int(top), int(bottom)), (int(left), int(right))


def out_size(n: int, k: int, stride: int, pad) -> int:
    return (n + pad[0] + pad[1] - k) // stride + 1


def conv_numbers(x_shape, w_shape, stride: int, out_f32: bool, padding=None, clip: bool = False):
    """x (B, H, W, Cin) int8, w (k, k, Cin / groups, Cout) int8 -> (bytes, ops)."""
    b, h, w, _ = x_shape
    k, cout = w_shape[0], w_shape[3]
    pad_y, pad_x = conv_padding(k, padding)
    ho, wo = out_size(h, k, stride, pad_y), out_size(w, k, stride, pad_x)
    vectors = cout * 4 * (3 if clip else 2)
    nbytes = math.prod(x_shape) + math.prod(w_shape) + vectors + b * ho * wo * cout * (4 if out_f32 else 1)
    return nbytes, 2.0 * b * ho * wo * cout * k * k * w_shape[2]


class Tally:
    """Wraps the program's int8 conv entry to add up each launch's bytes and
    operations while installed (``with Tally(module): ...``)."""

    def __init__(self, module):
        self.module, self.bytes, self.ops, self.launches = module, 0.0, 0.0, 0

    def __enter__(self):
        self.orig = self.module.int8_conv

        def counted(x, w, m, b, stride=1, groups=1, relu=False, out_f32=False, wk=None, padding=None, lo=None):
            nb, ops = conv_numbers(tuple(x.shape), tuple(w.shape), stride, out_f32, padding, lo is not None)
            self.bytes += nb
            self.ops += ops
            self.launches += 1
            return self.orig(x, w, m, b, stride=stride, groups=groups, relu=relu, out_f32=out_f32, wk=wk,
                             padding=padding, lo=lo)

        self.module.int8_conv = counted
        return self

    def __exit__(self, *exc):
        self.module.int8_conv = self.orig
