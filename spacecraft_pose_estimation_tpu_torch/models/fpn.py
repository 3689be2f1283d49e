"""Feature Pyramid Network, with or without the LastLevelMaxPool p6 (port of ``models/fpn.py``)."""

from __future__ import annotations

from torch import nn

from .layers import Conv, upsample_nearest

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


class FPN(nn.Module):
    """1x1 laterals, nearest top-down sum, 3x3 outputs and, with
    ``last_level_max_pool``, p6 = p5[::2, ::2].

    Takes and returns NCHW dicts. The levels of ``in_channels`` feed the
    pyramid (the JAX module's ``in_levels``): {res2..res5} -> {p2..p6} for
    the Faster R-CNN; RetinaNet's {res3..res5} -> {p3..p5}, without the
    max-pool (it builds learned p6 and p7 itself).
    """

    def __init__(self, in_channels: dict[str, int], out_channels: int = 256, last_level_max_pool: bool = True):
        super().__init__()
        self.last_level_max_pool = last_level_max_pool
        self.names = sorted(in_channels)  # fine -> coarse
        for n in self.names:
            self.add_module(f"lateral_{n}", Conv(in_channels[n], out_channels, 1))
            self.add_module(f"output_p{int(n[3:])}", Conv(out_channels, out_channels, 3, 1, 1))

    def forward(self, feats: dict):
        laterals = [getattr(self, f"lateral_{n}")(feats[n]) for n in self.names]
        outs = [None] * len(laterals)
        prev = outs[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            prev = laterals[i] + upsample_nearest(prev, 2)
            outs[i] = prev
        results = {}
        for n, o in zip(self.names, outs):
            p = f"p{int(n[3:])}"
            results[p] = getattr(self, f"output_{p}")(o)
        if self.last_level_max_pool:  # a 1x1 max-pool at stride 2 is a strided slice
            results["p6"] = results["p5"][:, :, ::2, ::2]
        return results
