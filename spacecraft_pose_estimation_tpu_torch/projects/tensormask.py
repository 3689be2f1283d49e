"""TensorMask's SwapAlign2Nat (port of ``projects/tensormask.py``).

Semantic contract of the reference ``projects/TensorMask/tensormask/layers/``
(swap_align2nat.py:32-56, csrc/SwapAlign2Nat), as the JAX module keeps it:
X (N, V, U, H, W), a V x U mask window per pixel (the "aligned"
representation), becomes (N, λV, λU, ceil(H / λ), ceil(W / λ)) ("natural",
unit lengths swapped), each value a quadrilinear resample of X at

    ov = (v + 0.5) / λ - 0.5,   ou = (u + 0.5) / λ - 0.5,
    oy = y · λ + v - λV / 2 + 0.5,   ox = x · λ + u - λU / 2 + 0.5,

16 taps (floor and ceil on each axis), a tap outside X reading ``pad_val``
(-6: sigmoid(-6) ~ 0, no mask outside). The JAX package computes it as an
XLA gather; here it is plain PyTorch, differentiable by autograd, with the
JAX function's order of terms.
"""

from __future__ import annotations

import torch
from torch import Tensor


def swap_align2nat(x: Tensor, lambda_val: int, pad_val: float = -6.0) -> Tensor:
    """(N, V, U, H, W) aligned -> (N, λV, λU, ceil(H / λ), ceil(W / λ))
    natural, float32."""
    if lambda_val < 1:
        raise ValueError(f"lambda_val must be >= 1, got {lambda_val}")
    n, vin, uin, hin, win = x.shape
    lam = float(lambda_val)
    vout, uout = lambda_val * vin, lambda_val * uin
    hout, wout = -(-hin // lambda_val), -(-win // lambda_val)
    ar = lambda k: torch.arange(k, dtype=torch.float32, device=x.device)  # noqa: E731
    v, u, y, xg = ar(vout), ar(uout), ar(hout), ar(wout)
    ov = (v + 0.5) / lam - 0.5  # (V',)
    ou = (u + 0.5) / lam - 0.5  # (U',)
    oy = y[None, :] * lam + v[:, None] - vout / 2.0 + 0.5  # (V', H')
    ox = xg[None, :] * lam + u[:, None] - uout / 2.0 + 0.5  # (U', W')

    def taps(o):
        f = torch.floor(o)
        wc = o - f
        return ((f.long(), 1.0 - wc), (torch.ceil(o).long(), wc))

    def gather(vi, ui, yi, xi):
        """vi (V',), ui (U',), yi (V', H'), xi (U', W') -> (N, V', U', H', W'), pad outside."""
        ok = (((vi >= 0) & (vi < vin))[:, None, None, None] & ((ui >= 0) & (ui < uin))[None, :, None, None]
              & ((yi >= 0) & (yi < hin))[:, None, :, None] & ((xi >= 0) & (xi < win))[None, :, None, :])
        val = x[:, vi.clamp(0, vin - 1)[:, None, None, None], ui.clamp(0, uin - 1)[None, :, None, None],
                yi.clamp(0, hin - 1)[:, None, :, None], xi.clamp(0, win - 1)[None, :, None, :]]
        return torch.where(ok[None], val, torch.full_like(val, pad_val))

    out = torch.zeros((n, vout, uout, hout, wout), dtype=torch.float32, device=x.device)
    for vi, vw in taps(ov):
        for ui, uw in taps(ou):
            for yi, yw in taps(oy):
                for xi, xw in taps(ox):
                    w = vw[:, None, None, None] * uw[None, :, None, None] * yw[:, None, :, None] * xw[None, :, None, :]
                    out = out + w[None] * gather(vi, ui, yi, xi)
    return out
