"""Post-training int8 detection backbone, port of ``models/backbone_int8.py``.

FrozenBN makes every ConvFrozenBN a conv followed by a fixed affine, which
folds into per-output-channel int8 weights and an f32 requant epilogue:
the scheme of ``models/hrnet_int8.py`` (symmetric per-channel weights,
per-tensor activation scales calibrated by abs-max over a bf16 forward,
int32 sums, residual adds in f32 from int8 operands). The 7x7 stem stays
bf16 and its output is requantized; the res2..res5 outputs dequantize to
bf16 for the FPN, which ``GeneralizedRCNN.forward(precomputed_feats=...)``
takes in place of the bf16 backbone's.

Every int8 conv is kernel K5a (``ops/int8_conv.py``), which reads each
site's K-major ``w8k``: the holder of the tree packs it once
(``int8_conv.with_kmajor``, as ``serving.PoseServer`` does). The port's backbone
is the dense Caffe2 trunk (``groups=1``, stride in the 1x1), so the JAX
package's merged-group expansion has nothing to do here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import int8_conv
from ..ops.int8_conv import requant
from .hrnet_int8 import _f32, _hwio, _np, quantize_weights
from .resnet_backbone import RESNET_STAGE_BLOCKS, ResNetBackbone, ResNetConfig

Tensor = torch.Tensor
_EPS = 1e-5


def _structure(cfg: ResNetConfig):
    """(stage_name, block_name, stride, has_shortcut) rows in execution
    order, mirroring ResNetBackbone.forward."""
    rows = []
    for si, n_blocks in enumerate(RESNET_STAGE_BLOCKS[cfg.depth]):
        stride = 1 if si == 0 else 2
        for bi in range(n_blocks):
            rows.append((f"res{si + 2}", f"res{si + 2}_b{bi}", stride if bi == 0 else 1, bi == 0))
    return rows


def _fold_frozen(module) -> tuple[np.ndarray, np.ndarray]:
    """A ConvFrozenBN -> (HWIO weights with the affine folded in, bias)."""
    norm = module.norm
    mul = _np(norm.scale) * (1.0 / np.sqrt(_np(norm.var) + _EPS))
    add = _np(norm.bias) - _np(norm.mean) * mul
    return _hwio(module.conv.weight) * mul, add


def _backbone(model) -> ResNetBackbone:
    """A bare ResNetBackbone, or the one inside a GeneralizedRCNN."""
    return model if isinstance(model, ResNetBackbone) else model.backbone


def collect_backbone_scales(cfg: ResNetConfig, model, calib_x: Tensor) -> dict[str, float]:
    """Per-site activation scales (amax / 127) from a bf16 forward over the
    normalized (B, H, W, 3) ``calib_x``, named as the JAX package's sites."""
    backbone = _backbone(model)
    scales = {"input": max(float(calib_x.abs().max()), 1e-6) / 127.0}

    def amax(v: Tensor) -> float:
        return max(float(v.float().abs().max()), 1e-6) / 127.0

    sites = {"stem": backbone.stem}
    for _stage, blk, _stride, has_sc in _structure(cfg):
        block = getattr(backbone, blk)
        for part in ("conv1", "conv2", "conv3") + (("shortcut",) if has_sc else ()):
            sites[f"{blk}/{part}"] = getattr(block, part)
        sites[blk] = block  # block output (post residual relu)
    handles = [m.register_forward_hook(lambda _m, _i, out, name=name: scales.__setitem__(name, amax(out)))
               for name, m in sites.items()]
    try:
        with torch.inference_mode():
            backbone(calib_x.permute(0, 3, 1, 2).to(torch.bfloat16, memory_format=torch.channels_last))
    finally:
        for h in handles:
            h.remove()
    return scales


def quantize_backbone(cfg: ResNetConfig, model, calib_x: Tensor) -> dict:
    """The JAX package's quantized tree: per-conv {w8, m, b}, per-block add
    coeffs, the bf16 stem and the features' dequant scales (floats)."""
    backbone = _backbone(model)
    scales = collect_backbone_scales(cfg, backbone, calib_x)
    q: dict = {"convs": {}, "blocks": {}, "stem": {}, "feature_scales": {}}

    def quant_conv(site, module, in_scale):
        w, beta = _fold_frozen(module)
        w8, s_w = quantize_weights(w)
        s_out = scales[site]
        q["convs"][site] = {"w8": torch.from_numpy(w8), "m": _f32(in_scale * s_w / s_out), "b": _f32(beta / s_out)}
        return s_out

    w_stem, b_stem = _fold_frozen(backbone.stem)
    q["stem"] = {"w_bf16": _f32(w_stem).to(torch.bfloat16),
                 "m": _f32(np.full(w_stem.shape[-1], 1.0 / scales["stem"])), "b": _f32(b_stem / scales["stem"])}
    s_cur = scales["stem"]  # the max-pool keeps the scale
    for stage, blk, _stride, has_sc in _structure(cfg):
        block = getattr(backbone, blk)
        s_in = s_cur
        s1 = quant_conv(f"{blk}/conv1", block.conv1, s_in)
        s2 = quant_conv(f"{blk}/conv2", block.conv2, s1)
        s3 = quant_conv(f"{blk}/conv3", block.conv3, s2)
        ssc = quant_conv(f"{blk}/shortcut", block.shortcut, s_in) if has_sc else s_in
        s_out = scales[blk]
        q["blocks"][blk] = {"coeffs": torch.tensor([s3 / s_out, ssc / s_out], dtype=torch.float32)}
        s_cur = s_out
        q["feature_scales"][stage] = s_cur
    return q


def max_pool_i8(x: Tensor) -> Tensor:
    """3x3 / 2 max-pool with padding 1 of an int8 NHWC tensor, padded with
    -inf as flax's ``max_pool``; through float32, which holds int8 exactly."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def backbone_int8_apply(cfg: ResNetConfig, q: dict, x_norm: Tensor) -> dict[str, Tensor]:
    """x_norm: (B, H, W, 3) f32 normalized images (what the backbone sees
    inside GeneralizedRCNN), on the device of ``q``. Returns {res2..res5:
    (B, h, w, C) bf16 NHWC features} for the FPN."""
    stem = q["stem"]
    y = F.conv2d(x_norm.permute(0, 3, 1, 2).to(torch.bfloat16), stem["w_bf16"].permute(3, 2, 0, 1),
                 stride=2, padding=3)
    x = requant(torch.clamp_min(y.permute(0, 2, 3, 1).to(torch.float32) * stem["m"] + stem["b"], 0.0))
    x = max_pool_i8(x)
    convs = q["convs"]
    feats = {}
    for stage, blk, stride, has_sc in _structure(cfg):
        c1, c2, c3 = (convs[f"{blk}/conv{i}"] for i in (1, 2, 3))
        h1 = int8_conv.int8_conv(x, c1["w8"], c1["m"], c1["b"], stride=stride, relu=True,  # stride in the 1x1
                                 wk=c1.get("w8k"))
        h2 = int8_conv.int8_conv(h1, c2["w8"], c2["m"], c2["b"], relu=True, wk=c2.get("w8k"))
        # conv3 and the shortcut are requantized before the add, as the
        # JAX walk's _requant(f) does without fold_residual
        r3 = int8_conv.int8_conv(h2, c3["w8"], c3["m"], c3["b"], wk=c3.get("w8k"))
        if has_sc:
            sc = convs[f"{blk}/shortcut"]
            r = int8_conv.int8_conv(x, sc["w8"], sc["m"], sc["b"], stride=stride, wk=sc.get("w8k"))
        else:
            r = x
        coeffs = q["blocks"][blk]["coeffs"]
        x = requant(torch.clamp_min(r3.to(torch.float32) * coeffs[0] + r.to(torch.float32) * coeffs[1], 0.0))
        feats[stage] = x
    return {stage: (x.to(torch.float32) * q["feature_scales"][stage]).to(torch.bfloat16)
            for stage, x in feats.items()}
