"""Post-training int8 HRNet (classic head), port of ``models/hrnet_int8.py``.

The scheme is the JAX package's: BatchNorm folded into the conv weights,
symmetric per-output-channel int8 weights, per-tensor int8 activation
scales calibrated by abs-max over a float forward, int32 sums with an f32
requant epilogue, residual and fuse sums in f32 from int8 operands, stem1
in bf16 and the final 1x1 emitting f32.

One walk, :func:`_forward`, mirrors ``HRNet.forward`` and is driven by two
op objects: :class:`_QuantizeOps` builds the quantized tree, :class:`_Int8Ops`
runs it. The int8 sites go to kernel K5a (``ops/int8_conv.py``) and, when
asked, whole block chains and exchanges go to K5, K6 and K7
(``ops/int8_blocks.py``). The quantized tree has the JAX package's keys and
layouts (HWIO weights), so ``convert.quantized_to_torch`` of a JAX tree runs
here unchanged.

Not ported yet (they raise ``NotImplementedError``): the space-to-depth
branch 0 (``s2d``), ``merge_fuse``, ``fold_residual``, ``fold_fuse_up`` and
``fused_even3``. One routing difference: the JAX walk keeps layer1 per-op
when the whole-image K6 would overflow the TPU's VMEM; here layer1 takes
the chain kernel whenever ``fused_blocks`` or ``layer1_strips`` is set.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import int8_blocks, int8_conv
from ..ops.int8_conv import requant
from ..pipeline import IMAGENET_MEAN, IMAGENET_STD
from .hrnet import BLOCKS, HRNet, HRNetConfig
from .layers import BN_EPS

Tensor = torch.Tensor


class _Handle(NamedTuple):
    """Dataflow token threaded through the walk."""

    value: Any  # int8 NHWC tensor (_Int8Ops) or None (_QuantizeOps)
    scale: Any  # activation scale of `value` (_QuantizeOps)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict; other leaves stay."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _np(t: Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _hwio(weight: Tensor) -> np.ndarray:
    """(out, in, kh, kw) conv weight -> HWIO float32."""
    return np.ascontiguousarray(_np(weight).transpose(2, 3, 1, 0))


def quantize_weights(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of an HWIO kernel: (w8, s_w)."""
    s_w = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(0), 1e-12) / 127.0
    return np.clip(np.round(w / s_w), -127, 127).astype(np.int8), s_w


def _f32(a) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


class _QuantizeOps:
    """Walk in 'collect' mode: folds BN, quantizes weights, computes the
    requant multipliers from the calibrated activation-scale table."""

    def __init__(self, model: HRNet, scales: dict[str, float]):
        self.model = model
        self.scales = scales  # site -> activation scale (amax / 127)
        self.q: dict = {"convs": {}, "adds": {}, "final": {}}

    def branch_chain(self, prefix, branch, nblocks, h):
        return None  # collect mode visits every per-op site

    def layer1_chain(self, nblocks, h):
        return None

    def fuse_exchange(self, prefix, i, ys, downs):
        return None

    def _module(self, name):
        return self.model.get_submodule(name.replace("/", "."))

    def has(self, name):
        try:
            self._module(name)
            return True
        except AttributeError:
            return False

    def _fold_bn(self, name):
        p = self._module(name)
        gamma_hat = _np(p.bn.scale) / np.sqrt(_np(p.bn.var) + BN_EPS)
        beta = _np(p.bn.bias) - _np(p.bn.mean) * gamma_hat
        return _hwio(p.conv.weight) * gamma_hat, beta

    def input_(self):
        return _Handle(None, float(self.scales["input"]))

    def stem_conv_bf16(self, name, h):
        """First conv stays bf16; output requantized to int8."""
        w, beta = self._fold_bn(name)
        s_out = float(self.scales[name])
        m = _f32(np.full(w.shape[-1], 1.0 / s_out))
        self.q["convs"][name] = {"w_bf16": _f32(w).to(torch.bfloat16), "m": m, "b": _f32(beta / s_out)}
        if name == "stem1":
            # the normalize-folded twin: consumes raw [0, 255] crops, with
            # the ImageNet (x - mean) / std absorbed into weights and bias
            mean = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
            std = np.asarray(IMAGENET_STD, np.float32) * 255.0
            wr = w / std[None, None, :, None]
            br = beta - (wr * mean[None, None, :, None]).sum((0, 1, 2))
            self.q.setdefault("convs_raw", {})[name] = {
                "w_bf16": _f32(wr).to(torch.bfloat16), "m": m.clone(), "b": _f32(br / s_out),
            }
        return _Handle(None, s_out)

    def convbn(self, name, h, stride, relu):
        w, beta = self._fold_bn(name)
        w8, s_w = quantize_weights(w)
        s_out = float(self.scales[name])
        self.q["convs"][name] = {"w8": torch.from_numpy(w8), "m": _f32(h.scale * s_w / s_out),
                                 "b": _f32(beta / s_out)}
        return _Handle(None, s_out)

    def add(self, name, hs, relu):
        s_out = float(self.scales[name])
        self.q["adds"][name] = {"coeffs": torch.tensor([h.scale / s_out for h in hs], dtype=torch.float32)}
        return _Handle(None, s_out)

    def upsample(self, h, factor):
        return h

    def final(self, name, h):
        p = self._module(name)
        w8, s_w = quantize_weights(_hwio(p.weight))
        self.q["final"] = {"w8": torch.from_numpy(w8), "m": _f32(h.scale * s_w), "b": _f32(_np(p.bias))}
        return None


class _Int8Ops:
    """Walk in 'execute' mode over the quantized tree of an :class:`HRNetInt8`."""

    def __init__(self, model: "HRNetInt8", x: Tensor):
        self.m = model
        self.q = model.q
        self.x = x

    def has(self, name):
        return name in self.q["convs"]

    def input_(self):
        return _Handle(self.x, None)

    def stem_conv_bf16(self, name, h):
        c = (self.q["convs_raw"] if self.m.fold_normalize else self.q["convs"])[name]
        y = F.conv2d(h.value.permute(0, 3, 1, 2).to(torch.bfloat16), c["w_bf16"].permute(3, 2, 0, 1),
                     stride=2, padding=1)
        f = torch.clamp_min(y.permute(0, 2, 3, 1).to(torch.float32) * c["m"] + c["b"], 0.0)
        return _Handle(requant(f).contiguous(), None)

    def convbn(self, name, h, stride, relu):
        c = self.q["convs"][name]
        return _Handle(int8_conv.int8_conv(h.value, c["w8"], c["m"], c["b"], stride=stride, relu=relu,
                                           wk=c.get("w8k")), None)

    def add(self, name, hs, relu):
        coeffs = self.q["adds"][name]["coeffs"]
        f = hs[0].value.to(torch.float32) * coeffs[0]
        for i, h in enumerate(hs[1:], 1):
            f = f + h.value.to(torch.float32) * coeffs[i]
        if relu:
            f = torch.clamp_min(f, 0.0)
        return _Handle(requant(f), None)

    def upsample(self, h, factor):
        v = h.value.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
        return _Handle(v, None)

    def final(self, name, h):
        c = self.q["final"]
        if c["w8"].shape[0] != 1:
            raise NotImplementedError("the int8 head is a 1x1 conv (final_conv_kernel=1)")
        return int8_conv.int8_conv(h.value, c["w8"], c["m"], c["b"], out_f32=True, wk=c.get("w8k"))

    def branch_chain(self, prefix, branch, nblocks, h):
        """A module branch's BasicBlock chain as one K5 launch."""
        width_ok = self.m.fused_min_width is not None and h.value.shape[-1] >= self.m.fused_min_width
        if not (self.m.fused_blocks or width_ok):
            return None
        packed = self.m.packed(("chain", prefix, branch),
                               lambda: int8_blocks.chain_params_from_q(self.q, prefix, branch, nblocks))
        if packed is None:
            return None
        w, m, b, coeffs, wk = packed
        out = int8_blocks.basic_block_chain(h.value, w, m, b, coeffs, nblocks, wk=wk)
        return _Handle(out, None)

    def layer1_chain(self, nblocks, h):
        """layer1's Bottlenecks as one K6 launch: 32-row strips as the JAX
        strips kernel (K6s) takes them, or the kernel's default strips."""
        strips = self.m.layer1_strips and h.value.shape[1] % 32 == 0
        if not (strips or self.m.fused_blocks):
            return None
        p = self.m.packed(("layer1",), lambda: int8_blocks.bottleneck_params_from_q(self.q, nblocks))
        if p is None:
            return None
        out = int8_blocks.bottleneck_chain(h.value, **p, nblocks=nblocks, strip=32 if strips else None)
        return _Handle(out, None)

    def fuse_exchange(self, prefix, i, ys, downs):
        """Exchange output i (up 1x1s, nearest upsample, n-way add) as one K7 launch."""
        if not (self.m.fuse_exchange and self.m.fused_blocks):
            return None
        ops = int8_blocks.up_exchange_operands(self.q, prefix, i, [y.value for y in ys])
        if ops is None:
            return None
        ups, coeffs, wks = ops
        out = int8_blocks.up_exchange(ys[i].value, [d.value for d in downs], ups, coeffs, wks=wks)
        return _Handle(out, None)


def _forward(ops, cfg: HRNetConfig):
    """The classic-head HRNet structure (mirrors HRNet.forward)."""
    h = ops.input_()
    h = ops.stem_conv_bf16("stem1", h)
    h = ops.convbn("stem2", h, 2, True)
    fused_l1 = ops.layer1_chain(cfg.stage1_blocks, h)
    if fused_l1 is not None:
        h = fused_l1
    else:
        for i in range(cfg.stage1_blocks):
            hin = h
            y = ops.convbn(f"layer1/block{i}/conv1", hin, 1, True)
            y = ops.convbn(f"layer1/block{i}/conv2", y, 1, True)
            y = ops.convbn(f"layer1/block{i}/conv3", y, 1, False)
            r = ops.convbn(f"layer1/block{i}/down", hin, 1, False) if ops.has(f"layer1/block{i}/down") else hin
            h = ops.add(f"layer1/block{i}", [y, r], True)
    xs = [h]
    for si, spec in enumerate((cfg.stage2, cfg.stage3, cfg.stage4)):
        widths = [c * BLOCKS[spec.block].expansion for c in spec.num_channels]
        n_pre = len(xs)
        new_xs = []
        for i in range(len(widths)):
            if i < n_pre:
                name = f"transition{si + 1}/adapt{i}"
                new_xs.append(ops.convbn(name, xs[i], 1, True) if ops.has(name) else xs[i])
            else:
                y = xs[-1]
                for j in range(i + 1 - n_pre):
                    y = ops.convbn(f"transition{si + 1}/new{i}_{j}", y, 2, True)
                new_xs.append(y)
        xs = new_xs
        last_stage = si == 2
        for m in range(spec.num_modules):
            multi = not (last_stage and m == spec.num_modules - 1)
            prefix = f"stage{si + 2}_m{m}"
            ys = []
            for bi in range(len(xs)):
                hcur = xs[bi]
                fused = ops.branch_chain(prefix, bi, spec.num_blocks[bi], hcur)
                if fused is not None:
                    ys.append(fused)
                    continue
                for k in range(spec.num_blocks[bi]):
                    bn = f"{prefix}/branch{bi}/block{k}"
                    y = ops.convbn(f"{bn}/conv1", hcur, 1, True)
                    y = ops.convbn(f"{bn}/conv2", y, 1, False)
                    if ops.has(f"{bn}/down"):
                        hcur = ops.convbn(f"{bn}/down", hcur, 1, False)
                    hcur = ops.add(bn, [y, hcur], True)
                ys.append(hcur)
            if len(ys) == 1:
                xs = ys
                continue
            outs = []
            for i in range(len(ys) if multi else 1):
                # down chains stay per-op (strided convs, small outputs); the
                # up 1x1s + upsamples + n-way add can run as one K7 launch
                downs = []
                for j in range(i):
                    y = ys[j]
                    for k in range(i - j):
                        y = ops.convbn(f"{prefix}/fuse/down{i}_{j}_{k}", y, 2, k != i - j - 1)
                    downs.append(y)
                fused_out = ops.fuse_exchange(prefix, i, ys, downs)
                if fused_out is not None:
                    outs.append(fused_out)
                    continue
                acc = [ys[i]]
                ai = 0
                for j in range(len(ys)):
                    if j == i:
                        continue
                    if j > i:
                        y = ops.convbn(f"{prefix}/fuse/up{i}_{j}", ys[j], 1, False)
                        y = ops.upsample(y, 2 ** (j - i))
                    else:
                        y = downs[ai]
                        ai += 1
                    acc.append(y)
                outs.append(ops.add(f"{prefix}/fuse/out{i}", acc, True))
            xs = outs
    return ops.final("final_layer", xs[0])


def _collect_scales(model: HRNet, calib_x: Tensor) -> dict[str, float]:
    """Abs-max activation scale (amax / 127) of every module's output in a
    forward over ``calib_x``, named as the JAX package's captured
    intermediates: the module path with '/' separators, and
    '<path>/out{i}' for each element of a module that returns a list
    (transitions, HR modules, fuse layers)."""
    scales: dict[str, float] = {"input": float(calib_x.abs().max()) / 127.0}

    def amax(v: Tensor) -> float:
        return max(float(v.float().abs().max()) / 127.0, 1e-12)

    def hook(name):
        def record(_module, _inputs, out):
            if isinstance(out, (list, tuple)):
                for i, o in enumerate(out):
                    scales[f"{name}/out{i}"] = amax(o)
            else:
                scales[name] = amax(out)
        return record

    handles = [m.register_forward_hook(hook(name.replace(".", "/")))
               for name, m in model.named_modules() if name]
    try:
        with torch.inference_mode():
            model(calib_x)
    finally:
        for h in handles:
            h.remove()
    return scales


def quantize_hrnet(model: HRNet, calib_x: Tensor, s2d: bool = False) -> dict:
    """Calibrate over ``calib_x`` (normalized (B, H, W, 3) crops on the
    model's device) and quantize. Returns the JAX package's tree
    ({convs, convs_raw, adds, final, in_scale}) of CPU tensors."""
    if model.config.head != "classic":
        raise NotImplementedError("int8 path covers the classic head only")  # as the JAX quantizer
    if s2d:
        raise NotImplementedError("the space-to-depth branch 0 (s2d) is not ported yet")
    scales = _collect_scales(model, calib_x)
    ops = _QuantizeOps(model, scales)
    _forward(ops, model.config)
    ops.q["in_scale"] = torch.tensor(scales["input"], dtype=torch.float32)
    return ops.q


class HRNetInt8(nn.Module):
    """The int8 HRNet over a quantized tree ``q``: (B, H, W, 3) normalized
    f32 crops, or raw [0, 255] crops with ``fold_normalize``, -> (B, H / 4,
    W / 4, J) f32 heatmaps.

    ``fused_blocks`` runs each module branch as K5 and layer1 as K6;
    ``layer1_strips`` runs layer1 as K6 in 32-row strips (K6s);
    ``fused_min_width`` fuses only branches at least that wide;
    ``fuse_exchange`` (with ``fused_blocks``) runs the fuse exchanges as K7.
    ``q`` is moved to ``device`` (CUDA unless given), which the module keeps
    as ``self.device``: it holds no parameters. Every int8 site gets its
    K-major weights ``w8k`` beside ``w8`` here, once (``int8_conv.with_kmajor``),
    which K5a and K7 read; K5's and K6's packed operands (with their K-major
    copies) are built at their first call and kept (:meth:`packed`).
    """

    def __init__(self, config: HRNetConfig, q: dict, fused_blocks: bool = False,
                 layer1_strips: bool = False, fused_min_width: int | None = None,
                 fold_normalize: bool = False, fuse_exchange: bool = False, device=None,
                 s2d: bool = False, merge_fuse: bool = False, fold_residual: bool = False,
                 fold_fuse_up: bool = False, fused_even3: bool = False):
        super().__init__()
        for flag, on in (("s2d", s2d), ("merge_fuse", merge_fuse), ("fold_residual", fold_residual),
                         ("fold_fuse_up", fold_fuse_up), ("fused_even3", fused_even3)):
            if on:
                raise NotImplementedError(f"HRNetInt8: {flag} is not ported yet")
        self.config = config
        self.fused_blocks, self.layer1_strips = fused_blocks, layer1_strips
        self.fused_min_width, self.fold_normalize = fused_min_width, fold_normalize
        self.fuse_exchange = fuse_exchange
        self.device = resolve_device(device)
        self.q = int8_conv.with_kmajor(tree_map(lambda t: t.to(self.device), q))
        self._packed: dict = {}

    @property
    def consumes_raw_pixels(self) -> bool:
        """True when forward expects raw [0, 255] crops (normalize folded into stem1)."""
        return self.fold_normalize

    def packed(self, key, build):
        """Kernel operands gathered from ``q`` once and kept."""
        if key not in self._packed:
            self._packed[key] = build()
        return self._packed[key]

    @torch.inference_mode()
    def forward(self, x: Tensor) -> Tensor:
        return _forward(_Int8Ops(self, x), self.config)
