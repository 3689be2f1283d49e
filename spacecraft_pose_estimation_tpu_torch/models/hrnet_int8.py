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

The walk's options are the JAX package's. Each handle carries a layout:
``std``, the space-to-depth cell packings ``even`` and ``odd`` of branch 0
(``s2d``, ``ops/s2d.py``; K5a on the packed sites, and with ``fused_even3``
K5 on the even3-packed chains), or ``f32pre``, a conv's pre-round f32
epilogue handed to its add (``fold_residual``, and through the fuse
upsample with ``fold_fuse_up``). ``merge_fuse`` runs the fuse convs that
read one branch as one K5a launch with a per-channel lower clip bound.
``s2d``, ``fused_even3`` and ``merge_fuse`` are bit-equal to the per-op
walk; the folds skip one rounding and are held to it by the JAX package's
bars. Two routing differences: the JAX walk keeps layer1 per-op when the
whole-image K6 would overflow the TPU's VMEM, where here layer1 takes the
chain kernel whenever ``fused_blocks`` or ``layer1_strips`` is set; and K7
(``fuse_exchange``) takes int8 operands only, so an exchange that fold
hands an f32 operand runs per op (the JAX exchange kernel is off unless a
debug variable turns it on).
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import int8_blocks, int8_conv, s2d as s2d_ops
from ..ops.int8_conv import pack_kmajor, requant
from ..pipeline import IMAGENET_MEAN, IMAGENET_STD
from .hrnet import BLOCKS, HRNet, HRNetConfig
from .layers import BN_EPS

Tensor = torch.Tensor


class _Handle(NamedTuple):
    """Dataflow token threaded through the walk."""

    value: Any  # int8 NHWC tensor (_Int8Ops), f32 for 'f32pre', or None (_QuantizeOps)
    scale: Any  # activation scale of `value` (_QuantizeOps)
    layout: str = "std"  # 'std', the s2d packings 'even' / 'odd', or 'f32pre'


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

    def upsample(self, h, factor, like=None):
        return h

    def final(self, name, h):
        p = self._module(name)
        w8, s_w = quantize_weights(_hwio(p.weight))
        self.q["final"] = {"w8": torch.from_numpy(w8), "m": _f32(h.scale * s_w), "b": _f32(_np(p.bias))}
        return None


class _Int8Ops:
    """Walk in 'execute' mode over the quantized tree of an :class:`HRNetInt8`."""

    _UP_RE = re.compile(r"^(?P<p>.+)/fuse/up(?P<i>\d+)_(?P<j>\d+)$")
    _DN0_RE = re.compile(r"^(?P<p>.+)/fuse/down(?P<i>\d+)_(?P<j>\d+)_0$")

    def __init__(self, model: "HRNetInt8", x: Tensor):
        self.m = model
        self.q = model.q
        self.x = x
        self._merge_cache: dict[str, _Handle] = {}  # merge_fuse: each family member's slice, this forward

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
        """The routes of the JAX walk, in its order: a merged fuse family,
        then a packed s2d site, then the std site, whose output is the
        pre-round f32 (``f32pre``) where fold hands it to an add."""
        if self.m.merge_fuse:
            mh = self._merged_fuse_conv(name, h, stride, relu)
            if mh is not None:
                return mh
        if self.m.s2d:
            c2 = self.q["convs_s2d"].get(name)
            if c2 is not None:
                return self._convbn_s2d(h, stride, relu, c2)
        c = self.q["convs"][name]
        x = h.value if h.layout == "std" else self._requant(h).value
        # the consumer is a residual or fuse add at the same resolution
        fold = (self.m.fold_residual and not relu and ("/fuse/up" not in name or self.m.fold_fuse_up)
                and h.layout == "std")
        y = int8_conv.int8_conv(x, c["w8"], c["m"], c["b"], stride=stride, relu=relu, out_f32=fold,
                                wk=c.get("w8k"))
        return _Handle(y, None, "f32pre" if fold else "std")

    def _merged_fuse_conv(self, name, h, stride, relu):
        """One K5a launch for all fuse convs reading branch j (the up{i}_{j}
        1x1s, or the down{i}_{j}_0 stride-2 3x3s), sliced per member. Each
        output channel keeps its own sum and requant vectors, and a
        family's mixed relu flags (a down chain's first conv is relu unless
        it is also the last) become a per-channel lower clip bound:
        relu-before-round equals clip-at-0-after-round. None (the per-op
        route) for other sites, one-member families, and when s2d or fold
        re-route these sites, as the JAX walk."""
        if self.m.s2d or self.m.fold_residual or h.layout != "std":
            return None
        cached = self._merge_cache.get(name)
        if cached is not None:
            return cached
        m_up = self._UP_RE.match(name)
        m_dn = None if m_up else self._DN0_RE.match(name)
        match = m_up or m_dn
        if match is None:
            return None
        p, j = match.group("p"), int(match.group("j"))
        if m_up:
            fam = [(f"{p}/fuse/up{i}_{j}", False) for i in range(j) if f"{p}/fuse/up{i}_{j}" in self.q["convs"]]
        else:
            fam = [(f"{p}/fuse/down{i}_{j}_0", i - j > 1) for i in range(j + 1, j + 9)
                   if f"{p}/fuse/down{i}_{j}_0" in self.q["convs"]]
        if len(fam) < 2:
            return None
        if dict(fam)[name] != relu:
            raise ValueError(f"merge_fuse: {name} is walked with relu={relu}, its family says otherwise")
        w, m, b, lo, wk = self.m.packed(("merge", p, "up" if m_up else "down", j),
                                        lambda: _merged_fuse_operands(self.q, fam))
        q8 = int8_conv.int8_conv(h.value, w, m, b, stride=stride, wk=wk, lo=lo)
        off = 0
        for s, _ in fam:
            width = self.q["convs"][s]["w8"].shape[-1]
            self._merge_cache[s] = _Handle(q8[..., off:off + width].contiguous(), None)
            off += width
        return self._merge_cache[name]

    def _requant(self, h):
        """Round an f32pre handle back to int8 (for a consumer other than
        ``add``; unused on the standard walk)."""
        if h.layout != "f32pre":
            raise ValueError(f"a std int8 site got a {h.layout} input")
        return _Handle(requant(h.value), None)

    def _convbn_s2d(self, h, stride, relu, c2):
        """A packed branch-0 site (``ops/s2d.py``), bit-equal to the std int8
        walk. The conv follows from (layout, stride): a std input is the
        entry (k 4, stride 2, even out); a packed input at stride 2 the down
        (std half-resolution out); an even input with a 3x3 twin the even3
        conv; else the alternating 2x2 convs even -> odd -> even, the odd
        output's structural slots zeroed."""
        args = (c2["w8p"], c2["m"], c2["b"], relu)
        wk = c2.get("w8pk")
        if h.layout == "std":
            if c2["w8p"].shape[0] != 4:
                raise ValueError(f"s2d: a std input reaches a packed site of kernel {c2['w8p'].shape[0]}")
            return _Handle(s2d_ops.conv_std_to_even(h.value, *args, wk=wk), None, "even")
        if h.layout not in ("even", "odd") or (stride == 2 and h.layout != "even"):
            raise ValueError(f"s2d: a packed site got a {h.layout} input at stride {stride}")
        if stride == 2:
            return _Handle(s2d_ops.conv_even_down(h.value, *args, wk=wk), None)
        if h.layout == "even" and c2["w8p"].shape[0] == 3:
            return _Handle(s2d_ops.conv_even3(h.value, *args, wk=wk), None, "even")
        if h.layout == "even":
            y = s2d_ops.conv_even_to_odd(h.value, *args, wk=wk)
            _, hp, wp, c4 = y.shape
            mask = self.m.packed(("odd_mask", hp, wp, c4),
                                 lambda: s2d_ops.odd_zero_mask(hp, wp, c4 // 4, torch.int8, y.device))
            return _Handle(y * mask, None, "odd")
        return _Handle(s2d_ops.conv_odd_to_even(h.value, *args, wk=wk), None, "even")

    def add(self, name, hs, relu):
        """f32pre operands are real values in their site's scale units
        already; int8 ones widen. The output takes the operands' packing."""
        coeffs = self.q["adds"][name]["coeffs"]
        f = hs[0].value.to(torch.float32) * coeffs[0]
        for i, h in enumerate(hs[1:], 1):
            f = f + h.value.to(torch.float32) * coeffs[i]
        if relu:
            f = torch.clamp_min(f, 0.0)
        return _Handle(requant(f), None, next((h.layout for h in hs if h.layout != "f32pre"), "std"))

    def upsample(self, h, factor, like=None):
        """Nearest upsample; delivered even-packed where the target branch is
        packed; an f32pre value stays f32pre for its add."""
        if like is not None and like.layout == "even":
            return _Handle(s2d_ops.upsample_std_to_even(h.value, factor), None, "even")
        v = h.value.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
        return _Handle(v, None, "f32pre" if h.layout == "f32pre" else "std")

    def final(self, name, h):
        if h.layout == "even":  # the block-diagonal 1x1 on the packed map, then unpacked
            c = self.q["final_s2d"]
            f = s2d_ops.conv_even_1x1(h.value, c["w8p"], c["m"], c["b"], out_f32=True, wk=c.get("w8pk"))
            return s2d_ops.unpack_even(f)
        if h.layout != "std":
            raise ValueError(f"the int8 head got a {h.layout} input")
        c = self.q["final"]
        if c["w8"].shape[0] != 1:
            raise NotImplementedError("the int8 head is a 1x1 conv (final_conv_kernel=1)")
        return int8_conv.int8_conv(h.value, c["w8"], c["m"], c["b"], out_f32=True, wk=c.get("w8k"))

    def branch_chain(self, prefix, branch, nblocks, h):
        """A module branch's BasicBlock chain as one K5 launch: the even3-packed
        chain of an even branch with ``fused_even3``, or a std branch's."""
        if h.layout == "even" and self.m.fused_even3:
            packed = self.m.packed(("chain_even3", prefix, branch),
                                   lambda: int8_blocks.chain_params_even3_from_q(self.q, prefix, branch, nblocks))
            if packed is not None:
                w, m, b, coeffs, wk = packed
                return _Handle(int8_blocks.basic_block_chain(h.value, w, m, b, coeffs, nblocks, wk=wk), None, "even")
        if h.layout != "std":
            return None
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
        """Exchange output i (up 1x1s, nearest upsample, n-way add) as one K7
        launch, on int8 std operands only: a packed branch or an f32pre down
        runs per op."""
        if not (self.m.fuse_exchange and self.m.fused_blocks) or any(y.layout != "std" for y in (*ys, *downs)):
            return None
        ops = int8_blocks.up_exchange_operands(self.q, prefix, i, [y.value for y in ys])
        if ops is None:
            return None
        ups, coeffs, wks = ops
        out = int8_blocks.up_exchange(ys[i].value, [d.value for d in downs], ups, coeffs, wks=wks)
        return _Handle(out, None)


def _merged_fuse_operands(q: dict, fam: list) -> tuple:
    """A merge_fuse family's sites [(name, relu)] concatenated along the
    output channels: (w, m, b, lo, wk), lo 0 for a relu member's channels
    and -127 for the others', wk the kernel's K-major copy of w."""
    convs = [q["convs"][s] for s, _ in fam]
    w = torch.cat([c["w8"] for c in convs], dim=-1)
    lo = torch.cat([torch.full((c["w8"].shape[-1],), 0.0 if r else -127.0, device=w.device)
                    for c, (_, r) in zip(convs, fam)])
    return (w, torch.cat([c["m"] for c in convs]), torch.cat([c["b"] for c in convs]), lo, pack_kmajor(w))


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
                        y = ops.upsample(y, 2 ** (j - i), like=ys[i])
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


def _s2d_sites(cfg: HRNetConfig) -> dict[str, str]:
    """name -> kind of every conv site of the s2d-packed branch 0: 'entry'
    (std input, even-packed output, k 4 stride 2), 'alt' (the BasicBlock
    convs inside the packed domain), 'down' (even-packed input, std
    half-resolution output). Mirrors :func:`_forward`."""
    sites: dict[str, str] = {"transition1/adapt0": "entry"}
    for si, spec in enumerate((cfg.stage2, cfg.stage3, cfg.stage4)):
        for m in range(spec.num_modules):
            prefix = f"stage{si + 2}_m{m}"
            for k in range(spec.num_blocks[0]):
                sites[f"{prefix}/branch0/block{k}/conv1"] = "alt"
                sites[f"{prefix}/branch0/block{k}/conv2"] = "alt"
            multi = not (si == 2 and m == spec.num_modules - 1)
            if len(spec.num_channels) > 1:
                for i in range(1, len(spec.num_channels) if multi else 1):
                    sites[f"{prefix}/fuse/down{i}_0_0"] = "down"
    return sites


def s2d_pack_quantized(q: dict, cfg: HRNetConfig, scheme: str = "even3") -> dict:
    """``q`` with the packed twins of the branch-0 sites (``convs_s2d``) and
    of the head (``final_s2d``), the JAX package's tree: 'entry' sites
    packed by ``w3_pack_from_std``, 'down' by ``w3_pack_down``, 'alt' by
    ``w3_pack_even3`` (``scheme='even3'``, 3x3 even -> even) or
    ``w3_pack_alt`` (``'alt'``, the 2x2 even <-> odd convs); requant vectors
    tiled where the output is packed. Host-side numpy scatters."""
    if cfg.head != "classic":
        raise NotImplementedError("s2d packing covers the classic head only")
    packed: dict = {}
    for name, kind in _s2d_sites(cfg).items():
        c = q["convs"].get(name)
        if c is None:
            continue
        w8 = c["w8"].cpu()
        if kind == "entry":
            wp = s2d_ops.w3_pack_from_std(w8)
        elif kind == "alt":
            wp = s2d_ops.w3_pack_even3(w8) if scheme == "even3" else s2d_ops.w3_pack_alt(w8)
        else:
            wp = s2d_ops.w3_pack_down(w8)
        ent = {"w8p": torch.from_numpy(wp)}
        if kind in ("entry", "alt"):
            ent["m"], ent["b"] = _f32(s2d_ops.tile_vec(_np(c["m"]))), _f32(s2d_ops.tile_vec(_np(c["b"])))
        else:
            ent["m"], ent["b"] = c["m"], c["b"]
        packed[name] = ent
    q = dict(q)
    fin = q.get("final")
    if fin:
        q["final_s2d"] = {"w8p": torch.from_numpy(s2d_ops.w1_pack(fin["w8"].cpu())),
                          "m": _f32(s2d_ops.tile_vec(_np(fin["m"]))), "b": _f32(s2d_ops.tile_vec(_np(fin["b"])))}
    q["convs_s2d"] = packed
    return q


def quantize_hrnet(model: HRNet, calib_x: Tensor, s2d: bool = False) -> dict:
    """Calibrate over ``calib_x`` (normalized (B, H, W, 3) crops on the
    model's device) and quantize. Returns the JAX package's tree
    ({convs, convs_raw, adds, final, in_scale}, and with ``s2d`` the packed
    twins ``convs_s2d`` and ``final_s2d``, :func:`s2d_pack_quantized`) of
    CPU tensors."""
    if model.config.head != "classic":
        raise NotImplementedError("int8 path covers the classic head only")  # as the JAX quantizer
    scales = _collect_scales(model, calib_x)
    ops = _QuantizeOps(model, scales)
    _forward(ops, model.config)
    ops.q["in_scale"] = torch.tensor(scales["input"], dtype=torch.float32)
    return s2d_pack_quantized(ops.q, model.config) if s2d else ops.q


class HRNetInt8(nn.Module):
    """The int8 HRNet over a quantized tree ``q``: (B, H, W, 3) normalized
    f32 crops, or raw [0, 255] crops with ``fold_normalize``, -> (B, H / 4,
    W / 4, J) f32 heatmaps.

    ``fused_blocks`` runs each module branch as K5 and layer1 as K6;
    ``layer1_strips`` runs layer1 as K6 in 32-row strips (K6s);
    ``fused_min_width`` fuses only branches at least that wide;
    ``fuse_exchange`` (with ``fused_blocks``) runs the fuse exchanges as K7.
    ``s2d`` runs branch 0 space-to-depth packed on the tree's ``convs_s2d``
    (default: on when the tree has them, as the JAX package); with it,
    ``fused_even3`` runs branch 0's even3-packed chains as K5.
    ``merge_fuse`` merges the fuse convs that read one branch (not with
    ``s2d`` or ``fold_residual``, which re-route those sites).
    ``fold_residual`` hands the convs that feed only an add (relu off, the
    fuse up 1x1s aside) to it unrounded; ``fold_fuse_up`` (with it) the up
    1x1s too, through their upsample.
    ``q`` is moved to ``device`` (CUDA unless given), which the module keeps
    as ``self.device``: it holds no parameters. Every int8 site gets its
    K-major weights ``w8k`` beside ``w8`` (``w8pk`` beside a packed twin's
    ``w8p``) here, once (``int8_conv.with_kmajor``), which K5a and K7 read;
    K5's and K6's packed operands and merge_fuse's concatenations (with
    their K-major copies) are built at their first call and kept
    (:meth:`packed`).
    """

    def __init__(self, config: HRNetConfig, q: dict, fused_blocks: bool = False,
                 layer1_strips: bool = False, fused_min_width: int | None = None,
                 fold_normalize: bool = False, fuse_exchange: bool = False, device=None,
                 s2d: bool | None = None, merge_fuse: bool = False, fold_residual: bool = False,
                 fold_fuse_up: bool = False, fused_even3: bool = False):
        super().__init__()
        self.config = config
        self.fused_blocks, self.layer1_strips = fused_blocks, layer1_strips
        self.fused_min_width, self.fold_normalize = fused_min_width, fold_normalize
        self.fuse_exchange = fuse_exchange
        self.s2d = bool(q.get("convs_s2d")) if s2d is None else s2d
        if self.s2d and "convs_s2d" not in q:
            raise ValueError("HRNetInt8: s2d needs the packed twins of quantize_hrnet(..., s2d=True)")
        self.fused_even3, self.merge_fuse = fused_even3, merge_fuse
        self.fold_residual, self.fold_fuse_up = fold_residual, fold_fuse_up
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
