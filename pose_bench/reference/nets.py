"""Plain PyTorch networks of the served pose path: the Faster R-CNN
detector (ResNet / ResNeXt trunk with frozen BN, FPN, RPN head, box head)
and HRNet with the classic heatmap head.

Module and parameter names follow the served program's ``state_dict``, so
one set of weights made by the benchmark loads into both. Each network
computes in the dtype it is given (float32 for the reference; the
calibration forwards of the int8 scheme run in bfloat16, as that scheme
states); parameters stay float32 and are cast per call. NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, bias=True, groups=1):
        super().__init__()
        self.stride, self.pad, self.groups = stride, pad, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.pad, 1, self.groups)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def affine(norm) -> tuple[torch.Tensor, torch.Tensor]:
    """A frozen or eval-mode BN as y = x * mul + add (float32 vectors)."""
    mul = norm.scale * torch.rsqrt(norm.var + BN_EPS)
    return mul, norm.bias - norm.mean * mul


class FrozenBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        for name, v in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            setattr(self, name, nn.Parameter(torch.full((c,), v)))

    def forward(self, x):
        mul, add = affine(self)
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class BatchNorm(nn.Module):
    """Eval-mode BN: parameters ``scale``, ``bias``; buffers ``mean``, ``var``."""

    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    forward = FrozenBN.forward


class ConvFrozenBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, act=True, groups=1):
        super().__init__()
        self.act = act
        self.conv = Conv(cin, cout, k, stride, (k - 1) // 2, bias=False, groups=groups)
        self.norm = FrozenBN(cout)

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


class BottleneckX(nn.Module):
    def __init__(self, cin, cout, mid, stride, groups, stride_in_1x1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.stride = stride
        self.conv1 = ConvFrozenBN(cin, mid, 1, s1)
        self.conv2 = ConvFrozenBN(mid, mid, 3, s3, groups=groups)
        self.conv3 = ConvFrozenBN(mid, cout, 1, 1, act=False)
        self.shortcut = ConvFrozenBN(cin, cout, 1, stride, act=False) if stride != 1 or cin != cout else None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNet(nn.Module):
    """detectron2's ResNet / ResNeXt trunk: stem, max-pool, res2..res5."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvFrozenBN(3, cfg["stem_channels"], 7, 2)
        cin, cout = cfg["stem_channels"], cfg["res2_out_channels"]
        mid = cfg["width_per_group"] * cfg["groups"]
        self.blocks = []  # (stage, name, module)
        for si, n in enumerate(STAGE_BLOCKS[cfg["depth"]]):
            for bi in range(n):
                m = BottleneckX(cin, cout, mid, 2 if si > 0 and bi == 0 else 1, cfg["groups"],
                                cfg["stride_in_1x1"])
                self.add_module(f"res{si + 2}_b{bi}", m)
                self.blocks.append((f"res{si + 2}", f"res{si + 2}_b{bi}", m))
                cin = cout
            cout, mid = cout * 2, mid * 2
        self.out_channels = {f"res{i + 2}": cfg["res2_out_channels"] * 2**i for i in range(4)}

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        feats = {}
        for stage, _, m in self.blocks:
            x = m(x)
            feats[stage] = x
        return feats


class FPN(nn.Module):
    def __init__(self, in_channels: dict, c: int):
        super().__init__()
        self.names = sorted(in_channels)
        for n in self.names:
            self.add_module(f"lateral_{n}", Conv(in_channels[n], c, 1))
            self.add_module(f"output_p{n[3:]}", Conv(c, c, 3, 1, 1))

    def forward(self, feats):
        lat = [getattr(self, f"lateral_{n}")(feats[n]) for n in self.names]
        outs = [None] * len(lat)
        prev = outs[-1] = lat[-1]
        for i in range(len(lat) - 2, -1, -1):
            prev = lat[i] + F.interpolate(prev, scale_factor=2, mode="nearest")
            outs[i] = prev
        res = {f"p{n[3:]}": getattr(self, f"output_p{n[3:]}")(o) for n, o in zip(self.names, outs)}
        res["p6"] = res["p5"][:, :, ::2, ::2]
        return res


class RPNHead(nn.Module):
    def __init__(self, c, a):
        super().__init__()
        self.conv = Conv(c, c, 3, 1, 1)
        self.objectness = Conv(c, a, 1)
        self.deltas = Conv(c, 4 * a, 1)

    def forward(self, pyramid):
        out = {}
        for lvl, x in pyramid.items():
            t = F.relu(self.conv(x))
            out[lvl] = (self.objectness(t).float().permute(0, 2, 3, 1), self.deltas(t).float().permute(0, 2, 3, 1))
        return out


class BoxHead(nn.Module):
    def __init__(self, cin, fc, n):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"fc{i + 1}", Linear(cin if i == 0 else fc, fc))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class Predictor(nn.Module):
    def __init__(self, fc, classes, agnostic):
        super().__init__()
        self.cls_score = Linear(fc, classes + 1)
        self.bbox_pred = Linear(fc, 4 * (1 if agnostic else classes))


class ROIHeads(nn.Module):
    def __init__(self, roi: dict, c: int):
        super().__init__()
        p = roi["pooler_resolution"]
        self.box_head = BoxHead(c * p * p, roi["fc_dim"], roi["num_fc"])
        self.predictor = Predictor(roi["fc_dim"], roi["num_classes"], roi["cls_agnostic_bbox_reg"])

    def forward(self, pooled):
        """(R, P, P, C) pooled features in the compute dtype -> float32 logits, deltas."""
        x = self.box_head(pooled)
        return self.predictor.cls_score(x).float(), self.predictor.bbox_pred(x).float()


class Detector(nn.Module):
    """Faster R-CNN with an FPN; the configuration's ``detector`` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg["backbone"])
        c = cfg["fpn_channels"]
        self.fpn = FPN(self.backbone.out_channels, c)
        self.rpn_head = RPNHead(c, len(cfg["anchor_aspect_ratios"]) * len(cfg["anchor_sizes"][0]))
        self.roi_heads = ROIHeads(cfg["roi"], c)
        self.register_buffer("pixel_mean", torch.tensor(cfg["pixel_mean"]), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg["pixel_std"]), persistent=False)

    def normalize(self, images):
        """Raw (B, H, W, 3) -> float32 NHWC (x - mean) / std."""
        return (images.to(torch.float32) - self.pixel_mean) / self.pixel_std


def residual_norms(net: nn.Module) -> list[nn.Module]:
    """The norm that ends each residual branch of ``net`` (a bottleneck's
    conv3, a basic block's conv2)."""
    out = []
    for m in net.modules():
        if isinstance(m, (BottleneckX, Bottleneck)):
            out.append(m.conv3.norm if isinstance(m, BottleneckX) else m.conv3.bn)
        elif isinstance(m, BasicBlock):
            out.append(m.conv2.bn)
    return out


# ---------------------------------------------------------------- HRNet

class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, act=True):
        super().__init__()
        self.act = act
        self.conv = Conv(cin, cout, k, stride, k // 2, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, f):
        super().__init__()
        self.conv1 = ConvBN(cin, f, 3, 1, True)
        self.conv2 = ConvBN(f, f, 3, 1, False)
        self.down = ConvBN(cin, f, 1, 1, False) if cin != f else None

    def forward(self, x):
        return F.relu(self.conv2(self.conv1(x)) + (x if self.down is None else self.down(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, f):
        super().__init__()
        self.conv1 = ConvBN(cin, f, 1, 1, True)
        self.conv2 = ConvBN(f, f, 3, 1, True)
        self.conv3 = ConvBN(f, 4 * f, 1, 1, False)
        self.down = ConvBN(cin, 4 * f, 1, 1, False) if cin != 4 * f else None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + (x if self.down is None else self.down(x)))


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class Branch(nn.Module):
    def __init__(self, block, cin, f, n):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"block{i}", BLOCKS[block](cin, f))
            cin = f * BLOCKS[block].expansion
        self.out_channels = cin

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x)
        return x


class FuseLayer(nn.Module):
    def __init__(self, chans, n_out):
        super().__init__()
        self.n_in, self.n_out = len(chans), n_out
        for i in range(n_out):
            for j in range(self.n_in):
                if j > i:
                    self.add_module(f"up{i}_{j}", ConvBN(chans[j], chans[i], 1, 1, False))
                for k in range(i - j):
                    last = k == i - j - 1
                    self.add_module(f"down{i}_{j}_{k}",
                                    ConvBN(chans[j], chans[i] if last else chans[j], 3, 2, not last))

    def forward(self, xs):
        outs = []
        for i in range(self.n_out):
            acc = None
            for j, x in enumerate(xs):
                y = x
                if j > i:
                    y = F.interpolate(getattr(self, f"up{i}_{j}")(x), scale_factor=2 ** (j - i), mode="nearest")
                for k in range(i - j):
                    y = getattr(self, f"down{i}_{j}_{k}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    def __init__(self, spec, chans, multi):
        super().__init__()
        exp = BLOCKS[spec["block"]].expansion
        self.nb = len(chans)
        for i, cin in enumerate(chans):
            self.add_module(f"branch{i}", Branch(spec["block"], cin, spec["num_channels"][i] * exp,
                                                 spec["num_blocks"][i]))
        outs = [getattr(self, f"branch{i}").out_channels for i in range(self.nb)]
        self.fuse = FuseLayer(outs, len(outs) if multi else 1) if len(outs) > 1 else None
        self.out_channels = outs if multi or self.fuse is None else outs[:1]

    def forward(self, xs):
        ys = [getattr(self, f"branch{i}")(x) for i, x in enumerate(xs)]
        return ys if self.fuse is None else self.fuse(ys)


class Transition(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.cin, self.cout = list(cin), list(cout)
        n_pre = len(cin)
        for i, c in enumerate(cout):
            if i < n_pre:
                if cin[i] != c:
                    self.add_module(f"adapt{i}", ConvBN(cin[i], c, 3, 1, True))
            else:
                prev = cin[-1]
                for j in range(i + 1 - n_pre):
                    ch = c if j == i - n_pre else cin[-1]
                    self.add_module(f"new{i}_{j}", ConvBN(prev, ch, 3, 2, True))
                    prev = ch

    def forward(self, xs):
        n_pre, outs = len(xs), []
        for i in range(len(self.cout)):
            if i < n_pre:
                m = getattr(self, f"adapt{i}", None)
                outs.append(xs[i] if m is None else m(xs[i]))
            else:
                y = xs[-1]
                for j in range(i + 1 - n_pre):
                    y = getattr(self, f"new{i}_{j}")(y)
                outs.append(y)
        return outs


class HRNet(nn.Module):
    """HRNet, classic head: (B, H, W, 3) normalized NHWC -> (B, H/4, W/4, J) float32."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c = cfg["stem_channels"]
        self.stem1 = ConvBN(3, c, 3, 2)
        self.stem2 = ConvBN(c, c, 3, 2)
        self.layer1 = Branch("BOTTLENECK", c, c, cfg["stage1_blocks"])
        prev = [self.layer1.out_channels]
        self.stage_names = []
        for si, key in enumerate(("stage2", "stage3", "stage4")):
            spec = cfg[key]
            widths = [ch * BLOCKS[spec["block"]].expansion for ch in spec["num_channels"]]
            self.add_module(f"transition{si + 1}", Transition(prev, widths))
            chans, mods = widths, []
            for m in range(spec["num_modules"]):
                mod = HRModule(spec, chans, not (si == 2 and m == spec["num_modules"] - 1))
                self.add_module(f"stage{si + 2}_m{m}", mod)
                mods.append(f"stage{si + 2}_m{m}")
                chans = mod.out_channels
            self.stage_names.append((f"transition{si + 1}", mods))
            prev = chans
        k = cfg["final_conv_kernel"]
        self.final_layer = Conv(prev[0], cfg["num_joints"], k, 1, k // 2, bias=True)

    def forward(self, x, dtype=torch.float32):
        x = x.permute(0, 3, 1, 2).to(dtype)
        xs = [self.layer1(self.stem2(self.stem1(x)))]
        for trans, mods in self.stage_names:
            xs = getattr(self, trans)(xs)
            for m in mods:
                xs = getattr(self, m)(xs)
        return self.final_layer(xs[0]).float().permute(0, 2, 3, 1)
