"""ViTDet: the plain-ViT detection backbone (port of ``projects/vitdet.py``).

The published design (Li et al., "Exploring Plain Vision Transformer
Backbones for Object Detection"; detectron2 ``modeling/backbone/vit.py``),
as the JAX module keeps it:

* a stride-16 patchify conv and absolute position embeddings, resized
  bicubically (PyTorch's A = -0.75 cubic) from the pretraining grid;
* transformer blocks with windowed attention (zero-padded windows, no
  mask) except the global blocks, with decomposed relative position biases
  (Rh + Rw) added to the logits; softmax in float32; tanh GELU;
* the Simple Feature Pyramid from the stride-16 map: stride 4 (two
  stride-2 transposed convs), 8 (one), 16 (identity) and 32 (a 2x2
  max-pool), each through a 1x1 and a 3x3 conv with LayerNorm.

Attention is plain PyTorch, as the JAX package computes it in XLA. Maps
are (B, H, W, C) as in the JAX module; the convs run NCHW views of
channels-last memory. The backbone's output is ``{"res2".."res5"}`` NHWC:
``{k: v.permute(0, 3, 1, 2)}`` feeds ``models.fpn.FPN``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import Conv, ConvTranspose, LayerNorm, Linear, gelu, init_params
from .point_rend import interpolate_bilinear


@dataclasses.dataclass(frozen=True)
class ViTDetConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_blocks: tuple[int, ...] = (2, 5, 8, 11)  # ViTDet-B: every third block
    use_rel_pos: bool = True
    out_channels: int = 256
    pretrain_grid: int = 14  # the absolute position table's side (224 / 16)


VITDET_TINY = ViTDetConfig(embed_dim=32, depth=2, num_heads=2, window_size=4, global_blocks=(1,), out_channels=16,
                           pretrain_grid=4)


def window_partition(x: Tensor, win: int) -> tuple[Tensor, tuple[int, int]]:
    """(B, H, W, C) -> (B · nh · nw, win, win, C), zero-padded to whole windows."""
    b, h, w, c = x.shape
    ph, pw = (-h) % win, (-w) % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x: Tensor, win: int, padded_hw: tuple[int, int], out_hw: tuple[int, int]) -> Tensor:
    hp, wp = padded_hw
    h, w = out_hw
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def interpolate_bicubic(x: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """(N, H, W, C) -> (N, *out_hw, C): PyTorch's bicubic (A = -0.75, half-pixel
    centres), which the JAX function writes out tap by tap."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1)


def get_rel_pos(q_size: int, k_size: int, rel_pos: Tensor) -> Tensor:
    """The (q_size, k_size, C) relative-distance table from ``rel_pos``
    (2 · max - 1, C), resized linearly (never antialiased) where its length
    differs; the relative coordinates truncated to integers."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = interpolate_bilinear(rel_pos[None, :, None, :], (max_rel_dist, 1))[0, :, 0, :]
    dev = rel_pos.device
    q_coords = torch.arange(q_size, dtype=torch.float32, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn: Tensor, q: Tensor, rel_h: Tensor, rel_w: Tensor, q_hw: tuple[int, int],
                           k_hw: tuple[int, int]) -> Tensor:
    """attn (B, qh·qw, kh·kw) plus the decomposed biases q·Rh and q·Rw."""
    (qh, qw), (kh, kw) = q_hw, k_hw
    rh, rw = get_rel_pos(qh, kh, rel_h), get_rel_pos(qw, kw, rel_w)  # (qh, kh, d), (qw, kw, d)
    b = q.shape[0]
    rq = q.reshape(b, qh, qw, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    attn = attn.reshape(b, qh, qw, kh, kw) + bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]
    return attn.reshape(b, qh * qw, kh * kw)


class Attention(nn.Module):
    """Multi-head attention over a (B, H, W, C) map of ``input_size`` (H, W):
    ``qkv``, ``proj`` and, with ``use_rel_pos``, the zero-initialized tables
    ``rel_pos_h`` (2H - 1, C / heads) and ``rel_pos_w``. The logits in the
    input's dtype, the rel-pos biases (q in float32) and the softmax in
    float32. Built on the CPU: :class:`ViTDetBackbone` initialises and
    places it."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads, self.use_rel_pos = num_heads, use_rel_pos
        hd = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4).reshape(3, b * nh, h * w, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd**-0.5) @ k.transpose(1, 2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, q.float(), self.rel_pos_h, self.rel_pos_w, (h, w), (h, w))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).reshape(b, nh, h * w, hd).permute(0, 2, 1, 3).reshape(b, h, w, c)
        return self.proj(out)


class Block(nn.Module):
    """``norm1`` -> ``attn`` (in ``window``-sized windows, or global at 0) +
    residual -> ``norm2`` -> ``mlp_fc1`` -> tanh GELU -> ``mlp_fc2`` +
    residual, on a (B, H, W, C) map of ``input_size``. Built on the CPU:
    :class:`ViTDetBackbone` initialises and places it."""

    def __init__(self, config: ViTDetConfig, window: int, input_size: tuple[int, int]):
        super().__init__()
        d = config.embed_dim
        self.window = window
        self.norm1 = LayerNorm(d)
        self.attn = Attention(d, config.num_heads, config.use_rel_pos, (window, window) if window else input_size)
        self.norm2 = LayerNorm(d)
        self.mlp_fc1 = Linear(d, int(d * config.mlp_ratio))
        self.mlp_fc2 = Linear(int(d * config.mlp_ratio), d)

    def forward(self, x: Tensor) -> Tensor:
        y = self.norm1(x)
        if self.window > 0:
            hw = y.shape[1:3]
            y, padded = window_partition(y, self.window)
            y = window_unpartition(self.attn(y), self.window, padded, hw)
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


SFP_LEVELS = ("res2", "res3", "res4", "res5")


class ViTDetBackbone(nn.Module):
    """ViT trunk + Simple Feature Pyramid: (B, H, W, 3) images of
    ``image_size`` (H, W) -> {"res2".."res5"} (B, h, w, out_channels) at
    strides 4-32, NHWC views of channels-last memory. Module names mirror
    the Flax tree (``patch_embed``, ``pos_embed``, ``block{i}``,
    ``up_res3``, ``up_res2a``, ``up_res2_ln``, ``up_res2b``,
    ``res{2..5}_{lateral,ln1,output,ln2}``). ``dtype`` is the compute dtype;
    parameters stay float32. Runs on ``device`` (CUDA unless given another)."""

    def __init__(self, config: ViTDetConfig = VITDET_TINY, image_size: tuple[int, int] = (1024, 1024),
                 in_channels: int = 3, dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        p, c, g, oc = config.patch_size, config.embed_dim, config.pretrain_grid, config.out_channels
        grid = (image_size[0] // p, image_size[1] // p)
        self.patch_embed = Conv(in_channels, c, p, p)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c))
        for i in range(config.depth):
            win = 0 if i in config.global_blocks else config.window_size
            self.add_module(f"block{i}", Block(config, win, grid))
        self.up_res3 = ConvTranspose(c, c // 2, 2, 2, (1, 1))  # Flax "SAME" at k 2, s 2
        self.up_res2a = ConvTranspose(c, c // 2, 2, 2, (1, 1))
        self.up_res2_ln = LayerNorm(c // 2)
        self.up_res2b = ConvTranspose(c // 2, c // 4, 2, 2, (1, 1))
        for name, cin in zip(SFP_LEVELS, (c // 4, c // 2, c, c)):
            self.add_module(f"{name}_lateral", Conv(cin, oc, 1, bias=False))
            self.add_module(f"{name}_ln1", LayerNorm(oc))
            self.add_module(f"{name}_output", Conv(oc, oc, 3, 1, 1, bias=False))
            self.add_module(f"{name}_ln2", LayerNorm(oc))
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        init_params(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.to(resolve_device(device))

    def _conv(self, name: str, y: Tensor) -> Tensor:
        """A conv of NHWC ``y`` (an NCHW view inside)."""
        return getattr(self, name)(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _out_convs(self, y: Tensor, name: str) -> Tensor:
        y = getattr(self, f"{name}_ln1")(self._conv(f"{name}_lateral", y))
        return getattr(self, f"{name}_ln2")(self._conv(f"{name}_output", y))

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last))
        x = x.permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        pos = self.pos_embed
        if pos.shape[1:3] != (h, w):
            pos = interpolate_bicubic(pos, (h, w))
        x = x + pos.to(x.dtype)
        for i in range(self.config.depth):
            x = getattr(self, f"block{i}")(x)
        up2 = self._conv("up_res3", x)
        up4 = self._conv("up_res2b", gelu(self.up_res2_ln(self._conv("up_res2a", x))))
        down2 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return {name: self._out_convs(y, name) for name, y in zip(SFP_LEVELS, (up4, up2, x, down2))}
