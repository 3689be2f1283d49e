"""MViTv2: the multiscale vision transformer backbone (port of ``projects/mvitv2.py``).

The published design (Li et al., "MViTv2: Improved Multiscale Vision
Transformers for Classification and Detection"; detectron2
``modeling/backbone/mvit.py``), as the JAX module keeps it:

* a 7x7 stride-4 patchify conv;
* four stages; the first block of each later stage pools q by 2 and
  doubles the width and the heads;
* pooled attention: q, k and v each pooled by a depthwise 3x3 conv (Flax
  ``padding="SAME"``: at stride 2 on an even side that pads (0, 1)) and a
  LayerNorm, decomposed relative position biases (ViTDet's) over tables of
  2 · max(q, k) - 1, and residual pooling (the pooled q added to the
  output);
* the stage-transition shortcut projects the *normed* input, and a max-pool
  (kernel stride + 1, padding kernel // 2, -inf outside) matches q's size;
* a LayerNorm on each stage's output -> ``{"res2".."res5"}`` at strides 4-32.

Maps are (B, H, W, C) as in the JAX module; attention is plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..models.layers import Conv, LayerNorm, Linear, gelu, init_params
from .vitdet import add_decomposed_rel_pos


@dataclasses.dataclass(frozen=True)
class MViTv2Config:
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 3, 16, 3)  # MViTv2-B
    num_heads: int = 1  # doubled at each stage transition
    mlp_ratio: float = 4.0
    kv_stride: tuple[int, ...] = (4, 2, 1, 1)  # per-stage k / v pooling
    use_rel_pos: bool = True
    residual_pooling: bool = True


MVITV2_TINY = MViTv2Config(embed_dim=16, depths=(1, 1, 1, 1), num_heads=1)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax / XLA ``padding="SAME"`` along one axis: (before, after), the odd
    cell after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention on a (B, H, W, dim_in) map of
    ``input_size``: ``qkv``; ``pool_q`` / ``pool_k`` / ``pool_v`` (depthwise
    3x3, no bias, strides ``q_stride`` and ``kv_stride``, SAME padding) each
    with ``norm_q`` / ``norm_k`` / ``norm_v``; the rel-pos tables
    ``rel_pos_h`` / ``rel_pos_w``; ``proj``. -> (B, h', w', dim_out). Built
    on the CPU: :class:`MViTv2Backbone` initialises and places it."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int, q_stride: int, kv_stride: int, use_rel_pos: bool,
                 residual_pooling: bool, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads, self.use_rel_pos, self.residual_pooling = num_heads, use_rel_pos, residual_pooling
        self.strides = {"q": q_stride, "k": kv_stride, "v": kv_stride}
        hd = dim_out // num_heads
        self.qkv = Linear(dim_in, 3 * dim_out)
        for name in self.strides:
            self.add_module(f"pool_{name}", Conv(hd, hd, 3, self.strides[name], bias=False, groups=hd))
            self.add_module(f"norm_{name}", LayerNorm(hd))
        if use_rel_pos:
            (h, w), side = input_size, lambda n, s: -(-n // s)  # noqa: E731 (SAME output size)
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * max(side(h, q_stride), side(h, kv_stride)) - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * max(side(w, q_stride), side(w, kv_stride)) - 1, hd))
        self.proj = Linear(dim_out, dim_out)

    def _pool(self, name: str, y: Tensor) -> Tensor:
        """(N, H, W, hd) -> the depthwise SAME conv at its stride, LayerNorm."""
        s = self.strides[name]
        (t, b), (l, r) = same_pads(y.shape[1], 3, s), same_pads(y.shape[2], 3, s)
        y = getattr(self, f"pool_{name}")(F.pad(y.permute(0, 3, 1, 2), (l, r, t, b))).permute(0, 2, 3, 1)
        return getattr(self, f"norm_{name}")(y)

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, _ = x.shape
        nh = self.num_heads
        dim_out = self.proj.weight.shape[0]
        hd = dim_out // nh
        qkv = self.qkv(x).reshape(b, h, w, 3, nh, hd).permute(3, 0, 4, 1, 2, 5).reshape(3, b * nh, h, w, hd)
        q, k, v = (self._pool(name, qkv[i]) for i, name in enumerate("qkv"))
        (qh, qw), (kh, kw) = q.shape[1:3], k.shape[1:3]
        qf, kf, vf = q.reshape(-1, qh * qw, hd), k.reshape(-1, kh * kw, hd), v.reshape(-1, kh * kw, hd)
        attn = (qf * hd**-0.5) @ kf.transpose(1, 2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, qf.float(), self.rel_pos_h, self.rel_pos_w, (qh, qw), (kh, kw))
        out = torch.softmax(attn.float(), dim=-1).to(x.dtype) @ vf
        if self.residual_pooling:
            out = out + qf
        out = out.reshape(b, nh, qh * qw, hd).permute(0, 2, 1, 3).reshape(b, qh, qw, dim_out)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    """``norm1`` -> ``attn`` + the shortcut (``shortcut_proj`` of the normed
    input where the width changes; max-pooled to q's size where q is
    pooled) -> ``norm2`` -> ``mlp_fc1`` -> tanh GELU -> ``mlp_fc2`` +
    residual. (B, H, W, dim_in) of ``input_size`` -> (B, h', w', dim_out).
    Built on the CPU: :class:`MViTv2Backbone` initialises and places it."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int, q_stride: int, kv_stride: int, mlp_ratio: float,
                 use_rel_pos: bool, residual_pooling: bool, input_size: tuple[int, int]):
        super().__init__()
        self.q_stride = q_stride
        self.norm1 = LayerNorm(dim_in)
        self.attn = MultiScaleAttention(dim_in, dim_out, num_heads, q_stride, kv_stride, use_rel_pos,
                                        residual_pooling, input_size)
        self.shortcut_proj = Linear(dim_in, dim_out) if dim_in != dim_out else None
        self.norm2 = LayerNorm(dim_out)
        self.mlp_fc1 = Linear(dim_out, int(dim_out * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim_out * mlp_ratio), dim_out)

    def forward(self, x: Tensor) -> Tensor:
        x_norm = self.norm1(x)
        y = self.attn(x_norm)
        short = x if self.shortcut_proj is None else self.shortcut_proj(x_norm)
        if self.q_stride > 1:
            k = self.q_stride + 1
            short = F.max_pool2d(short.permute(0, 3, 1, 2), k, self.q_stride, k // 2).permute(0, 2, 3, 1)
        x = short + y
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


class MViTv2Backbone(nn.Module):
    """Patchify (``patch_embed``, 7x7 s4, padding 3) + the four stages
    (``stage{s}_block{b}``) + ``norm_res{2..5}``: (B, H, W, 3) images of
    ``image_size`` -> {"res2".."res5"} (B, h, w, C) at strides 4-32.
    ``dtype`` is the compute dtype; parameters stay float32. Runs on
    ``device`` (CUDA unless given another)."""

    def __init__(self, config: MViTv2Config = MVITV2_TINY, image_size: tuple[int, int] = (1024, 1024),
                 in_channels: int = 3, dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.patch_embed = Conv(in_channels, config.embed_dim, 7, 4, 3)
        size = tuple((n + 6 - 7) // 4 + 1 for n in image_size)
        dim, heads = config.embed_dim, config.num_heads
        self.blocks = []
        for si, depth in enumerate(config.depths):
            for bi in range(depth):
                first = bi == 0 and si > 0
                dim_out = dim * 2 if first else dim
                name = f"stage{si}_block{bi}"
                self.add_module(name, MultiScaleBlock(
                    dim, dim_out, heads * 2 if first else heads, 2 if first else 1, config.kv_stride[si],
                    config.mlp_ratio, config.use_rel_pos, config.residual_pooling, size))
                self.blocks.append((si, name))
                if first:
                    dim, heads, size = dim_out, heads * 2, tuple(-(-n // 2) for n in size)
            self.add_module(f"norm_res{si + 2}", LayerNorm(dim))
        init_params(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last))
        x = x.permute(0, 2, 3, 1)
        feats = {}
        for i, (si, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            if i + 1 == len(self.blocks) or self.blocks[i + 1][0] != si:
                feats[f"res{si + 2}"] = getattr(self, f"norm_res{si + 2}")(x)
        return feats
