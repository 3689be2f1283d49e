"""Fused int8 block chains of HRNet (kernels K5, K6/K6s, K7).

Port of ``spacecraft_pose_estimation_tpu/ops/pallas_blocks.py``:

* :func:`basic_block_chain` (K5, ``csrc/basic_block_chain.cu``): a module
  branch's chain of BasicBlocks, counterpart of ``fused_basic_block_chain``;
* :func:`bottleneck_chain` (K6/K6s, ``csrc/bottleneck_chain.cu``): layer1's
  Bottlenecks, counterpart of ``fused_bottleneck_chain`` and
  ``fused_bottleneck_chain_strips``, which compute one function; ``strip``
  picks the row tiling of the one kernel;
* :func:`up_exchange` (K7, ``csrc/up_exchange.cu``): one fuse-exchange
  output, counterpart of ``fused_up_exchange``;

and the packers that gather their operands from a quantized tree
(``chain_params_from_q``, ``chain_params_even3_from_q`` for branch 0's
space-to-depth even3 chains, ``bottleneck_params_from_q``,
``up_exchange_operands``). Each ``*_plain`` function is the per-op int8 walk
of the same sites through :func:`..int8_conv.int8_conv_plain`, and is what
the wrappers run for CPU tensors. All three kernels multiply on the int8
tensor cores, which read weights K-major: the packers hand over those
copies beside the HWIO weights (``wk``, ``wks``), made once when a model is
built, and the wrappers raise on CUDA tensors without them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from .int8_conv import int8_conv_plain, pack_kmajor, requant

Tensor = torch.Tensor

CHAIN = _cuda.Kernel(
    "basic_block_chain", "basic_block_chain.cu",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
BOTTLENECK = _cuda.Kernel(
    "bottleneck_chain", "bottleneck_chain.cu",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)
EXCHANGE = _cuda.Kernel(
    "up_exchange", "up_exchange.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int]
    + ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3) * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
MAX_EXCHANGE_OPERANDS = 3  # finer or coarser branches of one output (4 branches)


def _residual_add(x: Tensor, r: Tensor, c0: Tensor, c1: Tensor) -> Tensor:
    """The walk's add site: rq(relu(x * c0 + r * c1))."""
    return requant(torch.clamp_min(x.to(torch.float32) * c0 + r.to(torch.float32) * c1, 0.0))


def _check_int8_channels(name: str, *channels: int) -> None:
    if any(c % 4 for c in channels):
        raise ValueError(f"{name}: the kernel needs channel counts that are multiples of 4, got {channels}")


def _default_strip(h: int) -> int:
    """Two strips per image: twice the clusters of one strip, for ~1.1-1.7x
    of recomputed halo rows at the serving shapes."""
    return max(1, math.ceil(h / 2))


# --------------------------------------------------------------------------- K5


def basic_block_chain_plain(x: Tensor, w: Tensor, m: Tensor, b: Tensor, coeffs: Tensor,
                            nblocks: int) -> Tensor:
    """Plain PyTorch K5: ``nblocks`` BasicBlocks, the per-op walk."""
    for blk in range(nblocks):
        x1 = int8_conv_plain(x, w[blk, 0], m[blk, 0], b[blk, 0], relu=True)
        x2 = int8_conv_plain(x1, w[blk, 1], m[blk, 1], b[blk, 1])
        x = _residual_add(x2, x, coeffs[blk, 0], coeffs[blk, 1])
    return x


def basic_block_chain(x: Tensor, w: Tensor, m: Tensor, b: Tensor, coeffs: Tensor, nblocks: int,
                      wk: Tensor | None = None) -> Tensor:
    """``nblocks`` int8 BasicBlocks over x (B, H, W, C).

    w (nblocks, 2, 3, 3, C, C) int8 HWIO; m, b (nblocks, 2, C) f32; coeffs
    (nblocks, 2) f32, the add sites' [conv, residual] coefficients; wk
    ``pack_kmajor(w)``, (nblocks, 2, C, 3, 3, C). CPU tensors take the plain
    version on ``w``; CUDA tensors launch K5 on ``wk``, which they require,
    two strips of rows per image.
    """
    if x.device.type == "cpu":
        return basic_block_chain_plain(x, w, m, b, coeffs, nblocks)
    return _launch_chain(x, wk, m, b, coeffs, nblocks)


def _launch_chain(x, wk, m, b, coeffs, nblocks):
    if wk is None:
        raise ValueError("basic_block_chain: the CUDA kernel needs the K-major weights wk = pack_kmajor(w), "
                         "packed once by chain_params_from_q")
    for name, t, dtype, nd in (("x", x, torch.int8, 4), ("wk", wk, torch.int8, 6), ("m", m, torch.float32, 3),
                               ("b", b, torch.float32, 3), ("coeffs", coeffs, torch.float32, 2)):
        _cuda.check_cuda_tensor(name, t, dtype, nd)
    _cuda.check_word_aligned("x", x)
    bsz, h, wd, c = x.shape
    if tuple(wk.shape) != (nblocks, 2, c, 3, 3, c) or tuple(m.shape) != (nblocks, 2, c) \
            or tuple(b.shape) != (nblocks, 2, c) or tuple(coeffs.shape) != (nblocks, 2):
        raise ValueError(f"basic_block_chain: operands disagree with x {tuple(x.shape)} and nblocks {nblocks}")
    _check_int8_channels("basic_block_chain", c)
    strip = _default_strip(h)
    band = min(h, strip + 4 * nblocks)
    out = torch.empty_like(x)
    work = torch.empty(bsz * math.ceil(h / strip) * 2 * band * wd * c, dtype=torch.int8, device=x.device)
    CHAIN.launch(_cuda.ptr(x), _cuda.ptr(wk), _cuda.ptr(m), _cuda.ptr(b), _cuda.ptr(coeffs), _cuda.ptr(out),
                 _cuda.ptr(work), bsz, h, wd, c, nblocks, strip)
    return out


def chain_params_from_q(q: dict, prefix: str, branch: int, nblocks: int):
    """One module branch's BasicBlock sites stacked for K5: (w, m, b, coeffs,
    wk), wk the kernel's K-major copy of w, or None when a block has a
    projection ('down')."""
    return _chain_params(q, q["convs"], "w8", prefix, branch, nblocks)


def chain_params_even3_from_q(q: dict, prefix: str, branch: int, nblocks: int):
    """One module branch's chain in the even3-packed domain (``ops/s2d.py``)
    stacked for K5, as ``chain_params_from_q``: the packed (3, 3, 4C, 4C)
    twins of ``convs_s2d`` and their tiled requant vectors, so K5 runs the
    branch at 4C channels on the H / 2 x W / 2 packed map. None when a block
    has a projection, lacks a packed twin, or is packed in the 2x2 'alt'
    scheme (which no chain runs)."""
    return _chain_params(q, q.get("convs_s2d") or {}, "w8p", prefix, branch, nblocks)


def _chain_params(q: dict, convs: dict, key: str, prefix: str, branch: int, nblocks: int):
    ws, ms, bs, cs = [], [], [], []
    for k in range(nblocks):
        bn = f"{prefix}/branch{branch}/block{k}"
        c1, c2 = convs.get(f"{bn}/conv1"), convs.get(f"{bn}/conv2")
        if f"{bn}/down" in q["convs"] or c1 is None or c2 is None or c1[key].shape[0] != 3 or c2[key].shape[0] != 3:
            return None
        ws.append(torch.stack([c1[key], c2[key]]))
        ms.append(torch.stack([c1["m"], c2["m"]]))
        bs.append(torch.stack([c1["b"], c2["b"]]))
        cs.append(torch.as_tensor(q["adds"][bn]["coeffs"], dtype=torch.float32))
    w = torch.stack(ws)
    return w, torch.stack(ms), torch.stack(bs), torch.stack(cs), pack_kmajor(w)


# --------------------------------------------------------------------------- K6


def bottleneck_chain_plain(x: Tensor, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, coeffs,
                           nblocks: int) -> Tensor:
    """Plain PyTorch K6: layer1's Bottlenecks, the per-op walk."""
    for blk in range(nblocks):
        t1 = int8_conv_plain(x, w1[blk, :x.shape[-1]][None, None], m1[blk], b1[blk], relu=True)
        t2 = int8_conv_plain(t1, w2[blk], m2[blk], b2[blk], relu=True)
        t3 = int8_conv_plain(t2, w3[blk][None, None], m3[blk], b3[blk])
        r = int8_conv_plain(x, wd[None, None], md, bd) if blk == 0 else x
        x = _residual_add(t3, r, coeffs[blk, 0], coeffs[blk, 1])
    return x


def bottleneck_chain(x: Tensor, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, coeffs,
                     nblocks: int, strip: int | None = None, wk: tuple | None = None) -> Tensor:
    """HRNet layer1: ``nblocks`` int8 Bottlenecks over x (B, H, W, Cin0).

    w1 (n, Cin_max, Cm) (each block reads its first Cin rows: Cin0 for
    block 0, Cout after), w2 (n, 3, 3, Cm, Cm), w3 (n, Cm, Cout) int8;
    wd (Cin0, Cout) block 0's projection; m*, b* f32 per output channel;
    coeffs (n, 2); wk ``pack_bottleneck_kmajor(w1, w2, w3, wd)``. CPU
    tensors take the plain version on the HWIO weights; CUDA tensors launch
    K6 on ``wk``, which they require, with ``strip`` output rows per strip
    (the strips kernel K6s uses 32; default: two strips per image).
    """
    if x.device.type == "cpu":
        return bottleneck_chain_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, coeffs, nblocks)
    return _launch_bottleneck(x, wk, m1, b1, m2, b2, m3, b3, md, bd, coeffs, nblocks, strip)


def pack_bottleneck_kmajor(w1: Tensor, w2: Tensor, w3: Tensor, wd: Tensor) -> tuple:
    """K6's K-major weights (w1k, w2k, w3k, wdk) from its HWIO operands.

    w1k is flat: each block's (Cm, Cin) 1x1 in turn, at that block's own
    Cin (Cin0, wd's rows, for block 0; Cout after), so the kernel reads no
    padding rows; w2k (n, Cm, 3, 3, Cm); w3k (n, Cout, 1, 1, Cm); wdk
    (Cout, 1, 1, Cin0).
    """
    cin0, cout = wd.shape
    w1k = torch.cat([w1[k, :cin0 if k == 0 else cout].t().flatten() for k in range(w1.shape[0])])
    return w1k.contiguous(), pack_kmajor(w2), pack_kmajor(w3[:, None, None]), pack_kmajor(wd[None, None])


def bottleneck_workspace_bytes(bsz: int, h: int, w: int, cm: int, cout: int, nblocks: int,
                               strip: int | None = None) -> int:
    """K6's global workspace: each strip's band of rows (the strip and its
    halo) holds the running activation and the two Cm-wide intermediates."""
    strip = strip or _default_strip(h)
    band = min(h, strip + 2 * nblocks)
    return bsz * math.ceil(h / strip) * band * w * (cout + 2 * cm)


def _launch_bottleneck(x, wk, m1, b1, m2, b2, m3, b3, md, bd, coeffs, nblocks, strip):
    if wk is None:
        raise ValueError("bottleneck_chain: the CUDA kernel needs the K-major weights wk = "
                         "pack_bottleneck_kmajor(w1, w2, w3, wd), packed once by bottleneck_params_from_q")
    _cuda.check_cuda_tensor("x", x, torch.int8, 4)
    _cuda.check_word_aligned("x", x)
    w1k, w2k, w3k, wdk = wk
    for name, t, nd in (("w1k", w1k, 1), ("w2k", w2k, 5), ("w3k", w3k, 5), ("wdk", wdk, 4)):
        _cuda.check_cuda_tensor(name, t, torch.int8, nd)
    for name, t in (("m1", m1), ("b1", b1), ("m2", m2), ("b2", b2), ("m3", m3), ("b3", b3),
                    ("md", md), ("bd", bd), ("coeffs", coeffs)):
        _cuda.check_cuda_tensor(name, t, torch.float32)
    bsz, h, wdt, cin0 = x.shape
    cm, cout = w2k.shape[1], w3k.shape[1]
    if (tuple(w1k.shape) != (cm * (cin0 + (nblocks - 1) * cout),) or tuple(w2k.shape) != (nblocks, cm, 3, 3, cm)
            or tuple(w3k.shape) != (nblocks, cout, 1, 1, cm) or tuple(wdk.shape) != (cout, 1, 1, cin0)
            or tuple(coeffs.shape) != (nblocks, 2)):
        raise ValueError(f"bottleneck_chain: operands disagree with x {tuple(x.shape)} and nblocks {nblocks}")
    _check_int8_channels("bottleneck_chain", cin0, cm, cout)
    strip = strip or _default_strip(h)
    out = torch.empty((bsz, h, wdt, cout), dtype=torch.int8, device=x.device)
    work = torch.empty(bottleneck_workspace_bytes(bsz, h, wdt, cm, cout, nblocks, strip), dtype=torch.int8,
                       device=x.device)
    BOTTLENECK.launch(*[_cuda.ptr(t) for t in (x, w1k, m1, b1, w2k, m2, b2, w3k, m3, b3, wdk, md, bd, coeffs,
                                               out, work)],
                      bsz, h, wdt, cin0, cm, cout, nblocks, strip)
    return out


def bottleneck_params_from_q(q: dict, nblocks: int):
    """layer1's sites packed for K6 (w1 zero-padded to the widest input:
    zero rows add nothing to the int32 sums), with the kernel's K-major
    copies ``wk``, or None without block 0's projection."""
    convs = q["convs"]
    if "layer1/block0/down" not in convs:
        return None
    blocks = [(convs[f"layer1/block{k}/conv1"], convs[f"layer1/block{k}/conv2"], convs[f"layer1/block{k}/conv3"])
              for k in range(nblocks)]
    cin_max = max(c1["w8"].shape[-2] for c1, _, _ in blocks)
    w1s = []
    for c1, _, _ in blocks:
        w1 = c1["w8"][0, 0]
        w1s.append(torch.nn.functional.pad(w1, (0, 0, 0, cin_max - w1.shape[0])))
    d = convs["layer1/block0/down"]
    p = dict(
        w1=torch.stack(w1s), m1=torch.stack([c1["m"] for c1, _, _ in blocks]),
        b1=torch.stack([c1["b"] for c1, _, _ in blocks]),
        w2=torch.stack([c2["w8"] for _, c2, _ in blocks]), m2=torch.stack([c2["m"] for _, c2, _ in blocks]),
        b2=torch.stack([c2["b"] for _, c2, _ in blocks]),
        w3=torch.stack([c3["w8"][0, 0] for _, _, c3 in blocks]), m3=torch.stack([c3["m"] for _, _, c3 in blocks]),
        b3=torch.stack([c3["b"] for _, _, c3 in blocks]),
        wd=d["w8"][0, 0].contiguous(), md=d["m"], bd=d["b"],
        coeffs=torch.stack([torch.as_tensor(q["adds"][f"layer1/block{k}"]["coeffs"], dtype=torch.float32)
                            for k in range(nblocks)]),
    )
    p["wk"] = pack_bottleneck_kmajor(p["w1"], p["w2"], p["w3"], p["wd"])
    return p


# --------------------------------------------------------------------------- K7


def up_exchange_plain(yi: Tensor, downs: list, ups: list, coeffs: Tensor) -> Tensor:
    """Plain PyTorch K7: the walk's exchange output, operands in the order
    [yi, downs..., ups...]; each up is requant(1x1 conv) then a nearest
    upsample to yi's resolution."""
    acc = yi.to(torch.float32) * coeffs[0]
    ci = 1
    for d in downs:
        acc = acc + d.to(torch.float32) * coeffs[ci]
        ci += 1
    for u, w, m, b in ups:
        f = yi.shape[1] // u.shape[1]
        y = int8_conv_plain(u, w[None, None], m, b)
        y = y.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        acc = acc + y.to(torch.float32) * coeffs[ci]
        ci += 1
    return requant(torch.clamp_min(acc, 0.0))


def up_exchange(yi: Tensor, downs: list, ups: list, coeffs: Tensor, wks: list | None = None) -> Tensor:
    """Fuse-exchange output i: ``yi`` (B, H, W, C) int8, ``downs`` int8 at
    yi's shape, ``ups`` [(u_j (B, H / f, W / f, C_j) int8, w_j (C_j, C) int8,
    m_j, b_j (C,) f32)], ``coeffs`` (1 + len(downs) + len(ups),) f32;
    ``wks`` [w_j's K-major copy, (C, 1, 1, C_j)], the sites' ``w8k``. CPU
    tensors take the plain version on the ``w_j``; CUDA tensors launch K7 on
    ``wks``, which they require when there are ups."""
    if yi.device.type == "cpu":
        return up_exchange_plain(yi, downs, ups, coeffs)
    return _launch_exchange(yi, downs, ups, coeffs, wks)


def _launch_exchange(yi, downs, ups, coeffs, wks):
    if ups and (wks is None or len(wks) != len(ups)):
        raise ValueError("up_exchange: the CUDA kernel needs the K-major weights wks, one (C, 1, 1, C_j) per up "
                         "(the sites' w8k, packed once by int8_conv.with_kmajor)")
    _cuda.check_cuda_tensor("yi", yi, torch.int8, 4)
    _cuda.check_cuda_tensor("coeffs", coeffs, torch.float32, 1)
    bsz, h, wdt, c = yi.shape
    if len(downs) > MAX_EXCHANGE_OPERANDS or len(ups) > MAX_EXCHANGE_OPERANDS \
            or coeffs.shape[0] != 1 + len(downs) + len(ups):
        raise ValueError(f"up_exchange: {len(downs)} downs, {len(ups)} ups, {coeffs.shape[0]} coefficients")
    for i, d in enumerate(downs):
        _cuda.check_cuda_tensor(f"downs[{i}]", d, torch.int8, 4)
        if d.shape != yi.shape:
            raise ValueError(f"up_exchange: downs[{i}] {tuple(d.shape)} is not at yi's shape {tuple(yi.shape)}")
    up_args = []
    for j, ((u, _, m, b), wk) in enumerate(zip(ups, wks or [])):
        _cuda.check_cuda_tensor(f"ups[{j}].u", u, torch.int8, 4)
        _cuda.check_word_aligned(f"ups[{j}].u", u)
        _cuda.check_cuda_tensor(f"wks[{j}]", wk, torch.int8, 4)
        _cuda.check_cuda_tensor(f"ups[{j}].m", m, torch.float32, 1)
        _cuda.check_cuda_tensor(f"ups[{j}].b", b, torch.float32, 1)
        if u.shape[0] != bsz or h % u.shape[1] or wdt % u.shape[2] or h // u.shape[1] != wdt // u.shape[2] \
                or tuple(wk.shape) != (c, 1, 1, u.shape[3]):
            raise ValueError(f"up_exchange: ups[{j}] u {tuple(u.shape)}, wk {tuple(wk.shape)} vs yi {tuple(yi.shape)}")
        _check_int8_channels("up_exchange", u.shape[3])
        up_args += [_cuda.ptr(u), _cuda.ptr(wk), _cuda.ptr(m), _cuda.ptr(b), u.shape[1], u.shape[2], u.shape[3]]
    _check_int8_channels("up_exchange", c)
    null = ctypes.c_void_p(None)
    down_ptrs = [_cuda.ptr(d) for d in downs] + [null] * (MAX_EXCHANGE_OPERANDS - len(downs))
    for _ in range(MAX_EXCHANGE_OPERANDS - len(ups)):
        up_args += [null] * 4 + [0, 0, 0]
    out = torch.empty_like(yi)
    EXCHANGE.launch(_cuda.ptr(yi), *down_ptrs, len(downs), *up_args, len(ups), _cuda.ptr(coeffs), _cuda.ptr(out),
                    bsz, h, wdt, c)
    return out


def up_exchange_operands(q: dict, prefix: str, i: int, ys: list):
    """The coarser operands of exchange output i, [(y_j, w (C_j, C), m, b)]
    for j > i, its add coefficients, and the sites' K-major weights
    [w8k (C, 1, 1, C_j)] (None when the tree holds no ``w8k``: the
    quantizer's tree); None when a 1x1 site is missing."""
    sites = [q["convs"].get(f"{prefix}/fuse/up{i}_{j}") for j in range(i + 1, len(ys))]
    if any(c is None for c in sites):
        return None
    ups = [(y, c["w8"][0, 0], c["m"], c["b"]) for y, c in zip(ys[i + 1:], sites)]
    wks = [c["w8k"] for c in sites] if all("w8k" in c for c in sites) else None
    return ups, torch.as_tensor(q["adds"][f"{prefix}/fuse/out{i}"]["coeffs"], dtype=torch.float32), wks
