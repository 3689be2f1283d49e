"""Port parity of the fused int8 block chains (K5, K6/K6s, K7 plain versions)
and their packers against the JAX package's Pallas kernels, run in
interpret mode as ``tests/test_pallas_blocks.py`` runs them.

Bound: the JAX package's own rule for its fused kernels, every int8 entry
within 1 and fewer than 2e-3 of them off at all (f32 rounding ties). K7 is
also held to the JAX per-op exchange of ``models/hrnet_int8.py``
(``_Int8Ops.convbn`` + ``upsample`` + ``add``), which it must equal exactly,
since both compute the same rounding points in the same order. The packers
must give the JAX packers' arrays exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import hrnet_int8 as jhi
from spacecraft_pose_estimation_tpu.ops import pallas_blocks as jpb
from spacecraft_pose_estimation_tpu_torch.convert import quantized_to_torch
from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks

from torch_port_util import n, t


def assert_int8_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 2e-3


def rand_int8(rng, *shape, lo=-80, hi=80):
    return rng.integers(lo, hi, shape).astype(np.int8)


def requant_vectors(rng, c, fan_in, n_lead=()):
    """m, b that keep a conv of int8 operands inside the int8 range."""
    m = (rng.uniform(0.5, 1.5, n_lead + (c,)) * 60.0 / (50 * 50 * np.sqrt(fan_in))).astype(np.float32)
    b = rng.uniform(-3.0, 3.0, n_lead + (c,)).astype(np.float32)
    return m, b


@pytest.mark.parametrize("b,h,w,c,nblocks", [(2, 16, 16, 32, 2), (1, 8, 12, 8, 3)], ids=["w32-like", "rect-narrow"])
def test_basic_block_chain_matches_pallas(b, h, w, c, nblocks):
    rng = np.random.default_rng(1)
    x = rand_int8(rng, b, h, w, c)
    wts = rand_int8(rng, nblocks, 2, 3, 3, c, c, lo=-50, hi=50)
    m, bias = requant_vectors(rng, c, 9 * c, (nblocks, 2))
    coeffs = rng.uniform(0.4, 1.2, (nblocks, 2)).astype(np.float32)
    want = jpb.fused_basic_block_chain(*map(jnp.asarray, (x, wts, m, bias, coeffs)), nblocks, interpret=True)
    got = int8_blocks.basic_block_chain(t(x), t(wts), t(m), t(bias), t(coeffs), nblocks)
    assert got.dtype == torch.int8
    assert_int8_close(n(got), want)


def bottleneck_operands(rng, nblocks, cin0, cm, cout):
    cin_max = max(cin0, cout) if nblocks > 1 else cin0
    w1 = np.zeros((nblocks, cin_max, cm), np.int8)
    w1[0, :cin0] = rand_int8(rng, cin0, cm, lo=-50, hi=50)
    for k in range(1, nblocks):
        w1[k, :cout] = rand_int8(rng, cout, cm, lo=-50, hi=50)
    m1, b1 = requant_vectors(rng, cm, cout, (nblocks,))
    w2 = rand_int8(rng, nblocks, 3, 3, cm, cm, lo=-50, hi=50)
    m2, b2 = requant_vectors(rng, cm, 9 * cm, (nblocks,))
    w3 = rand_int8(rng, nblocks, cm, cout, lo=-50, hi=50)
    m3, b3 = requant_vectors(rng, cout, cm, (nblocks,))
    wd = rand_int8(rng, cin0, cout, lo=-50, hi=50)
    md, bd = requant_vectors(rng, cout, cin0)
    coeffs = rng.uniform(0.4, 1.2, (nblocks, 2)).astype(np.float32)
    return [w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, coeffs]


@pytest.mark.parametrize("kernel", ["whole", "strips"])
def test_bottleneck_chain_matches_pallas(kernel):
    """layer1-style chain, against both JAX kernels (K6 whole-image, K6s in
    4-row strips): block 0 projects 16 -> 64 with a shortcut conv. K6s is
    held to it away from the image's top and bottom ``nblocks`` rows (see
    test_strips_kernel_leaves_the_walk_at_image_edges)."""
    rng = np.random.default_rng(7)
    nblocks, h = 3, 16
    x = rand_int8(rng, 2, h, 8, 16)
    ops = bottleneck_operands(rng, nblocks, 16, 16, 64)
    jops = [jnp.asarray(a) for a in ops]
    got = n(int8_blocks.bottleneck_chain(t(x), *[t(a) for a in ops], nblocks))
    if kernel == "whole":
        assert_int8_close(got, jpb.fused_bottleneck_chain(jnp.asarray(x), *jops, nblocks, chunk=32, interpret=True))
    else:
        want = np.asarray(jpb.fused_bottleneck_chain_strips(jnp.asarray(x), *jops, nblocks, strip=4, interpret=True))
        assert_int8_close(got[:, nblocks:h - nblocks], want[:, nblocks:h - nblocks])


def test_strips_kernel_leaves_the_walk_at_image_edges():
    """The JAX strips kernel (K6s) computes its halo rows beyond the image
    as if they were image rows (conv1 of the zero padding gives relu(b1),
    and later blocks carry those rows on), and its 3x3 convs then read them
    where the per-op walk reads zero padding. So K6s leaves the walk in the
    top and bottom rows. The port follows the walk, as the whole-image JAX
    kernel K6 does, everywhere."""
    rng = np.random.default_rng(8)
    nblocks, h = 2, 8
    x = rand_int8(rng, 1, h, 8, 16)
    ops = bottleneck_operands(rng, nblocks, 16, 16, 64)
    jops = [jnp.asarray(a) for a in ops]
    whole = np.asarray(jpb.fused_bottleneck_chain(jnp.asarray(x), *jops, nblocks, chunk=32, interpret=True))
    strips = np.asarray(jpb.fused_bottleneck_chain_strips(jnp.asarray(x), *jops, nblocks, strip=4, interpret=True))
    got = n(int8_blocks.bottleneck_chain(t(x), *[t(a) for a in ops], nblocks))
    assert_int8_close(got, whole)
    off = np.abs(strips.astype(np.int32) - got)
    assert off[:, [0, h - 1]].max() > 1
    assert_int8_close(got[:, nblocks:h - nblocks], strips[:, nblocks:h - nblocks])


def exchange_case(seed, h, c, n_down, ups):
    """yi (2, h, h, c), n_down finer operands, coarser ones [(factor, C_j)]."""
    rng = np.random.default_rng(seed)
    yi = rand_int8(rng, 2, h, h, c)
    downs = [rand_int8(rng, 2, h, h, c) for _ in range(n_down)]
    up_ops = []
    for f, cj in ups:
        m, b = requant_vectors(rng, c, cj)
        up_ops.append((rand_int8(rng, 2, h // f, h // f, cj), rand_int8(rng, cj, c, lo=-50, hi=50), m, b))
    coeffs = rng.uniform(0.3, 1.2, 1 + n_down + len(ups)).astype(np.float32)
    return yi, downs, up_ops, coeffs


EXCHANGES = [(16, 8, 0, [(2, 16), (4, 32)]), (8, 16, 2, [(2, 32)]), (4, 32, 3, [])]


@pytest.mark.parametrize("h,c,n_down,ups", EXCHANGES, ids=["out0-of-3", "out2-of-4", "out3-of-4"])
def test_up_exchange_matches_pallas_and_the_walk(h, c, n_down, ups):
    yi, downs, up_ops, coeffs = exchange_case(3, h, c, n_down, ups)
    got = n(int8_blocks.up_exchange(t(yi), [t(d) for d in downs],
                                    [tuple(t(a) for a in u) for u in up_ops], t(coeffs)))
    fused = jpb.fused_up_exchange(jnp.asarray(yi), [jnp.asarray(d) for d in downs],
                                  [tuple(jnp.asarray(a) for a in u) for u in up_ops], jnp.asarray(coeffs),
                                  interpret=True)
    assert_int8_close(got, fused)
    # the JAX per-op exchange: 1x1 conv sites, nearest upsample, the n-way add
    q = {"convs": {f"s/fuse/up0_{j}": {"w8": jnp.asarray(u[1])[None, None], "m": jnp.asarray(u[2]),
                                       "b": jnp.asarray(u[3])} for j, u in enumerate(up_ops)},
         "adds": {"s/fuse/out0": {"coeffs": jnp.asarray(coeffs)}}}
    ops = jhi._Int8Ops(q, None, None)
    acc = [jhi._Handle(jnp.asarray(yi), None, "yi")] + [jhi._Handle(jnp.asarray(d), None, "d") for d in downs]
    for j, (u, *_) in enumerate(up_ops):
        y = ops.convbn(f"s/fuse/up0_{j}", jhi._Handle(jnp.asarray(u), None, "u"), 1, False)
        acc.append(ops.upsample(y, h // u.shape[1]))
    np.testing.assert_array_equal(got, np.asarray(ops.add("s/fuse/out0", acc, True).value))


def quantized_tree(rng, nblocks, c, prefix="stage2_m0"):
    """A JAX-layout tree with one BasicBlock branch, layer1 and an exchange."""
    def conv(k, cin, cout):
        m, b = requant_vectors(rng, cout, k * k * cin)
        return {"w8": rand_int8(rng, k, k, cin, cout), "m": m, "b": b}

    def coeffs(k):
        return {"coeffs": rng.uniform(0.3, 1.2, k).astype(np.float32)}

    q = {"convs": {}, "adds": {}}
    for k in range(nblocks):
        bn = f"{prefix}/branch0/block{k}"
        q["convs"][f"{bn}/conv1"], q["convs"][f"{bn}/conv2"] = conv(3, c, c), conv(3, c, c)
        q["adds"][bn] = coeffs(2)
        cin = 8 if k == 0 else 32
        q["convs"][f"layer1/block{k}/conv1"] = conv(1, cin, 8)
        q["convs"][f"layer1/block{k}/conv2"] = conv(3, 8, 8)
        q["convs"][f"layer1/block{k}/conv3"] = conv(1, 8, 32)
        q["adds"][f"layer1/block{k}"] = coeffs(2)
    q["convs"]["layer1/block0/down"] = conv(1, 8, 32)
    q["convs"][f"{prefix}/fuse/up0_1"] = conv(1, 2 * c, c)
    q["convs"][f"{prefix}/fuse/up0_2"] = conv(1, 4 * c, c)
    q["adds"][f"{prefix}/fuse/out0"] = coeffs(3)
    return q


def test_packers_match_jax():
    rng = np.random.default_rng(11)
    nblocks, c = 2, 8
    jq = quantized_tree(rng, nblocks, c)
    tq = quantized_to_torch(jq)
    for got, want in zip(int8_blocks.chain_params_from_q(tq, "stage2_m0", 0, nblocks),
                         jpb.chain_params_from_q(jax_tree(jq), "stage2_m0", 0, nblocks)):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    got = int8_blocks.bottleneck_params_from_q(tq, nblocks)
    want = jpb.bottleneck_params_from_q(jax_tree(jq), nblocks)
    assert set(got) == set(want) | {"wk"}  # wk: K6's K-major copies (test_torch_int8_pack.py)
    for key in want:
        np.testing.assert_array_equal(n(got[key]), np.asarray(want[key]), err_msg=key)
    ys = [t(rand_int8(rng, 1, 8 // 2**j, 8 // 2**j, c * 2**j)) for j in range(3)]
    ups, coeffs, wks = int8_blocks.up_exchange_operands(tq, "stage2_m0", 0, ys)
    assert wks is None  # the quantizer's tree holds no K-major copies
    np.testing.assert_array_equal(n(coeffs), jq["adds"]["stage2_m0/fuse/out0"]["coeffs"])
    for j, (y, w, m, b) in enumerate(ups, 1):  # the JAX walk's operand list (hrnet_int8.py:348-357)
        site = jq["convs"][f"stage2_m0/fuse/up0_{j}"]
        assert y is ys[j]
        np.testing.assert_array_equal(n(w), site["w8"][0, 0])
        np.testing.assert_array_equal(n(m), site["m"])
    del tq["convs"]["layer1/block0/down"], tq["convs"]["stage2_m0/fuse/up0_2"]
    assert int8_blocks.bottleneck_params_from_q(tq, nblocks) is None
    assert int8_blocks.up_exchange_operands(tq, "stage2_m0", 0, ys) is None


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor CUDA never reaches a plain version."""
    meta = torch.device("meta")
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8, device=meta)  # noqa: E731
    f32 = lambda *s: torch.zeros(*s, device=meta)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        int8_blocks.basic_block_chain(i8(1, 4, 4, 4), i8(1, 2, 3, 3, 4, 4), f32(1, 2, 4), f32(1, 2, 4), f32(1, 2), 1)
    with pytest.raises(ValueError, match="CUDA"):
        int8_blocks.bottleneck_chain(i8(1, 4, 4, 4), i8(1, 4, 4), f32(1, 4), f32(1, 4), i8(1, 3, 3, 4, 4),
                                     f32(1, 4), f32(1, 4), i8(1, 4, 8), f32(1, 8), f32(1, 8), i8(4, 8), f32(8),
                                     f32(8), f32(1, 2), 1)
    with pytest.raises(ValueError, match="CUDA"):
        int8_blocks.up_exchange(i8(1, 4, 4, 4), [], [], f32(1))
