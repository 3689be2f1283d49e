"""Port parity of the space-to-depth formulations (``ops/s2d.py``) against JAX.

Mirrors ``tests/test_s2d.py``: the activation packings, the weight packs and
the packed convs, on int8 inputs made from a numpy seed. The port's packs
equal the JAX package's array for array, and each packed conv (K5a with
explicit padding, its plain version here) equals both the JAX packed conv
and the direct 3x3 or 1x1 conv it stands for, bit for bit: the packs are
zero scatters, so the int32 sums are the same multisets of products. The
convs run with m = 1, b = 0 and the f32 epilogue, which returns the int32
sums exactly (they stay far below 2^24 here). K5a's explicit padding and its
per-channel clip (``lo``) are held to JAX's conv and ``jnp.clip`` too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import s2d as js2d
from spacecraft_pose_estimation_tpu_torch.ops import int8_conv, s2d

from torch_port_util import n, t


def rnd_int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def direct(x, w, stride=1):
    """JAX's direct int8 conv, SAME padding k // 2, int32 sums."""
    k = w.shape[0]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))


def sums(conv, x, wp):
    """A port packed conv's int32 sums: m = 1, b = 0, the f32 epilogue."""
    c = wp.shape[-1]
    out = conv(t(x), t(wp), torch.ones(c), torch.zeros(c), out_f32=True)
    return n(out).astype(np.int32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_pack_even_matches_jax(rng):
    x = rnd_int8(rng, (2, 16, 12, 5))
    got = s2d.pack_even(t(x))
    np.testing.assert_array_equal(n(got), np.asarray(js2d.pack_even(jnp.asarray(x))))
    assert got.is_contiguous()
    np.testing.assert_array_equal(n(s2d.unpack_even(got)), x)
    np.testing.assert_array_equal(n(s2d.unpack_even(got)), np.asarray(js2d.unpack_even(js2d.pack_even(jnp.asarray(x)))))


@pytest.mark.parametrize("h2p,w2p,c", [(9, 7, 5), (2, 3, 1)])
def test_odd_zero_mask_matches_jax(h2p, w2p, c):
    np.testing.assert_array_equal(n(s2d.odd_zero_mask(h2p, w2p, c)), np.asarray(js2d.odd_zero_mask(h2p, w2p, c)))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_std_to_even_matches_jax(rng, factor):
    u = rnd_int8(rng, (2, 4, 4, 3))
    want = np.asarray(js2d.upsample_std_to_even(jnp.asarray(u), factor))
    np.testing.assert_array_equal(n(s2d.upsample_std_to_even(t(u), factor)), want)
    # and it is the even packing of the direct nearest upsample
    big = np.repeat(np.repeat(u, factor, axis=1), factor, axis=2)
    np.testing.assert_array_equal(want, np.asarray(js2d.pack_even(jnp.asarray(big))))


PACKS = ["w3_pack_alt", "w3_pack_from_std", "w3_pack_down", "w3_pack_even3", "w1_pack", "tile_vec"]


@pytest.mark.parametrize("name", PACKS)
def test_weight_packs_match_jax(rng, name):
    shape = {"w1_pack": (1, 1, 5, 7), "tile_vec": (7,)}.get(name, (3, 3, 5, 7))
    w = rnd_int8(rng, shape)
    got, want = getattr(s2d, name)(w), getattr(js2d, name)(w)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(getattr(s2d, name)(torch.from_numpy(w)), want)  # from the tree's tensors


def _pack_odd(y):
    """The odd packing of a std (B, H, W, C) tensor, zeros outside the image."""
    b, h, w, c = y.shape
    yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((b, h // 2 + 1, w // 2 + 1, 4 * c), y.dtype)
    for i in range(h // 2 + 1):
        for j in range(w // 2 + 1):
            for dy in range(2):
                for dx in range(2):
                    pos = 2 * dy + dx
                    out[:, i, j, pos * c:(pos + 1) * c] = yp[:, 2 * i + dy, 2 * j + dx]
    return out


def test_even_to_odd_exact(rng):
    """even -> odd (2x2, padding (1, 1)), masked: the odd packing of the direct 3x3."""
    x, w3 = rnd_int8(rng, (2, 16, 12, 5)), rnd_int8(rng, (3, 3, 5, 7))
    xp, wp = n(s2d.pack_even(t(x))), s2d.w3_pack_alt(w3)
    got = sums(s2d.conv_even_to_odd, xp, wp)
    assert got.shape == (2, 9, 7, 28)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_even_to_odd(jnp.asarray(xp), jnp.asarray(wp))))
    masked = got * n(s2d.odd_zero_mask(9, 7, 7, torch.int32))
    np.testing.assert_array_equal(masked, _pack_odd(direct(x, w3)))


def test_odd_to_even_exact(rng):
    """odd -> even (2x2, no padding): the even packing of the direct 3x3."""
    y, w3 = rnd_int8(rng, (2, 16, 12, 5)), rnd_int8(rng, (3, 3, 5, 4))
    yo, wp = _pack_odd(y), s2d.w3_pack_alt(w3)
    got = sums(s2d.conv_odd_to_even, yo, wp)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_odd_to_even(jnp.asarray(yo), jnp.asarray(wp))))
    np.testing.assert_array_equal(n(s2d.unpack_even(torch.from_numpy(got))), direct(y, w3))


def test_std_to_even_exact(rng):
    """The entry (4x4, stride 2, padding (1, 1)) on a std input: the even packing of the direct 3x3."""
    x, w3 = rnd_int8(rng, (2, 16, 12, 7)), rnd_int8(rng, (3, 3, 7, 3))
    wp = s2d.w3_pack_from_std(w3)
    got = sums(s2d.conv_std_to_even, x, wp)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_std_to_even(jnp.asarray(x), jnp.asarray(wp))))
    np.testing.assert_array_equal(n(s2d.unpack_even(torch.from_numpy(got))), direct(x, w3))


def test_even_down_exact(rng):
    """The exit (2x2, padding (1, 0)) from an even input: the direct 3x3 stride-2 conv."""
    x, w3 = rnd_int8(rng, (2, 16, 12, 5)), rnd_int8(rng, (3, 3, 5, 9))
    xp, wp = n(s2d.pack_even(t(x))), s2d.w3_pack_down(w3)
    got = sums(s2d.conv_even_down, xp, wp)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_even_down(jnp.asarray(xp), jnp.asarray(wp))))
    np.testing.assert_array_equal(got, direct(x, w3, stride=2))


def test_1x1_exact(rng):
    x, w1 = rnd_int8(rng, (2, 8, 8, 6)), rnd_int8(rng, (1, 1, 6, 10))
    xp, wp = n(s2d.pack_even(t(x))), s2d.w1_pack(w1)
    got = sums(s2d.conv_even_1x1, xp, wp)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_even_1x1(jnp.asarray(xp), jnp.asarray(wp))))
    np.testing.assert_array_equal(n(s2d.unpack_even(torch.from_numpy(got))), direct(x, w1))


def test_even3_exact(rng):
    x, w3 = rnd_int8(rng, (2, 16, 12, 5)), rnd_int8(rng, (3, 3, 5, 7))
    xp, wp = n(s2d.pack_even(t(x))), s2d.w3_pack_even3(w3)
    got = sums(s2d.conv_even3, xp, wp)
    np.testing.assert_array_equal(got, np.asarray(js2d.conv_even3(jnp.asarray(xp), jnp.asarray(wp))))
    np.testing.assert_array_equal(n(s2d.unpack_even(torch.from_numpy(got))), direct(x, w3))


@pytest.mark.parametrize("scheme", ["alt", "even3"])
def test_block_chain_exact(rng, scheme):
    """A BasicBlock (conv-relu-conv, residual add, requantized at each step)
    packed end to end equals the direct int8 block: the port's requant
    epilogues on the packed convs against JAX's direct convs."""
    x, w1, w2 = rnd_int8(rng, (2, 16, 16, 6)), rnd_int8(rng, (3, 3, 6, 6)), rnd_int8(rng, (3, 3, 6, 6))
    m, b = np.float32(0.01), np.float32(0.0)

    def rq(acc):
        return np.clip(np.round(acc.astype(np.float32) * m + b), -127, 127).astype(np.int8)

    h1 = rq(np.maximum(direct(x, w1), 0))
    want = rq(direct(h1, w2) + x.astype(np.int32) * 50)
    xp = s2d.pack_even(t(x))
    pack, first, second = ((s2d.w3_pack_alt, s2d.conv_even_to_odd, s2d.conv_odd_to_even) if scheme == "alt"
                           else (s2d.w3_pack_even3, s2d.conv_even3, s2d.conv_even3))
    a1 = first(xp, t(pack(w1)), torch.full((24,), float(m)), torch.zeros(24), relu=True)  # K5a's epilogue
    if scheme == "alt":
        a1 = a1 * s2d.odd_zero_mask(9, 9, 6, torch.int8)
    acc = sums(second, n(a1), pack(w2))
    got = rq(acc + n(xp).astype(np.int32) * 50)
    np.testing.assert_array_equal(n(s2d.unpack_even(torch.from_numpy(got))), want)


PADDINGS = [((1, 1), (1, 1)), ((0, 0), (0, 0)), ((1, 0), (1, 0)), ((2, 1), (0, 3))]


@pytest.mark.parametrize("k,stride,padding", [(2, 1, p) for p in PADDINGS] + [(4, 2, PADDINGS[0]), (3, 2, PADDINGS[3])])
def test_int8_conv_explicit_padding_matches_jax(k, stride, padding):
    """K5a's plain version at even kernel sizes and explicit paddings against
    JAX's conv with the same padding, with its requant epilogue; out_size
    agrees with the output."""
    rng = np.random.default_rng(k * 10 + stride)
    x, w = rnd_int8(rng, (2, 11, 9, 8)), rnd_int8(rng, (k, k, 8, 12))
    m = (rng.uniform(0.5, 2.0, 12) * 200.0 / (127 * 127 * np.sqrt(k * k * 8))).astype(np.float32)
    b = rng.uniform(-20, 20, 12).astype(np.float32)
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), padding,
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    want = np.asarray(jnp.clip(jnp.round(y.astype(jnp.float32) * m + b), -127, 127).astype(jnp.int8))
    got = int8_conv.int8_conv(t(x), t(w), t(m), t(b), stride=stride, padding=padding)
    np.testing.assert_array_equal(n(got), want)
    assert got.shape[1:3] == (int8_conv.out_size(11, k, stride, padding[0]),
                              int8_conv.out_size(9, k, stride, padding[1]))


def test_int8_conv_per_channel_clip_matches_jax():
    """K5a's ``lo``: clip(round(f), lo, 127) per output channel, the merged
    fuse conv's epilogue (``models/hrnet_int8.py`` ``_merged_fuse_conv``)."""
    rng = np.random.default_rng(3)
    x, w = rnd_int8(rng, (2, 9, 9, 8)), rnd_int8(rng, (3, 3, 8, 16))
    m = (rng.uniform(0.5, 2.0, 16) * 200.0 / (127 * 127 * np.sqrt(72))).astype(np.float32)
    b = rng.uniform(-20, 20, 16).astype(np.float32)
    lo = np.where(np.arange(16) < 8, 0.0, -127.0).astype(np.float32)
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), [(1, 1)] * 2,
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    want = np.asarray(jnp.clip(jnp.round(y.astype(jnp.float32) * m + b), lo, 127.0).astype(jnp.int8))
    got = n(int8_conv.int8_conv(t(x), t(w), t(m), t(b), stride=2, lo=t(lo)))
    np.testing.assert_array_equal(got, want)
    assert (got[..., :8] >= 0).all() and (got[..., 8:] < 0).any()
    # the relu flag's channels equal a relu conv's, the others a plain one's
    relu = n(int8_conv.int8_conv(t(x), t(w), t(m), t(b), stride=2, relu=True))
    np.testing.assert_array_equal(got[..., :8], relu[..., :8])


def test_int8_conv_rejects_what_it_does_not_take():
    x, w = torch.zeros(1, 4, 4, 4, dtype=torch.int8), torch.zeros(3, 3, 4, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="lo"):
        int8_conv.int8_conv(x, w, torch.ones(4), torch.zeros(4), out_f32=True, lo=torch.zeros(4))
    with pytest.raises(ValueError, match="negative padding"):
        int8_conv.int8_conv(x, w, torch.ones(4), torch.zeros(4), padding=((1, -1), (1, 1)))
