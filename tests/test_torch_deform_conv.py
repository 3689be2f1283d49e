"""Port parity of ``ops/deform_conv.py`` on the CPU against the JAX package.

* ``deform_conv2d`` v1 and v2 (mask) at stride 1 and 2 on seeded 8x10
  NHWC maps, batch 2, 3x3 kernels: the offsets put taps in (-1, 0) and
  (H-1, H) (read at full weight from the edge row or column, the JAX rule:
  clamped first, zeroed only outside (-1, H)), on integer positions, and
  wholly outside the map; within 1e-5 of the output's scale. Each image
  goes through the JAX single-image function.
* ``DeformConv`` (v2 and v1, strides 1 and 2) with JAX's parameters (a
  seeded, non-zero ``offset_conv`` kernel, so the learned offsets move the
  taps by pixels) carried by ``convert.flax_to_state_dict``: within 1e-5 of
  scale.
* a stride that does not divide the map raises, where JAX fails on the
  shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import deform_conv as jdc
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.ops import deform_conv as tdc

from torch_port_util import n, random_variables, t, to_jax

B, H, W, CIN, COUT = 2, 8, 10, 4, 6


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, CIN)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, CIN, COUT)).astype(np.float32)
    off = rng.uniform(-3, 3, (B, H, W, 18))
    # exact edge cases at the corners of the map: taps in (-1, 0), in (h-1, h),
    # on integers, and beyond (-1, h)
    off[:, 0, 0, 0::2] = -0.5  # the centre row's taps at y = -0.5 - 1, -0.5, 0.5
    off[:, 0, 1, 1::2] = -1.6
    off[:, H - 1, W - 1, 0::2] = 0.4  # y in (H-1, H) for the lower taps
    off[:, H - 1, 0, 1::2] = 2.0
    off[:, 3, 4] = np.round(off[:, 3, 4])
    off[:, 2, 2, 0::2] = -5.0
    mask = rng.uniform(0, 2, (B, H, W, 9)).astype(np.float32)
    return x, off.astype(np.float32), kernel, mask


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_matches_jax(stride, modulated):
    x, off, kernel, mask = _inputs(stride + 2 * modulated)
    m = mask if modulated else None
    fn = jax.jit(jax.vmap(lambda xi, oi, mi: jdc.deform_conv2d(xi, oi, jnp.asarray(kernel), mi, stride),
                          in_axes=(0, 0, 0 if modulated else None)))
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(off), None if m is None else jnp.asarray(m)))
    got = n(tdc.deform_conv2d(t(x), t(off), t(kernel), None if m is None else t(m), stride))
    assert got.shape == want.shape == (B, H // stride, W // stride, COUT)
    _close(got, want)


def test_edge_taps_follow_the_clamp_first_rule():
    """A single-channel map and the centre tap alone: a tap at y = -0.5
    reads row 0 at full weight, one at y = h - 0.6 the last row at full
    weight, and one at y = -1 or y = h reads 0, in both packages."""
    x = np.arange(1, 1 + H * W, dtype=np.float32).reshape(1, H, W, 1)
    kernel = np.zeros((3, 3, 1, 1), np.float32)
    kernel[1, 1] = 1.0
    off = np.zeros((1, H, W, 18), np.float32)
    off[0, 0, 3, 8] = -0.5
    off[0, H - 1, 3, 8] = 0.4
    off[0, 0, 5, 8] = -1.0
    off[0, H - 1, 5, 8] = 1.0
    got = n(tdc.deform_conv2d(t(x), t(off), t(kernel)))[0, ..., 0]
    want = np.asarray(jdc.deform_conv2d(jnp.asarray(x[0]), jnp.asarray(off[0]), jnp.asarray(kernel)))[..., 0]
    np.testing.assert_array_equal(got, want)
    assert got[0, 3] == x[0, 0, 3, 0] and got[H - 1, 3] == x[0, H - 1, 3, 0]
    assert got[0, 5] == 0.0 and got[H - 1, 5] == 0.0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [True, False], ids=["v2", "v1"])
def test_deform_conv_module_matches_jax(stride, modulated):
    x = np.random.default_rng(5).normal(size=(B, H, W, CIN)).astype(np.float32)
    jm = jdc.DeformConv(COUT, stride=stride, modulated=modulated)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=6,
                                 overrides={"offset_conv": 0.5})  # offsets of ~1-2 px
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    tm = tdc.DeformConv(CIN, COUT, stride=stride, modulated=modulated, device="cpu")
    tm.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(tm(t(x)))
    _close(got, want)


def test_stride_must_divide_the_map():
    x, off, kernel, _ = _inputs(0)
    with pytest.raises(ValueError, match="stride 3"):
        tdc.deform_conv2d(t(x), t(off), t(kernel), stride=3)
