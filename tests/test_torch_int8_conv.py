"""Port parity of the int8 conv site (K5a's plain version) against JAX.

The JAX side is the int8 walks' conv: ``jax.lax.conv_general_dilated`` with
``preferred_element_type=int32`` (NHWC, HWIO, zero padding k // 2, stride,
``feature_group_count``) and the epilogue ``f = y * m + b``, relu, then
``clip(round(f), -127, 127)`` as int8 or f32 out. Bound: bit-equal (the
int32 sums are exact on both sides and the epilogue rounds at the same
points).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu_torch.ops import int8_conv

from torch_port_util import n, t


def jax_int8_conv(x, w, m, b, stride, groups, relu, out_f32):
    k = w.shape[0]
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    f = y.astype(jnp.float32) * jnp.asarray(m) + jnp.asarray(b)
    if relu:
        f = jnp.maximum(f, 0)
    return np.asarray(f if out_f32 else jnp.clip(jnp.round(f), -127, 127).astype(jnp.int8))


CASES = [  # k, stride, groups, relu, out_f32
    (3, 1, 1, True, False), (3, 2, 1, False, False), (1, 1, 1, False, True), (1, 2, 1, True, False),
    (3, 1, 4, True, False), (1, 1, 4, False, True), (3, 2, 4, False, True), (7, 2, 1, True, False),
]


@pytest.mark.parametrize("k,stride,groups,relu,out_f32", CASES,
                         ids=[f"k{c[0]}s{c[1]}g{c[2]}{'-relu' if c[3] else ''}{'-f32' if c[4] else '-i8'}" for c in CASES])
def test_int8_conv_matches_jax(k, stride, groups, relu, out_f32):
    rng = np.random.default_rng(k * 100 + stride * 10 + groups)
    cin, cout = 16, 24
    x = rng.integers(-127, 128, (2, 11, 9, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    # scale so the outputs span the int8 range: rounding and clipping both bite
    m = (rng.uniform(0.5, 2.0, cout) * 200.0 / (127 * 127 * np.sqrt(k * k * cin / groups))).astype(np.float32)
    b = rng.uniform(-20, 20, cout).astype(np.float32)
    want = jax_int8_conv(x, w, m, b, stride, groups, relu, out_f32)
    got = int8_conv.int8_conv(t(x), t(w), t(m), t(b), stride=stride, groups=groups, relu=relu, out_f32=out_f32)
    assert got.dtype == (torch.float32 if out_f32 else torch.int8)
    np.testing.assert_array_equal(n(got), want)
    if not out_f32:  # the case exercises both clipping and non-trivial values
        assert 0 < np.mean(np.abs(want) == 127) < 0.5


def test_requant_rounds_half_to_even():
    f = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -200.0, 300.0])
    np.testing.assert_array_equal(n(int8_conv.requant(f)),
                                  np.asarray(jnp.clip(jnp.round(jnp.asarray(n(f))), -127, 127).astype(jnp.int8)))


def test_out_size_matches_the_conv():
    for h, k, s in ((11, 3, 2), (10, 7, 2), (9, 1, 2), (8, 3, 1)):
        x = torch.zeros(1, h, h, 4, dtype=torch.int8)
        w = torch.zeros(k, k, 4, 4, dtype=torch.int8)
        assert int8_conv.int8_conv(x, w, torch.ones(4), torch.zeros(4), stride=s).shape[1] == int8_conv.out_size(h, k, s)


def test_launches_or_raises_off_the_cpu():
    """A tensor on neither the CPU nor CUDA never reaches the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8_conv.int8_conv(torch.zeros(1, 4, 4, 4, dtype=torch.int8, device=meta),
                            torch.zeros(3, 3, 4, 4, dtype=torch.int8, device=meta),
                            torch.ones(4, device=meta), torch.zeros(4, device=meta))
