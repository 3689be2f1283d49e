"""Port parity: ops/warp (kernel K1's plain version) against the JAX crops.

References: the Pallas windowed crop (``crop_and_resize_window`` in
float32, interpret mode on the CPU), the XLA windowed crop and the
full-frame ``crop_and_resize_mxu``. Tolerance 1e-3 grey on 0-255: the
same taps, the rows summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import pallas_crop, warp as jwarp
from spacecraft_pose_estimation_tpu.ops.geometry import PIXEL_STD
from spacecraft_pose_estimation_tpu_torch.ops import warp as twarp

from torch_port_util import n, t


def _frames(rng, b=3, h=200, w=320):
    return rng.integers(0, 255, (b, h, w, 3)).astype(np.uint8)


CENTERS = {
    "inside": np.array([[160.0, 100.0], [80.0, 60.0], [250.0, 150.0]], np.float32),
    "border": np.array([[6.0, 4.0], [316.0, 196.0], [160.0, 2.0]], np.float32),
}


@pytest.mark.parametrize("where", sorted(CENTERS))
def test_matches_pallas_windowed_crop(where):
    rng = np.random.default_rng(1)
    frames = _frames(rng)
    centers = CENTERS[where]
    scales = np.full((3, 2), 90.0 / PIXEL_STD, np.float32)
    want = pallas_crop.crop_and_resize_window(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales), (64, 48), (160, 256),
        compute_dtype=jnp.float32,
    )
    got = twarp.crop_and_resize(t(frames), t(centers), t(scales), (64, 48))
    assert got.shape == (3, 48, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-3)


def test_matches_full_frame_and_xla_window():
    rng = np.random.default_rng(2)
    frames = _frames(rng)
    centers = CENTERS["inside"]
    scales = rng.uniform(0.3, 0.6, (3, 2)).astype(np.float32)
    full = jax.vmap(lambda im, c, s: jwarp.crop_and_resize_mxu(im, c, s, (40, 40)))(
        jnp.asarray(frames, jnp.float32), jnp.asarray(centers), jnp.asarray(scales))
    xla_win = jax.vmap(lambda im, c, s: jwarp.crop_and_resize_mxu_windowed(im, c, s, (40, 40), 160))(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales))
    got = n(twarp.crop_and_resize(t(frames), t(centers), t(scales), (40, 40)))
    # XLA's CPU backend may fuse a * x + b into one FMA, and the XLA window
    # re-derives the affine around a shifted centre: either moves a sample
    # point by an ulp (3e-5 px at x ~ 300), which a grey step of up to
    # 255 per px turns into ~1e-2. Hence 2e-2 grey here.
    np.testing.assert_allclose(got, np.asarray(full), atol=2e-2)
    np.testing.assert_allclose(got, np.asarray(xla_win), atol=2e-2)


@pytest.mark.parametrize("coverage", [None, (766, 766)], ids=["pallas", "xla"])
def test_clamp_scales_to_window(coverage):
    """Both coverages of pipeline.py:86-92. At 768 they differ: the
    serving 750-px box (scale 3.75) is clamped only under 'pallas'."""
    scales = np.array([[3.75, 3.15], [1.0, 1.0], [9.0, 2.0]], np.float32)
    want = pallas_crop.clamp_scales_to_window(jnp.asarray(scales), (512, 512), (768, 768), coverage=coverage)
    got = twarp.clamp_scales_to_window(t(scales), (512, 512), (768, 768), coverage=coverage)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert twarp.window_coverage((768, 768)) == pallas_crop.window_coverage((768, 768)) == (735, 639)
    assert (n(got)[0, 0] < 3.75) == (coverage is None)


def test_crop_params_are_the_inverse_affine():
    centers, scales = CENTERS["inside"], np.full((3, 2), 0.45, np.float32)
    p = n(twarp.crop_params(t(centers), t(scales), (64, 48)))
    M = np.asarray(jax.vmap(lambda c, s: jgeo.crop_affine_matrix(c, s, 0.0, (64, 48), inv=True))(
        jnp.asarray(centers), jnp.asarray(scales)))
    np.testing.assert_array_equal(p, np.stack([M[:, 0, 0], M[:, 0, 2], M[:, 1, 1], M[:, 1, 2]], 1))


# K1's coverage shapes (chip_smoke.py's check_crop_coverage): (frame h, w), out (w, h), step, centre
COVERAGE = {
    "odd_out_size": ((120, 160), (37, 29), 1.3, (80.0, 60.0)),
    "event_346x260": ((260, 346), (64, 48), 0.36, (330.0, 10.0)),
    "wholly_off_frame": ((120, 160), (40, 24), 1.0, (-300.0, 500.0)),
    "up_x8": ((120, 160), (45, 33), 0.125, (100.0, 70.0)),
    "down_x6": ((200, 320), (50, 31), 6.0, (170.0, 95.0)),
}


@pytest.mark.parametrize("case", sorted(COVERAGE))
def test_plain_matches_full_frame_on_coverage_shapes(case):
    """The plain K1 (the card's coverage check holds the kernel to it) against
    the JAX full-frame crop on the shapes the kernel's tiling finds delicate:
    an output of odd width and height, a 346x260 event frame (a row of 1,038
    bytes), a crop wholly off the frame, x8 up- and x6 downsampling. 2e-2
    grey, as in test_matches_full_frame_and_xla_window: XLA may fuse the
    affine into an FMA and move a sample point by an ulp."""
    (h, w), size, step, centre = COVERAGE[case]
    rng = np.random.default_rng(7)
    frames = _frames(rng, b=2, h=h, w=w)
    centers = np.array([centre, [w * 0.5, h * 0.5]], np.float32)
    scales = np.full((2, 2), step * size[0] / PIXEL_STD, np.float32)
    # jitted: one compile a shape is quicker than eager vmap's per-primitive ones
    want = jax.jit(jax.vmap(lambda im, c, s: jwarp.crop_and_resize_mxu(im, c, s, size)))(
        jnp.asarray(frames, jnp.float32), jnp.asarray(centers), jnp.asarray(scales))
    params = twarp.crop_params(t(centers), t(scales), size)
    got = twarp.crop_bilinear_plain(t(frames), params, size)
    assert got.shape == (2, size[1], size[0], 3)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-2)
    assert abs(float(params[0, 0]) - step) < 1e-4 * step
    if case == "wholly_off_frame":
        assert not n(got)[0].any()


def test_traced_cuda_call_goes_through_the_operator():
    """K1's wrapper skips the dispatcher only on an eager call with real CUDA
    tensors: traced with fake CUDA tensors (as ``torch.export`` traces the
    pose program on the card) it records ``spe_port::crop_bilinear`` and
    launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    launches = twarp.KERNEL.launches
    with FakeTensorMode():
        frames = torch.empty(2, 30, 40, 3, dtype=torch.uint8, device="cuda")
        params = torch.empty(2, 4, device="cuda")
        gm = make_fx(lambda f, p: twarp.crop_bilinear(f, p, (16, 8)))(frames, params)
    targets = [node.target for node in gm.graph.nodes if node.op == "call_function"]
    assert targets == [torch.ops.spe_port.crop_bilinear.default]
    assert twarp.KERNEL.launches == launches
