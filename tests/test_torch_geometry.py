"""Port parity: ops/geometry, ops/boxes, ops/heatmap decode, letterbox, top-k ties.

Same numpy inputs through the JAX functions (vmapped) and the port's
batched ones on the CPU. Tolerances: 1e-5 absolute on unit-scale float32
geometry (the same arithmetic, reordered at most by a rounding step);
pixel-scale outputs get 1e-5 relative. Argmax, masks and integer
outputs are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import boxes as jboxes
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import heatmap as jheat
from spacecraft_pose_estimation_tpu_torch.models.rpn import top_k
from spacecraft_pose_estimation_tpu_torch.ops import boxes as tboxes
from spacecraft_pose_estimation_tpu_torch.ops import geometry as tgeo
from spacecraft_pose_estimation_tpu_torch.ops import heatmap as theat
from spacecraft_pose_estimation_tpu_torch.serving import letterbox

from torch_port_util import n, t

RNG = np.random.default_rng(0)
B = 8
QUATS = RNG.normal(size=(B, 4)).astype(np.float32)
RVECS = (RNG.normal(size=(B, 3)) * np.array([[1], [1], [1], [1], [1], [1], [0], [1e-13]])).astype(np.float32)
DIST = np.array([-0.2, 0.1, 1e-3, -2e-3, 0.01], np.float32)
K = np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]], np.float32)
XY = RNG.uniform(-0.3, 0.3, (B, 5, 2)).astype(np.float32)


def _rot(q):
    return np.asarray(jax.vmap(jgeo.quat_to_dcm)(jnp.asarray(q)))


CASES = {
    "quat_to_dcm": (lambda q: jax.vmap(jgeo.quat_to_dcm)(q), tgeo.quat_to_dcm, (QUATS,), 1e-5),
    "rotmat_to_quat": (lambda r: jax.vmap(jgeo.rotmat_to_quat)(r), tgeo.rotmat_to_quat,
                       (_rot(QUATS),), 1e-5),
    "rodrigues": (lambda v: jax.vmap(jgeo.rodrigues)(v), tgeo.rodrigues, (RVECS,), 1e-5),
    "distort": (lambda xy: jgeo.distort_normalized(xy, jnp.asarray(DIST)),
                lambda xy: tgeo.distort_normalized(xy, t(DIST)), (XY,), 1e-6),
    "undistort": (lambda xy: jgeo.undistort_normalized(xy, jnp.asarray(DIST)),
                  lambda xy: tgeo.undistort_normalized(xy, t(DIST)), (XY,), 1e-6),
    "pixels_to_normalized": (
        lambda uv: jgeo.pixels_to_normalized(uv, jnp.asarray(K), jnp.asarray(DIST)),
        lambda uv: tgeo.pixels_to_normalized(uv, t(K), t(DIST)),
        (RNG.uniform(0, 1900, (B, 5, 2)).astype(np.float32),), 1e-6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_elementwise_geometry(name):
    jfn, tfn, args, tol = CASES[name]
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(t(a) for a in args))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=tol)


def test_project_points():
    pts = RNG.normal(size=(6, 3)).astype(np.float32)
    R = _rot(QUATS)
    tr = np.stack([RNG.normal(size=B), RNG.normal(size=B), RNG.uniform(8, 12, B)], 1).astype(np.float32)
    want = jax.vmap(lambda r, tt: jgeo.project_points(
        jnp.asarray(pts), r, tt, jnp.asarray(K), jnp.asarray(DIST)))(jnp.asarray(R), jnp.asarray(tr))
    got = tgeo.project_points(t(pts), t(R), t(tr), t(K), t(DIST))
    # pixels up to ~2000: an ulp there is 1.2e-4 px
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("inv", [False, True])
def test_crop_affine_and_transform_preds(inv):
    centers = RNG.uniform(200, 1700, (B, 2)).astype(np.float32)
    scales = RNG.uniform(0.5, 4.0, (B, 2)).astype(np.float32)
    rots = RNG.uniform(-40, 40, B).astype(np.float32)
    want = jax.vmap(lambda c, s, r: jgeo.crop_affine_matrix(c, s, r, (512, 384), inv=inv))(
        jnp.asarray(centers), jnp.asarray(scales), jnp.asarray(rots))
    got = tgeo.crop_affine_matrix(t(centers), t(scales), t(rots), (512, 384), inv=inv)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)

    coords = RNG.uniform(0, 128, (B, 11, 2)).astype(np.float32)
    want = jax.vmap(lambda c, ctr, s: jgeo.transform_preds(c, ctr, s, (128, 96)))(
        jnp.asarray(coords), jnp.asarray(centers), jnp.asarray(scales))
    got = tgeo.transform_preds(t(coords), t(centers), t(scales), (128, 96))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)


def test_bbox_to_center_scale():
    bb = RNG.uniform(10, 700, (B, 4)).astype(np.float32)
    wc, ws = jax.vmap(jgeo.bbox_to_center_scale)(jnp.asarray(bb))
    tc, ts = tgeo.bbox_to_center_scale(t(bb))
    np.testing.assert_array_equal(n(tc), np.asarray(wc))
    np.testing.assert_array_equal(n(ts), np.asarray(ws))


def _boxes(rng, k):
    xy = rng.uniform(0, 100, (k, 2))
    wh = rng.uniform(-5, 60, (k, 2))  # some empty / inverted boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_ops():
    a, b = _boxes(RNG, 30), _boxes(RNG, 20)
    b[0] = [5, 5, 5, 5]  # zero-area: union 0 against another zero-area box
    a[0] = [5, 5, 5, 5]
    np.testing.assert_allclose(n(tboxes.pairwise_iou(t(a), t(b))),
                               np.asarray(jboxes.pairwise_iou(a, b)), atol=1e-7)
    np.testing.assert_array_equal(n(tboxes.clip_boxes(t(a), 60.0, 80.0)),
                                  np.asarray(jboxes.clip_boxes(a, 60.0, 80.0)))
    np.testing.assert_array_equal(n(tboxes.nonempty_mask(t(a), 1.0)),
                                  np.asarray(jboxes.nonempty_mask(a, 1.0)))
    deltas = (RNG.normal(size=(30, 4)) * [1, 1, 4, 4]).astype(np.float32)  # dw/dh hit SCALE_CLAMP
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        np.testing.assert_allclose(n(tboxes.apply_deltas(t(deltas), t(a), w)),
                                   np.asarray(jboxes.apply_deltas(deltas, a, w)), rtol=1e-6, atol=1e-4)


def test_get_max_preds_ties_and_negatives():
    hm = RNG.normal(size=(2, 6, 7, 5)).astype(np.float32)
    hm[0, 1, 2, 0] = hm[0, 4, 5, 0] = 9.0  # tie: the first in row-major order wins
    hm[1, :, :, 3] = -1.0  # all-negative joint: zero coords
    wp, wv = jheat.get_max_preds(jnp.asarray(hm))
    tp, tv = theat.get_max_preds(t(hm))
    np.testing.assert_array_equal(n(tp), np.asarray(wp))
    np.testing.assert_array_equal(n(tv), np.asarray(wv))


@pytest.mark.parametrize("post_process", [True, False])
def test_decode_heatmaps(post_process):
    hm = RNG.normal(size=(3, 32, 24, 11)).astype(np.float32)
    centers = RNG.uniform(300, 1500, (3, 2)).astype(np.float32)
    scales = RNG.uniform(1, 4, (3, 2)).astype(np.float32)
    wp, wv = jheat.decode_heatmaps(jnp.asarray(hm), jnp.asarray(centers), jnp.asarray(scales), post_process)
    tp, tv = theat.decode_heatmaps(t(hm), t(centers), t(scales), post_process)
    np.testing.assert_allclose(n(tp), np.asarray(wp), rtol=1e-6)
    np.testing.assert_array_equal(n(tv), np.asarray(wv))


def test_top_k_breaks_ties_like_lax():
    x = np.array([1, -np.inf, 3, -np.inf, 3, -np.inf, -np.inf, 0.5], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = top_k(t(x), 6)
    np.testing.assert_array_equal(n(ti), np.asarray(wi))  # [2 4 0 7 1 3]
    np.testing.assert_array_equal(n(tv), np.asarray(wv))
    np.testing.assert_array_equal(n(ti), np.asarray(jnp.argsort(jnp.asarray(x), descending=True))[:6])


@pytest.mark.parametrize("hw", [(120, 192), (200, 150)])
def test_letterbox_matches_jax_resize(hw):
    """Downscaling: jax.image.resize antialiases, so the port must too
    (without antialias the two differ by ~100 grey levels). Tolerance
    1e-3 grey on 0-255."""
    h, w = hw
    size = 64
    frames = RNG.integers(0, 255, (2, h, w, 3)).astype(np.uint8)
    scale = size / max(h, w)
    lb_h, lb_w = int(round(h * scale)), int(round(w * scale))
    want = jax.image.resize(jnp.asarray(frames, jnp.float32), (2, lb_h, lb_w, 3), method="bilinear")
    want = jnp.pad(want, ((0, 0), (0, size - lb_h), (0, size - lb_w), (0, 0)))
    got, got_scale = letterbox(t(frames), size)
    assert got_scale == scale
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-3)
    assert torch.equal(got[:, lb_h:], torch.zeros_like(got[:, lb_h:]))
