"""Port parity: ops/pnp (EPnP + Gauss-Newton, the serving solver "gn").

Synthetic SPEED+-like scenes (11 landmarks ~1 m apart, 8-15 m away,
fx ~ 3000 px, 0.5 px noise) go through the JAX solver (vmapped) and the
port (batched). The port's Gauss-Newton Jacobian is analytic where the
JAX one is ``jacfwd``; both are float32, so poses agree to ~1e-4
(rotation entries, absolute) and ~1e-4 relative in translation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import pnp as jpnp
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp

from torch_port_util import n, t

K = np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.22, 0.18, 5e-4, -3e-4, -0.02], np.float32)


def _scene(seed, b=6, j=11):
    rng = np.random.default_rng(seed)
    world = rng.normal(0, 0.8, (j, 3)).astype(np.float32)
    q = rng.normal(size=(b, 4)).astype(np.float32)
    R = np.asarray(jax.vmap(jgeo.quat_to_dcm)(jnp.asarray(q)))
    tr = np.stack([rng.normal(0, 0.5, b), rng.normal(0, 0.3, b), rng.uniform(8, 15, b)], 1).astype(np.float32)
    px = np.asarray(jax.vmap(lambda r, tt: jgeo.project_points(
        jnp.asarray(world), r, tt, jnp.asarray(K), jnp.asarray(DIST)))(jnp.asarray(R), jnp.asarray(tr)))
    px = (px + rng.normal(0, 0.5, px.shape)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (b, j)).astype(np.float32)
    return world, R, tr, px, conf


def test_adaptive_confidence_mask():
    rng = np.random.default_rng(0)
    conf = rng.uniform(0, 1, (20, 11)).astype(np.float32)
    conf[0] = 0.0  # nothing reaches any threshold: the smallest is used
    for min_count in (1, 5, 11, 15):
        want = jax.vmap(lambda c: jpnp.adaptive_confidence_mask(c, min_count=min_count))(jnp.asarray(conf))
        got = tpnp.adaptive_confidence_mask(t(conf), min_count=min_count)
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_fixed_depth_linear_algebra():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 12, 20)).astype(np.float32)
    pd = a @ a.transpose(0, 2, 1) / 20 + 0.1 * np.eye(12, dtype=np.float32)
    np.testing.assert_allclose(n(tpnp._gj_inverse(t(pd))), np.asarray(jax.vmap(jpnp._gj_inverse)(pd)),
                               rtol=1e-4, atol=1e-4)
    psd = a[:, :, :11] @ a[:, :, :11].transpose(0, 2, 1)  # rank 11: a null vector
    want = np.asarray(jax.vmap(jpnp._min_eigvec_pd)(psd))
    got = n(tpnp._min_eigvec_pd(t(psd)))
    np.testing.assert_allclose(np.abs((got * want).sum(-1)), 1.0, atol=1e-4)  # same vector up to sign
    sym = a[:, :4, :4] + a[:, :4, :4].transpose(0, 2, 1)
    np.testing.assert_allclose(n(tpnp._max_eigvec_sym4(t(sym))), np.asarray(jax.vmap(jpnp._max_eigvec_sym4)(sym)),
                               atol=1e-4)


def test_epnp_matches_jax():
    world, _, _, px, conf = _scene(2)
    norm = np.asarray(jgeo.pixels_to_normalized(jnp.asarray(px), jnp.asarray(K), jnp.asarray(DIST), iters=10))
    wR, wt = jax.jit(jax.vmap(lambda p, c: jpnp.epnp(jnp.asarray(world), p, c)))(jnp.asarray(norm), jnp.asarray(conf))
    tR, tt = tpnp.epnp(t(world).expand(6, 11, 3), t(norm), t(conf))
    np.testing.assert_allclose(n(tR), np.asarray(wR), atol=1e-4)
    np.testing.assert_allclose(n(tt), np.asarray(wt), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("iters", [5, 10])
def test_solve_pnp_matches_jax_and_truth(iters):
    world, R, tr, px, conf = _scene(3)
    w = np.asarray(jax.vmap(lambda c: jpnp.adaptive_confidence_mask(c, min_count=6))(jnp.asarray(conf)),
                   np.float32)
    wR, wt = jax.jit(jax.vmap(lambda p, ww: jpnp.solve_pnp(
        jnp.asarray(world), p, jnp.asarray(K), jnp.asarray(DIST), ww, refine_iters=iters)))(jnp.asarray(px), jnp.asarray(w))
    tR, tt = tpnp.solve_pnp(t(world), t(px), t(K), t(DIST), t(w), refine_iters=iters)
    np.testing.assert_allclose(n(tR), np.asarray(wR), atol=1e-4)
    np.testing.assert_allclose(n(tt), np.asarray(wt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(tR), R, atol=2e-2)  # and both find the true pose
    np.testing.assert_allclose(n(tt), tr, rtol=2e-2, atol=2e-2)


def test_degenerate_inputs_stay_finite():
    """All-zero weights and collapsed keypoints: the finite-fallback chain
    hands back a finite pose, as in JAX."""
    world, _, _, px, _ = _scene(4, b=3)
    px[1] = 960.0  # every keypoint on one pixel
    w = np.ones((3, 11), np.float32)
    w[0] = 0.0
    tR, tt = tpnp.solve_pnp(t(world), t(px), t(K), t(DIST), t(w), refine_iters=5)
    wR, wt = jax.jit(jax.vmap(lambda p, ww: jpnp.solve_pnp(
        jnp.asarray(world), p, jnp.asarray(K), jnp.asarray(DIST), ww, refine_iters=5)))(jnp.asarray(px), jnp.asarray(w))
    assert torch.isfinite(tR).all() and torch.isfinite(tt).all()
    assert np.isfinite(np.asarray(wR)).all() and np.isfinite(np.asarray(wt)).all()
    np.testing.assert_allclose(n(tR)[2], np.asarray(wR)[2], atol=1e-4)
