"""Port parity: ops/pnp RANSAC (``pnp_ransac``) and the pipeline's ``solver="ransac"``.

Both packages get the same draws. ``jax.random.choice(replace=False, p=p)``
is Gumbel top-k on ``jax.random.gumbel(k_h, (N,))`` with per-frame keys
``split(key, B)`` and per-hypothesis keys ``split(k_b, H)``; the test
makes that noise with JAX and hands it to the port as ``gumbel``. Scenes
are SPEED+-like (``tests/test_torch_pnp.py``'s camera): clean, with 30%
outliers, with too few confident points (the uniform-``p`` guard), with
garbage keypoints (the finite-fallback chain) and with points behind the
camera.

In float64 (both packages: JAX under ``jax.enable_x64``) the two agree on
every hypothesis of every frame: each point's reprojection error under
each hypothesis within 1e-5 relative, the per-hypothesis inlier masks
exactly (leaving out points with |err - 15| < 1e-3), the inlier counts
and the chosen hypothesis, and R and t within GN's tolerance (1e-4), on
every frame but the one whose keypoints all sit on one pixel (EPnP's
system has no unique solution there; held to a finite pose and equal
counts). A wrong subset gather, argmax or hypothesis EPnP fails there.

In float32, the precision the port runs, a hypothesis is EPnP on a
minimal subset of 6, which rounding moves by up to a few 1e-3 in rotation
in either package on near-affine views (both are that far from float64).
So a reprojection within a few px of 15 can flip in or out of a
hypothesis's inlier set: the masks differ on at most 1.1% of the
(hypothesis, point) pairs of a case away from the threshold (bound: 2%).
Inlier counts of the final poses are held exactly everywhere, and R and t
to 1e-4 on the frames where both packages refine from the same hypothesis
inliers, at least 3 of them (6 equations for 6 unknowns); how many frames
that is, per case, is held to the count measured (``HELD_F32``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import pnp as jpnp
from spacecraft_pose_estimation_tpu_torch import pipeline as tpipe
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp

from torch_port_util import few_threads  # noqa: F401 (the fixture)
from torch_port_util import jax_gumbel, jax_hypotheses, n, port_hypotheses, random_variables, t, to_jax

pytestmark = pytest.mark.usefixtures("few_threads")

K = np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.22, 0.18, 5e-4, -3e-4, -0.02], np.float32)
H, S, THRESH = 64, 6, 15.0


def _scene(seed, case, j, b=4):
    """(world (N, 3) or, for "behind", (b, N, 3); R; t; px; conf; dist)."""
    rng = np.random.default_rng(seed)
    world = rng.normal(0, 0.8, (j, 3)).astype(np.float32)
    q = rng.normal(size=(b, 4)).astype(np.float32)
    R = np.asarray(jax.vmap(jgeo.quat_to_dcm)(jnp.asarray(q)))
    tr = np.stack([rng.normal(0, 0.5, b), rng.normal(0, 0.3, b), rng.uniform(8, 15, b)], 1).astype(np.float32)
    dist = DIST
    if case == "behind":
        # per frame, 2 points 0.5 m behind the camera, the rest 3-5 m ahead;
        # no distortion: Brown's polynomial is not meant 60 degrees off-axis
        cam = np.concatenate([rng.uniform(-0.8, 0.8, (b, j, 2)), rng.uniform(3, 5, (b, j, 1))], -1)
        cam[:, :2, 2] = -0.5
        world = np.einsum("bij,bnj->bni", R.transpose(0, 2, 1), cam - tr[:, None]).astype(np.float32)
        dist = np.zeros(5, np.float32)
    px = np.asarray(jax.vmap(lambda w, r, tt: jgeo.project_points(w, r, tt, jnp.asarray(K), jnp.asarray(dist)))(
        jnp.asarray(np.broadcast_to(world, (b, j, 3))), jnp.asarray(R), jnp.asarray(tr)))
    px = (px + rng.normal(0, 0.5, px.shape)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (b, j)).astype(np.float32)
    if case == "outliers":
        bad = rng.permutation(j)[: int(round(0.3 * j))]
        px[:, bad] += rng.choice([-1, 1], (b, len(bad), 2)) * rng.uniform(150, 400, (b, len(bad), 2))
    elif case == "guard":  # 3 points above the smallest adaptive threshold, fewer than a subset
        conf[:] = 1e-12
        conf[:, :3] = 0.9
    elif case == "garbage":
        px[0] = 960.0  # every keypoint on one pixel
        px[1, :] = np.nan
        px[2, 1] = np.inf
        conf[3] = 0.0
    return world, R, tr, px.astype(np.float32), conf, dist


def _jax_ransac(world, px, conf, dist, key, min_count, k_mat=K):
    b = px.shape[0]
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(lambda w, p, c, k: jpnp.pnp_ransac(
        w, p, jnp.asarray(k_mat), jnp.asarray(dist), c, k, num_hypotheses=H, sample_size=S,
        reproj_threshold=THRESH, refine_iters=10, min_count=min_count)))(
        jnp.asarray(np.broadcast_to(world, (b, *world.shape[-2:]))), jnp.asarray(px), jnp.asarray(conf),
        jax.random.split(key, b)))


@pytest.mark.parametrize("j", [11, 17])
@pytest.mark.parametrize("case", ["clean", "outliers", "guard"])
def test_subsets_equal_jax_random_choice(case, j):
    """The port's Gumbel top-k picks jax.random.choice's indices, in order."""
    conf = _scene(10 + j, case, j)[4]
    min_count = 6
    key = jax.random.key(3)
    gumbel = jax_gumbel(key, conf.shape[0], H, j)
    valid = np.asarray(jax.vmap(lambda c: jpnp.adaptive_confidence_mask(c, min_count=min_count))(jnp.asarray(conf)))
    vf = valid.astype(np.float32)
    p_jax = np.where(vf.sum(-1, keepdims=True) >= S, vf / np.maximum(vf.sum(-1, keepdims=True), 1.0),
                     np.float32(1.0 / j)).astype(np.float32)
    choice = lambda kh, i: np.asarray(jax.random.choice(kh, j, shape=(S,), replace=False, p=jnp.asarray(p_jax[i])))
    want = np.stack([np.stack([choice(kh, i) for kh in jax.random.split(kb, H)])
                     for i, kb in enumerate(jax.random.split(key, len(conf)))])
    p = tpnp.sampling_probs(tpnp.adaptive_confidence_mask(t(conf), min_count=min_count), S)
    np.testing.assert_array_equal(n(p), p_jax)
    got = tpnp.sample_subsets(t(gumbel), p, S)
    np.testing.assert_array_equal(n(got), want)
    if case == "guard":
        assert (want >= 3).any()  # the uniform p draws the unconfident points too


def _assert_masks_equal(got, want, err):
    away = np.abs(err - THRESH) >= 1e-3
    np.testing.assert_array_equal(got[away], want[away])


def _away(a, b):
    """(hypothesis, point) pairs whose errors in both packages are 1e-3 or more from the threshold."""
    with np.errstate(invalid="ignore"):
        return ~((np.abs(a["err"] - THRESH) < 1e-3) | (np.abs(b["err"] - THRESH) < 1e-3))


CASES = ["clean", "outliers", "guard", "garbage", "behind"]
# float32 frames (of 4) that both packages refine from the same >= 3 hypothesis inliers, as measured:
# outliers N 11 frame 0 has no hypothesis inlier and frame 1 one flipped point; garbage keeps frame 2 only
HELD_F32 = {("clean", 11): 4, ("outliers", 11): 2, ("guard", 11): 4, ("garbage", 11): 1, ("behind", 11): 4,
            ("clean", 17): 4, ("outliers", 17): 4, ("guard", 17): 4, ("garbage", 17): 1, ("behind", 17): 4}


@pytest.mark.parametrize("j", [11, 17])
@pytest.mark.parametrize("case", CASES)
def test_pnp_ransac_matches_jax_in_float64(case, j):
    world, _, _, px, conf, dist = (np.asarray(x, np.float64) for x in _scene(20 + j, case, j))
    min_count, key = 15, jax.random.key(5)
    gumbel = jax_gumbel(key, len(px), H, j).astype(np.float64)
    with jax.enable_x64(True):
        want = _jax_ransac(world, px, conf, dist, key, min_count, K.astype(np.float64))
        hj = jax_hypotheses(world, px, conf, K.astype(np.float64), dist, key, H, S, THRESH, min_count)
    got = {k: n(v) for k, v in tpnp.pnp_ransac(
        t(world), t(px), t(K, torch.float64), t(dist), t(conf), gumbel=t(gumbel), num_hypotheses=H, sample_size=S,
        reproj_threshold=THRESH, refine_iters=10, min_count=min_count).items()}
    hp = port_hypotheses(world, px, conf, K.astype(np.float64), dist, gumbel, S, THRESH, min_count)
    assert want["R"].dtype == got["R"].dtype == hj["err"].dtype == hp["err"].dtype == np.float64
    # every frame but the one-pixel garbage frame has a determined pose
    frames = [i for i in range(len(px)) if not (case == "garbage" and i == 0)]
    away = _away(hj, hp)
    print(f"\n{case}, N {j}: {int((~away).sum())} (hypothesis, point) pairs within 1e-3 of the threshold")
    np.testing.assert_array_equal(hp["inl"][away], hj["inl"][away])
    fin = np.isfinite(hj["err"][frames]) & np.isfinite(hp["err"][frames])
    np.testing.assert_allclose(hp["err"][frames][fin], hj["err"][frames][fin], rtol=1e-5)
    clear = away.all((-2, -1))  # frames where no near-threshold point can move the argmax
    np.testing.assert_array_equal(hp["scores"][clear], hj["scores"][clear])
    np.testing.assert_array_equal(hp["best"][clear], hj["best"][clear])
    np.testing.assert_array_equal(got["num_inliers"], want["num_inliers"])
    assert np.isfinite(got["R"]).all() and np.isfinite(got["t"]).all()
    np.testing.assert_allclose(got["R"][frames], want["R"][frames], atol=1e-4)
    np.testing.assert_allclose(got["t"][frames], want["t"][frames], rtol=1e-4, atol=1e-4)
    err = n(tpnp._reproj_err(t(world), t(px), t(K, torch.float64), t(dist), t(got["R"]), t(got["t"])))
    _assert_masks_equal(got["inliers"], want["inliers"], err)


@pytest.mark.parametrize("j", [11, 17])
@pytest.mark.parametrize("case", CASES)
def test_pnp_ransac_matches_jax(case, j):
    world, R_true, t_true, px, conf, dist = _scene(20 + j, case, j)
    min_count = 15  # PipelineConfig's min_keypoints: with 11 or 17 points, every confident one is valid
    key = jax.random.key(5)
    gumbel = jax_gumbel(key, len(px), H, j)
    want = _jax_ransac(world, px, conf, dist, key, min_count)
    got = tpnp.pnp_ransac(t(world), t(px), t(K), t(dist), t(conf), gumbel=t(gumbel),
                          num_hypotheses=H, sample_size=S, reproj_threshold=THRESH, refine_iters=10,
                          min_count=min_count)
    assert torch.isfinite(got["R"]).all() and torch.isfinite(got["t"]).all()
    np.testing.assert_array_equal(n(got["num_inliers"]), want["num_inliers"])
    hj = jax_hypotheses(world, px, conf, K, dist, key, H, S, THRESH, min_count)
    hp = port_hypotheses(world, px, conf, K, dist, gumbel, S, THRESH, min_count)
    away = _away(hj, hp)
    off = int((hp["inl"] != hj["inl"])[away].sum())
    held = [i for i in range(len(px)) if (hp["best_inl"][i] == hj["best_inl"][i]).all() and hp["best_inl"][i].sum() >= 3]
    print(f"\n{case}, N {j}: per-hypothesis masks differ on {off} of {int(away.sum())} pairs away from the "
          f"threshold; frames held to 1e-4: {held} of {len(px)}")
    assert off <= 0.02 * away.sum()
    assert len(held) >= HELD_F32[case, j]
    np.testing.assert_allclose(n(got["R"])[held], want["R"][held], atol=1e-4)
    np.testing.assert_allclose(n(got["t"])[held], want["t"][held], rtol=1e-4, atol=1e-4)
    err = n(tpnp._reproj_err(t(world), t(px), t(K), t(dist), got["R"], got["t"]))
    _assert_masks_equal(n(got["inliers"])[held], want["inliers"][held], err[held])
    found = n(got["num_inliers"]) >= j // 2 + 2  # a majority of inliers: the true pose, in both
    if case in ("clean", "outliers", "behind"):
        assert found.sum() >= 3
        np.testing.assert_allclose(n(got["R"])[found], R_true[found], atol=2e-2)
        np.testing.assert_allclose(n(got["t"])[found], t_true[found], rtol=2e-2, atol=2e-2)
    if case == "behind":  # the points behind the camera reproject within the threshold at the pose found
        assert (err[found][:, :2] < THRESH).all()
    if case == "garbage":  # NaN keypoints end on the identity fallback in both
        np.testing.assert_array_equal(n(got["R"])[1], np.eye(3, dtype=np.float32))


def test_pnp_ransac_draws_from_a_generator():
    """Without ``gumbel`` the noise comes from the caller's generator: the
    same seed gives the same pose, and the pose is the true one."""
    world, R_true, _, px, conf, _ = _scene(40, "outliers", 11)
    run = lambda seed: tpnp.pnp_ransac(t(world), t(px), t(K), t(DIST), t(conf),
                                       generator=torch.Generator().manual_seed(seed), num_hypotheses=256)
    a, b = run(1), run(1)
    np.testing.assert_array_equal(n(a["R"]), n(b["R"]))
    np.testing.assert_allclose(n(a["R"]), R_true, atol=2e-2)
    noise = tpnp.gumbel_noise((20000,), torch.Generator().manual_seed(0))
    assert abs(noise.mean().item() - 0.5772) < 0.03 and abs(noise.var().item() - np.pi**2 / 6) < 0.1


@pytest.fixture(scope="module")
def tiny_hrnet():
    jhr = JHRNet(config=J_HR_TINY.with_joints(11))
    hr_vars = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                               seed=4, overrides={"final_layer": 0.1})
    thr = HRNet(HRNET_TINY.with_joints(11), device="cpu")
    thr.load_state_dict(flax_to_state_dict(hr_vars))
    return jhr, to_jax(hr_vars), thr


def test_ransac_pipeline_matches_jax(tiny_hrnet):
    """make_pose_pipeline(solver="ransac") on HRNET_TINY through both
    packages, with 3-D landmarks that the port's keypoints fit exactly at a
    known pose (random heatmaps fit no 3-D model), 3 of them moved off."""
    jhr, hr_vars, thr = tiny_hrnet
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 120, 192, 3)).astype(np.uint8)
    boxes = np.array([[10, 5, 150, 110], [100, 40, 80, 70], [0, 0, 192, 120]], np.float32)
    k_small = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
    kw = dict(image_size=(64, 64), ransac_hypotheses=H, min_keypoints=6)
    kp = n(tpipe.make_landmark_stage(thr, tpipe.PipelineConfig(**kw))(t(frames), t(boxes))["keypoints"][0])
    z = rng.uniform(8, 12, 11)
    cam = np.stack([(kp[:, 0] - 96.0) / 300.0 * z, (kp[:, 1] - 60.0) / 300.0 * z, z], 1)
    R_true = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
    t_true = np.array([0.3, -0.2, 1.5], np.float32)
    lm3d = ((cam - t_true) @ R_true).astype(np.float32)
    lm3d[[2, 5, 8]] += 0.5  # outliers for RANSAC to reject
    key = jax.random.key(7)
    want = jpipe.make_pose_pipeline(jhr, lm3d, k_small, np.zeros(5, np.float32),
                                    jpipe.PipelineConfig(solver="ransac", warp_dtype="float32", **kw))(
        hr_vars, jnp.asarray(frames), jnp.asarray(boxes), key)
    got = tpipe.make_pose_pipeline(thr, lm3d, k_small, np.zeros(5, np.float32),
                                   tpipe.PipelineConfig(solver="ransac", **kw))(
        t(frames), t(boxes), gumbel=t(jax_gumbel(key, 3, H, 11)))
    np.testing.assert_allclose(n(got["keypoints"]), np.asarray(want["keypoints"]), atol=1e-2)
    for name in ("R", "t", "quat"):
        np.testing.assert_allclose(n(got[name]), np.asarray(want[name]), atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(n(got["R"])[0], R_true, atol=1e-3)
