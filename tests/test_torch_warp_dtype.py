"""The port's float32 crop against the JAX crop at its served ``warp_dtype``.

The JAX ``PipelineConfig`` defaults to ``warp_dtype="bfloat16"`` and
``bench.py`` serves it: both windowed crops (``"xla"`` and ``"pallas"``,
the Pallas kernel in interpret mode) contract bf16 taps with f32 sums, and
so does the full-frame separable crop (``None``: no ``crop_window``) that
the evaluation entry ``tools/evaluate_pipeline.py`` serves. The
port's crop (kernel K1) always samples in float32, the JAX package's exact
mode. These tests hold that deviation to two bars, on the same seeded uint8
frames and boxes: the crops within 1 grey of 0-255, and ``HRNET_TINY``'s
heatmaps on them correlating >= 0.995 (the int8 form's gate on the card).
They print the keypoint and pose deltas the bf16 crop makes
(``pytest -s``): the poses come from one solver, the port's Gauss-Newton
PnP, on each side's keypoints, with 3-D landmarks that the port's
keypoints fit exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu_torch import pipeline as tpipe
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp

from torch_port_util import n, random_variables, t, to_jax

FRAMES_HW = (120, 192)
J = 11
K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
DIST = np.zeros(5, np.float32)
WINDOWS = {"xla": (112, 112), "pallas": (112, 192)}
# xywh: inside, across the right and bottom edges, the whole frame, small
BOXES = np.array([[10, 5, 150, 110], [100, 40, 80, 70], [0, 0, 192, 120], [150, 90, 60, 40]], np.float32)
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)


class RawCrops:
    """A stand-in landmark model that returns its raw-pixel input, so that
    each package's landmark stage hands back its crops as "heatmaps"."""

    consumes_raw_pixels = True

    @staticmethod
    def apply(variables, x, train=False):
        return x

    def __call__(self, x):
        return x


def _config(impl, warp_dtype="bfloat16"):
    """impl None: the full-frame crop (crop_window None), the route the JAX
    evaluation entry serves (pipeline.py:111, the separable crop in bf16)."""
    if impl is None:
        return dict(image_size=(64, 64), solver="none", warp_dtype=warp_dtype)
    return dict(image_size=(64, 64), solver="none", crop_window=WINDOWS[impl], crop_window_impl=impl,
                warp_dtype=warp_dtype)


@pytest.fixture(scope="module")
def setup():
    frames = np.random.default_rng(11).integers(0, 256, (len(BOXES), *FRAMES_HW, 3)).astype(np.uint8)
    jhr = JHRNet(config=J_HR_TINY.with_joints(J))
    hr_vars = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                               seed=4, overrides={"final_layer": 0.1})
    thr = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    thr.load_state_dict(flax_to_state_dict(hr_vars))
    return dict(frames=frames, jhr=jhr, hr_vars=to_jax(hr_vars), thr=thr)


@pytest.mark.parametrize("impl", ["xla", "pallas", None])
def test_served_bf16_crop_within_one_grey(setup, impl):
    frames = jnp.asarray(setup["frames"])
    want = np.asarray(jpipe.make_landmark_stage(RawCrops(), jpipe.PipelineConfig(**_config(impl)))(
        None, frames, jnp.asarray(BOXES))["heatmaps"])
    exact = np.asarray(jpipe.make_landmark_stage(RawCrops(), jpipe.PipelineConfig(**_config(impl, "float32")))(
        None, frames, jnp.asarray(BOXES))["heatmaps"])
    got = n(tpipe.make_landmark_stage(RawCrops(), tpipe.PipelineConfig(**_config(impl)))(
        t(setup["frames"]), t(BOXES))["heatmaps"])
    assert got.shape == want.shape == (len(BOXES), 64, 64, 3)
    err = np.abs(got - want)
    print(f"\n{impl}: port f32 crop vs JAX bf16 crop: max {err.max():.4g} grey, mean {err.mean():.4g}; "
          f"vs JAX f32 crop: max {np.abs(got - exact).max():.4g}")
    assert err.max() <= 1.0
    assert err.max() > 0  # the JAX side did contract in bf16


@pytest.mark.parametrize("impl", ["xla", "pallas", None])
def test_served_bf16_crop_heatmaps_correlate(setup, impl):
    want = jpipe.make_landmark_stage(setup["jhr"], jpipe.PipelineConfig(**_config(impl)))(
        setup["hr_vars"], jnp.asarray(setup["frames"]), jnp.asarray(BOXES))
    got = tpipe.make_landmark_stage(setup["thr"], tpipe.PipelineConfig(**_config(impl)))(
        t(setup["frames"]), t(BOXES))
    hm_j, hm_t = np.asarray(want["heatmaps"], np.float64), n(got["heatmaps"]).astype(np.float64)
    corr = np.corrcoef(hm_j.ravel(), hm_t.ravel())[0, 1]
    kp_j, kp_t = np.asarray(want["keypoints"]), n(got["keypoints"])
    kp_err = np.linalg.norm(kp_j - kp_t, axis=-1)

    # one solver on each side's keypoints; the port's fit lm3d exactly at (R_TRUE, T_TRUE)
    rot_deg, t_rel = [], []
    for i in range(len(BOXES)):
        z = np.random.default_rng(8 + i).uniform(8, 12, J)
        kp = kp_t[i]
        cam = np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0] * z, (kp[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
        lm3d = t(((cam - T_TRUE) @ R_TRUE).astype(np.float32))
        poses = [tpnp.solve_pnp(lm3d, t(kps[i][None]), t(K), t(DIST), torch.ones(1, J), 10)
                 for kps in (kp_j, kp_t)]
        (R_j, t_j), (R_t, t_t) = [(n(R)[0].astype(np.float64), n(tt)[0].astype(np.float64)) for R, tt in poses]
        assert np.isfinite(R_j).all() and np.isfinite(t_j).all()
        d = R_j @ R_t.T  # the angle of the rotation between them, stable near 0
        sin = np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]]) / 2
        rot_deg.append(np.degrees(np.arctan2(sin, (np.trace(d) - 1) / 2)))
        t_rel.append(np.linalg.norm(t_j - t_t) / np.linalg.norm(t_t))
    print(f"\n{impl}: heatmaps correlate {corr:.6f}, max abs diff {np.abs(hm_j - hm_t).max():.4g} of peak "
          f"{np.abs(hm_j).max():.4g}; keypoints max {kp_err.max():.4g} px, mean {kp_err.mean():.4g} px, "
          f"{int((kp_err > 0.5).sum())} of {kp_err.size} over 0.5 px; pose from each side's keypoints: "
          f"rotation max {max(rot_deg):.4g} deg, translation max {max(t_rel):.4g} of |t|")
    assert corr >= 0.995
