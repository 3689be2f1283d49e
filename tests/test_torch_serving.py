"""Port parity of the whole serving path at a tiny size.

The JAX side is the body of ``bench.py``'s ``build_full_path``: letterbox
with ``jax.image.resize``, ``GeneralizedRCNN`` (``RCNN_TINY``, Pallas
pooler in interpret mode), ``select_best_box``, then ``make_pose_pipeline``
with a windowed crop (``warp_dtype="float32"``, both window impls) over
``HRNET_TINY`` and the GN solver. The port's ``PoseServer`` runs the same
numpy-seeded weights and frames on the CPU.

Bounds: boxes 1e-3 px; heatmaps 1e-4 of their peak (the crop moves by
the boxes' rounding); keypoints 1e-2 px (decoded through the same argmax
cells); R, t and q 1e-4. Random weights give keypoints that fit no 3-D
model, and Gauss-Newton on such frames wanders and lands on different
minima from rounding-level differences. So the clip repeats one frame,
and the 3-D landmarks are that frame's keypoints lifted to depth and
moved by a known pose: every frame then has one exact pose, which both
solvers must find.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu_torch import pipeline as tpipe
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp
from spacecraft_pose_estimation_tpu_torch.serving import PoseServer

from torch_port_util import n, random_variables, t, to_jax

FRAMES_HW = (120, 192)
DET_SIZE, DET_EVERY, CLIP = 64, 2, 4
J = 11
K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
DIST = np.zeros(5, np.float32)
WINDOWS = {"xla": (112, 112), "pallas": (112, 192)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    frames = np.repeat(rng.integers(0, 255, (1, *FRAMES_HW, 3)).astype(np.uint8), CLIP, axis=0)
    j_det_cfg = dataclasses.replace(
        jrcnn.RCNN_TINY, roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32))
    jdet = jrcnn.GeneralizedRCNN(config=j_det_cfg)
    det_vars = random_variables(
        lambda: jdet.init({"params": jax.random.key(0)}, jnp.zeros((1, DET_SIZE, DET_SIZE, 3)), train=False),
        seed=3, overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05,
                           "cls_score": 0.05})
    jhr = JHRNet(config=J_HR_TINY.with_joints(J))
    hr_vars = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                               seed=4, overrides={"final_layer": 0.1})
    tdet = trcnn.GeneralizedRCNN(
        dataclasses.replace(trcnn.RCNN_TINY, roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32)),
        device="cpu")
    tdet.load_state_dict(flax_to_state_dict(det_vars))
    thr = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    thr.load_state_dict(flax_to_state_dict(hr_vars))
    return dict(frames=frames, jdet=jdet, jhr=jhr, det_vars=to_jax(det_vars),
                hr_vars=to_jax(hr_vars), tdet=tdet, thr=thr)


def _config(impl):
    return dict(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=WINDOWS[impl],
                crop_window_impl=impl)


R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)


def _exact_landmarks(s, impl):
    """3-D landmarks that the served frame's keypoints fit exactly at
    (R_TRUE, T_TRUE): the port's keypoints lifted to depths 8-12."""
    server = PoseServer(s["tdet"], s["thr"], np.zeros((J, 3), np.float32), K, DIST,
                        tpipe.PipelineConfig(**_config(impl)), det_every=DET_EVERY, det_size=DET_SIZE)
    frames = t(s["frames"])
    kp = n(server.pose(frames, server.detect(frames)[1])["keypoints"][0])
    z = np.random.default_rng(8).uniform(8, 12, J)
    cam = np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0] * z, (kp[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    return ((cam - T_TRUE) @ R_TRUE).astype(np.float32)  # R^T (p_cam - t)


def _jax_serve(s, impl, lm3d):
    """bench.py:383-404 at this size, in float32."""
    pose_run = jpipe.make_pose_pipeline(s["jhr"], lm3d, K, DIST,
                                        jpipe.PipelineConfig(warp_dtype="float32", **_config(impl)))
    h, w = FRAMES_HW
    scale = DET_SIZE / max(h, w)
    lb_h, lb_w = int(round(h * scale)), int(round(w * scale))

    @jax.jit
    def body(det_vars, hr_vars, frames):
        keyframes = frames[::DET_EVERY].astype(jnp.float32)
        lb = jax.image.resize(keyframes, (keyframes.shape[0], lb_h, lb_w, 3), method="bilinear")
        lb = jnp.pad(lb, ((0, 0), (0, DET_SIZE - lb_h), (0, DET_SIZE - lb_w), (0, 0)))
        dets = s["jdet"].apply(det_vars, lb, train=False)
        best = jrcnn.select_best_box(dets, (DET_SIZE, DET_SIZE)) / scale
        xywh = jnp.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], axis=1)
        boxes = jnp.repeat(xywh, DET_EVERY, axis=0)
        return best, boxes, pose_run(hr_vars, frames, boxes)

    return jax.tree_util.tree_map(np.asarray, body(s["det_vars"], s["hr_vars"], jnp.asarray(s["frames"])))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_server_matches_jax_serving_graph(setup, impl):
    lm3d = _exact_landmarks(setup, impl)
    best, boxes, want = _jax_serve(setup, impl, lm3d)
    server = PoseServer(setup["tdet"], setup["thr"], lm3d, K, DIST,
                        tpipe.PipelineConfig(**_config(impl)), det_every=DET_EVERY, det_size=DET_SIZE)
    got = server(t(setup["frames"]))
    np.testing.assert_allclose(n(got["det_boxes"]), best, atol=1e-3)
    np.testing.assert_allclose(n(got["boxes"]), boxes, atol=1e-3)
    np.testing.assert_allclose(n(got["keypoints"]), want["keypoints"], atol=1e-2)
    np.testing.assert_allclose(n(got["confidence"]), want["confidence"], atol=1e-4 * np.abs(want["confidence"]).max())
    for key in ("R", "t", "quat"):
        np.testing.assert_allclose(n(got[key]), want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(n(got["R"]), np.broadcast_to(R_TRUE, (CLIP, 3, 3)), atol=1e-3)
    np.testing.assert_allclose(n(got["t"]), np.broadcast_to(T_TRUE, (CLIP, 3)), atol=1e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_landmark_stage_matches_jax(setup, impl):
    """The landmark half alone, on boxes larger than the window coverage
    (the clamp differs between the two impls) and near the frame edge."""
    boxes = np.array([[10, 5, 150, 110], [100, 40, 80, 70], [0, 0, 192, 120], [150, 90, 60, 40]], np.float32)
    cfg = _config(impl) | {"solver": "none"}
    want = jpipe.make_landmark_stage(setup["jhr"], jpipe.PipelineConfig(warp_dtype="float32", **cfg))(
        setup["hr_vars"], jnp.asarray(setup["frames"]), jnp.asarray(boxes))
    got = tpipe.make_pose_pipeline(setup["thr"], np.zeros((J, 3)), K, DIST, tpipe.PipelineConfig(**cfg))(
        t(setup["frames"]), t(boxes))
    np.testing.assert_allclose(n(got["scales"]), np.asarray(want["scales"]), rtol=1e-6)
    hm = np.asarray(want["heatmaps"])
    np.testing.assert_allclose(n(got["heatmaps"]), hm, atol=1e-4 * np.abs(hm).max())
    np.testing.assert_allclose(n(got["keypoints"]), np.asarray(want["keypoints"]), atol=1e-2)
    assert "R" not in got


def test_ransac_is_not_ported_yet(setup):
    """solver="ransac" is ported now: a server built with it hands its
    generator (or its noise) to the RANSAC solver, which finds the known
    pose; an unknown solver raises."""
    lm3d = _exact_landmarks(setup, "xla")
    config = tpipe.PipelineConfig(**(_config("xla") | {"solver": "ransac", "ransac_hypotheses": 32}))
    server = PoseServer(setup["tdet"], setup["thr"], lm3d, K, DIST, config, det_every=DET_EVERY, det_size=DET_SIZE)
    frames = t(setup["frames"])
    a = server(frames, generator=torch.Generator().manual_seed(3))
    b = server(frames, gumbel=tpnp.gumbel_noise((CLIP, 32, J), torch.Generator().manual_seed(3)))
    np.testing.assert_array_equal(n(a["R"]), n(b["R"]))  # the same draws, from the generator or given
    np.testing.assert_allclose(n(a["R"]), np.broadcast_to(R_TRUE, (CLIP, 3, 3)), atol=1e-3)
    np.testing.assert_allclose(n(a["t"]), np.broadcast_to(T_TRUE, (CLIP, 3)), atol=1e-2)
    with pytest.raises(ValueError, match="solver"):
        tpipe.make_pose_pipeline(setup["thr"], np.zeros((J, 3)), K, DIST, tpipe.PipelineConfig(solver="lm"))
