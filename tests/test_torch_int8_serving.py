"""Port parity of the int8 serving form at a tiny size.

The JAX side is ``bench.py``'s ``build_full_path`` with its default
``det_kind="r101_1obj_int8"`` (``bench.py:322-404``): the int8 backbone
(``quantize_backbone``, ``backbone_int8_apply``) feeding
``GeneralizedRCNN(precomputed_feats=...)`` (``RCNN_TINY``, Pallas pooler in
interpret mode), ``select_best_box``, then ``make_pose_pipeline`` over
``HRNetInt8(fold_normalize=True)`` (``HRNET_TINY``) with a windowed crop and
the GN solver. Both sides run the same quantized trees, made by the
port's quantizers with ``bench.py``'s calibration (the quantizers are held
to JAX in ``test_torch_hrnet_int8.py`` and ``test_torch_backbone_int8.py``),
on the same frames; the port's ``build_int8_server`` runs on the CPU,
per-op and with every fused kernel route on.

Bounds, as ``test_torch_serving.py`` (boxes 1e-3 px, keypoints 1e-2 px,
R, t, q 1e-4) and on the same scene with one exact pose (one frame
repeated, landmarks lifted from its keypoints). The int8 sites are
bit-equal; the bf16 stem convs and the float detector sum in another
order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models import backbone_int8 as jbi, hrnet_int8 as jhi, rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu_torch import pipeline as tpipe
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models.backbone_int8 import quantize_backbone
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.models.hrnet_int8 import quantize_hrnet
from spacecraft_pose_estimation_tpu_torch.serving import build_int8_server

from torch_port_util import n, random_variables, t, to_jax

FRAMES_HW = (120, 192)
DET_SIZE, DET_EVERY, CLIP = 64, 2, 4
J = 11
K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
DIST = np.zeros(5, np.float32)
CONFIG = dict(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=(112, 112))
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)
FUSED = dict(fused_blocks=True, layer1_strips=True, fuse_exchange=True)


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
    # bench.py's calibration: letterboxed pixels for the backbone, crops for the HRNet
    calib_det = torch.from_numpy(rng.integers(0, 255, (2, DET_SIZE, DET_SIZE, 3)).astype(np.float32))
    qb = quantize_backbone(tdet.config.backbone, tdet, tdet.normalize(calib_det))
    calib = torch.from_numpy(rng.integers(0, 255, (4, 64, 64, 3)).astype(np.float32))
    qh = quantize_hrnet(thr, tpipe.normalize_crops(calib))
    s = dict(frames=frames, j_det_cfg=j_det_cfg, jdet=jdet, jhr=jhr, det_vars=to_jax(det_vars), qb=_to_jax(qb),
             qh=_to_jax(qh), qb_t=qb, qh_t=qh, tdet=tdet, thr=thr)
    s["lm3d"] = _exact_landmarks(s)
    s["want"] = _jax_serve(s, s["lm3d"])
    return s


def _to_jax(tree):
    """A port quantized tree as the JAX package holds it."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, float):
        return tree
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(n(tree.float()), jnp.bfloat16)
    return jnp.asarray(n(tree))


def _server(s, lm3d, **flags):
    return build_int8_server(s["tdet"], s["thr"], lm3d, K, DIST, tpipe.PipelineConfig(**CONFIG),
                             det_every=DET_EVERY, det_size=DET_SIZE, backbone_q=s["qb_t"], hrnet_q=s["qh_t"],
                             **flags)


def _exact_landmarks(s):
    """3-D landmarks that the served frame's keypoints fit exactly at
    (R_TRUE, T_TRUE): the port's keypoints lifted to depths 8-12."""
    server = _server(s, np.zeros((J, 3), np.float32))
    frames = t(s["frames"])
    kp = n(server.pose(frames, server.detect(frames)[1])["keypoints"][0])
    z = np.random.default_rng(8).uniform(8, 12, J)
    cam = np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0] * z, (kp[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    return ((cam - T_TRUE) @ R_TRUE).astype(np.float32)  # R^T (p_cam - t)


def _jax_serve(s, lm3d):
    """bench.py:322-404 at this size (int8 backbone, HRNetInt8 on raw crops)."""
    cfg = s["j_det_cfg"]
    mean, std = jnp.asarray(cfg.pixel_mean), jnp.asarray(cfg.pixel_std)
    pose_run = jpipe.make_pose_pipeline(jhi.HRNetInt8(s["jhr"].config, fold_normalize=True), lm3d, K, DIST,
                                        jpipe.PipelineConfig(warp_dtype="float32", **CONFIG))
    h, w = FRAMES_HW
    scale = DET_SIZE / max(h, w)
    lb_h, lb_w = int(round(h * scale)), int(round(w * scale))
    frames = jnp.asarray(s["frames"])
    keyframes = frames[::DET_EVERY].astype(jnp.float32)
    lb = jax.image.resize(keyframes, (keyframes.shape[0], lb_h, lb_w, 3), method="bilinear")
    lb = jnp.pad(lb, ((0, 0), (0, DET_SIZE - lb_h), (0, DET_SIZE - lb_w), (0, 0)))
    # eager, as the port rounds its bf16 stem convs (jit rounds them elsewhere)
    feats = jbi.backbone_int8_apply(cfg.backbone, s["qb"], (lb - mean) / std)
    dets = jax.jit(lambda v, lb, f: s["jdet"].apply(v, lb, train=False, precomputed_feats=f))(s["det_vars"], lb, feats)
    best = jrcnn.select_best_box(dets, (DET_SIZE, DET_SIZE)) / scale
    xywh = jnp.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], axis=1)
    boxes = jnp.repeat(xywh, DET_EVERY, axis=0)
    return jax.tree_util.tree_map(np.asarray, (best, boxes, pose_run(s["qh"], frames, boxes)))


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["per_op", "fused"])
def test_int8_server_matches_jax_serving_graph(setup, flags):
    best, boxes, want = setup["want"]
    got = _server(setup, setup["lm3d"], **flags)(t(setup["frames"]))
    np.testing.assert_allclose(n(got["det_boxes"]), best, atol=1e-3)
    np.testing.assert_allclose(n(got["boxes"]), boxes, atol=1e-3)
    np.testing.assert_allclose(n(got["keypoints"]), want["keypoints"], atol=1e-2)
    np.testing.assert_allclose(n(got["confidence"]), want["confidence"], atol=1e-4 * np.abs(want["confidence"]).max())
    for key in ("R", "t", "quat"):
        np.testing.assert_allclose(n(got[key]), want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(n(got["R"]), np.broadcast_to(R_TRUE, (CLIP, 3, 3)), atol=1e-3)
    np.testing.assert_allclose(n(got["t"]), np.broadcast_to(T_TRUE, (CLIP, 3)), atol=1e-2)


def test_int8_server_calibrates_its_own_trees(setup):
    """Without trees, build_int8_server quantizes both models as bench.py does."""
    server = build_int8_server(setup["tdet"], setup["thr"], np.zeros((J, 3), np.float32), K, DIST,
                               tpipe.PipelineConfig(**CONFIG), det_every=DET_EVERY, det_size=DET_SIZE, **FUSED)
    assert server.pose is not None and server.backbone_q["convs"]
    out = server(t(setup["frames"]))
    assert out["keypoints"].shape == (CLIP, J, 2) and torch.isfinite(out["keypoints"]).all()
    assert out["det_boxes"].shape == (CLIP // DET_EVERY, 4) and torch.isfinite(out["det_boxes"]).all()
