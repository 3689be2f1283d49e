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

The int8 X101 form (``det_kind="x101_int8"``: ``FASTER_RCNN_X101_SERVING``'s
grouped trunk with the stride in its 3x3s) runs the same composition on
``RCNN_TINY`` with the JAX tests' ``TINY_X`` trunk and X101's pixel std.
``BENCH_FOLD=2`` (``bench.py:339-364``: the backbone's ``fold_residual``, the
HRNet's ``fold_residual`` and ``fold_fuse_up``) is ``build_int8_server(fold=2)``
against the JAX graph built the same way.

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

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

FRAMES_HW = (120, 192)
DET_SIZE, DET_EVERY, CLIP = 64, 2, 4
J = 11
K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
DIST = np.zeros(5, np.float32)
CONFIG = dict(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=(112, 112))
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)
FUSED = dict(fused_blocks=True, layer1_strips=True, fuse_exchange=True)


TINY_X = dict(groups=4, width_per_group=4, stride_in_1x1=False)


@pytest.fixture(scope="module")
def setup():
    return _make_setup({}, {})


@pytest.fixture(scope="module")
def setup_x():
    from spacecraft_pose_estimation_tpu_torch.models.resnet_backbone import RESNET_TINY

    jx = dict(backbone=dataclasses.replace(jrcnn.RCNN_TINY.backbone, **TINY_X), pixel_std=jrcnn.X101_PIXEL_STD)
    tx = dict(backbone=dataclasses.replace(RESNET_TINY, **TINY_X), pixel_std=trcnn.X101_PIXEL_STD)
    return _make_setup(jx, tx)


def _make_setup(j_fields, t_fields):
    """Both sides' models, trees and served outputs, the detectors' configs
    RCNN_TINY with ``j_fields`` / ``t_fields`` replaced."""
    rng = np.random.default_rng(7)
    frames = np.repeat(rng.integers(0, 255, (1, *FRAMES_HW, 3)).astype(np.uint8), CLIP, axis=0)
    j_det_cfg = dataclasses.replace(
        jrcnn.RCNN_TINY, roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32),
        **j_fields)
    jdet = jrcnn.GeneralizedRCNN(config=j_det_cfg)
    det_vars = random_variables(
        lambda: jdet.init({"params": jax.random.key(0)}, jnp.zeros((1, DET_SIZE, DET_SIZE, 3)), train=False),
        seed=3, overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05,
                           "cls_score": 0.05})
    jhr = JHRNet(config=J_HR_TINY.with_joints(J))
    hr_vars = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                               seed=4, overrides={"final_layer": 0.1})
    tdet = trcnn.GeneralizedRCNN(
        dataclasses.replace(trcnn.RCNN_TINY, roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32),
                            **t_fields),
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


def _exact_landmarks(s, **flags):
    """3-D landmarks that the served frame's keypoints fit exactly at
    (R_TRUE, T_TRUE): the port's keypoints (served with ``flags``) lifted to
    depths 8-12."""
    server = _server(s, np.zeros((J, 3), np.float32), **flags)
    frames = t(s["frames"])
    kp = n(server.pose(frames, server.detect(frames)[1])["keypoints"][0])
    z = np.random.default_rng(8).uniform(8, 12, J)
    cam = np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0] * z, (kp[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    return ((cam - T_TRUE) @ R_TRUE).astype(np.float32)  # R^T (p_cam - t)


def _jax_serve(s, lm3d, fold=0):
    """bench.py:322-404 at this size (int8 backbone, HRNetInt8 on raw crops), ``BENCH_FOLD=fold``."""
    cfg = s["j_det_cfg"]
    mean, std = jnp.asarray(cfg.pixel_mean), jnp.asarray(cfg.pixel_std)
    lm = jhi.HRNetInt8(s["jhr"].config, fold_residual=fold >= 1, fold_fuse_up=fold >= 2, fold_normalize=True)
    pose_run = jpipe.make_pose_pipeline(lm, lm3d, K, DIST, jpipe.PipelineConfig(warp_dtype="float32", **CONFIG))
    h, w = FRAMES_HW
    scale = DET_SIZE / max(h, w)
    lb_h, lb_w = int(round(h * scale)), int(round(w * scale))
    frames = jnp.asarray(s["frames"])
    keyframes = frames[::DET_EVERY].astype(jnp.float32)
    lb = jax.image.resize(keyframes, (keyframes.shape[0], lb_h, lb_w, 3), method="bilinear")
    lb = jnp.pad(lb, ((0, 0), (0, DET_SIZE - lb_h), (0, DET_SIZE - lb_w), (0, 0)))
    # eager, as the port rounds its bf16 stem convs (jit rounds them elsewhere)
    feats = jbi.backbone_int8_apply(cfg.backbone, s["qb"], (lb - mean) / std, fold_residual=fold >= 1)
    dets = jax.jit(lambda v, lb, f: s["jdet"].apply(v, lb, train=False, precomputed_feats=f))(s["det_vars"], lb, feats)
    best = jrcnn.select_best_box(dets, (DET_SIZE, DET_SIZE)) / scale
    xywh = jnp.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], axis=1)
    boxes = jnp.repeat(xywh, DET_EVERY, axis=0)
    return jax.tree_util.tree_map(np.asarray, (best, boxes, pose_run(s["qh"], frames, boxes)))


@pytest.mark.parametrize("flags", [{}, FUSED, {"fold": 2}], ids=["per_op", "fused", "fold2"])
def test_int8_server_matches_jax_serving_graph(setup, flags):
    fold = flags.get("fold", 0)
    if fold and f"want_fold{fold}" not in setup:  # the scene's exact pose, on the folded form's keypoints
        setup[f"lm3d_fold{fold}"] = _exact_landmarks(setup, fold=fold)
        setup[f"want_fold{fold}"] = _jax_serve(setup, setup[f"lm3d_fold{fold}"], fold)
    lm3d = setup[f"lm3d_fold{fold}" if fold else "lm3d"]
    best, boxes, want = setup[f"want_fold{fold}" if fold else "want"]
    got = _server(setup, lm3d, **flags)(t(setup["frames"]))
    np.testing.assert_allclose(n(got["det_boxes"]), best, atol=1e-3)
    np.testing.assert_allclose(n(got["boxes"]), boxes, atol=1e-3)
    np.testing.assert_allclose(n(got["keypoints"]), want["keypoints"], atol=1e-2)
    np.testing.assert_allclose(n(got["confidence"]), want["confidence"], atol=1e-4 * np.abs(want["confidence"]).max())
    for key in ("R", "t", "quat"):
        np.testing.assert_allclose(n(got[key]), want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(n(got["R"]), np.broadcast_to(R_TRUE, (CLIP, 3, 3)), atol=1e-3)
    np.testing.assert_allclose(n(got["t"]), np.broadcast_to(T_TRUE, (CLIP, 3)), atol=1e-2)


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["per_op", "fused"])
def test_x101_int8_server_matches_jax_serving_graph(setup_x, flags):
    """``bench.py``'s ``det_kind="x101_int8"`` at this size: the grouped int8
    trunk (stride in the 3x3s) under the same detector heads and int8 HRNet."""
    assert setup_x["tdet"].config.backbone.groups == 4 and not setup_x["tdet"].config.backbone.stride_in_1x1
    test_int8_server_matches_jax_serving_graph(setup_x, flags)


def test_int8_server_calibrates_its_own_trees(setup):
    """Without trees, build_int8_server quantizes both models as bench.py does."""
    server = build_int8_server(setup["tdet"], setup["thr"], np.zeros((J, 3), np.float32), K, DIST,
                               tpipe.PipelineConfig(**CONFIG), det_every=DET_EVERY, det_size=DET_SIZE, **FUSED)
    assert server.pose is not None and server.backbone_q["convs"]
    out = server(t(setup["frames"]))
    assert out["keypoints"].shape == (CLIP, J, 2) and torch.isfinite(out["keypoints"]).all()
    assert out["det_boxes"].shape == (CLIP // DET_EVERY, 4) and torch.isfinite(out["det_boxes"]).all()


def test_int8_server_calibrates_s2d_trees(setup):
    """Asked for s2d, build_int8_server quantizes the HRNet with its
    space-to-depth twins; with fused_even3 its branch 0 runs K5 packed, and
    the served poses equal the per-op server's bit for bit."""
    flags = dict(s2d=True, fused_blocks=True, fused_even3=True)
    server = build_int8_server(setup["tdet"], setup["thr"], np.zeros((J, 3), np.float32), K, DIST,
                               tpipe.PipelineConfig(**CONFIG), det_every=DET_EVERY, det_size=DET_SIZE, **flags)
    assert server.landmarks.s2d and server.landmarks.q["convs_s2d"] and server.landmarks.q["final_s2d"]
    walk = build_int8_server(setup["tdet"], setup["thr"], np.zeros((J, 3), np.float32), K, DIST,
                             tpipe.PipelineConfig(**CONFIG), det_every=DET_EVERY, det_size=DET_SIZE, s2d=False)
    frames = t(setup["frames"])
    got, want = server(frames), walk(frames)
    for key in ("keypoints", "confidence", "R", "t"):
        assert torch.equal(got[key], want[key]), key
