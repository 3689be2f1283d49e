"""Port parity: the detector (R-CNN tiny preset), stage by stage and whole.

One numpy-seeded Flax variable tree drives the JAX ``GeneralizedRCNN``
(``RCNN_TINY`` with the Pallas pooler, interpret mode on the CPU, as
``tests/test_pallas_pooler.py`` runs it) and, via the weight bridge, the
port on the CPU in float32.

Random weights give near-ties among hundreds of objectness logits, and a
rounding-level difference upstream may reorder them. So each selection
stage is also fed the JAX stage's own inputs: the port's
``find_top_proposals`` gets JAX's RPN outputs and its ROI heads get JAX's
pyramid and proposals, which makes the comparison of what they select
exact. Float tolerances: 1e-4 relative on features, boxes in pixels to
1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.fpn import FPN as JFPN, FPN_STRIDES
from spacecraft_pose_estimation_tpu.models.resnet_backbone import ResNetBackbone as JBackbone
from spacecraft_pose_estimation_tpu.models.roi_heads import (
    StandardROIHeads as JROIHeads,
    fast_rcnn_inference as j_fast_rcnn_inference,
)
from spacecraft_pose_estimation_tpu.models.rpn import RPNHead as JRPNHead, find_top_proposals as j_find_top
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models.roi_heads import fast_rcnn_inference
from spacecraft_pose_estimation_tpu_torch.models.rpn import find_top_proposals

from torch_port_util import n, random_variables, t, to_jax

J_CFG = dataclasses.replace(
    jrcnn.RCNN_TINY,
    roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32),
)
T_CFG = dataclasses.replace(
    trcnn.RCNN_TINY, roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32)
)
HW = (64, 64)


@pytest.fixture(scope="module")
def det():
    jmodel = jrcnn.GeneralizedRCNN(config=J_CFG)
    images = np.random.default_rng(1).uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    variables = random_variables(
        lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(images), train=False), seed=2,
        # a small stem keeps raw 0-255 pixels (std-1 caffe2 normalisation)
        # from saturating every logit downstream
        overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05,
                   "cls_score": 0.05},
    )
    jv = to_jax(variables)
    p = jv["params"]
    x = (jnp.asarray(images) - jnp.asarray(J_CFG.pixel_mean)) / jnp.asarray(J_CFG.pixel_std)

    @jax.jit
    def stages(p, x):
        feats = JBackbone(J_CFG.backbone).apply({"params": p["backbone"]}, x)
        pyramid = JFPN(J_CFG.fpn_channels).apply({"params": p["fpn"]}, feats)
        head = JRPNHead(3).apply({"params": p["rpn_head"]}, pyramid)
        return pyramid, head

    pyramid, head = stages(p, x)
    model = trcnn.GeneralizedRCNN(T_CFG, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return {"jmodel": jmodel, "jv": jv, "images": images, "pyramid": pyramid, "head": head, "model": model}


def _anchors(model, pyramid):
    return model.anchors({k: (v.shape[1], v.shape[2]) for k, v in pyramid.items()}, torch.device("cpu"))


def test_pyramid_and_rpn_head(det):
    model = det["model"]
    with torch.no_grad():
        pyramid = model.pyramid(t(det["images"]))
        head = model.rpn_head(pyramid)
    for lvl, want in det["pyramid"].items():
        want = np.asarray(want)
        got = n(pyramid[lvl].permute(0, 2, 3, 1))
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
        for g, w in zip(head[lvl], det["head"][lvl]):
            np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4 * np.abs(np.asarray(w)).max())


def _jax_proposals(det, post_k=None):
    anchors = jrcnn.fpn_anchors({k: v.shape[1:3] for k, v in det["pyramid"].items()}, FPN_STRIDES,
                                {f"p{i + 2}": s for i, s in enumerate(J_CFG.anchor_sizes)},
                                J_CFG.anchor_aspect_ratios)
    cfg = J_CFG.rpn if post_k is None else dataclasses.replace(J_CFG.rpn, post_nms_topk_test=post_k)
    return jax.jit(jax.vmap(lambda ho: j_find_top(ho, anchors, HW, cfg, False)))(det["head"])


@pytest.mark.parametrize("post_k", [None, 400], ids=["preset", "all_candidates"])
def test_find_top_proposals_from_jax_rpn_outputs(det, post_k):
    """With post_k above the 191 candidates, the NMS-suppressed -inf slots
    come out too, in lax.top_k's tie order."""
    wb, ws, wv = _jax_proposals(det, post_k)
    head = {k: (t(a), t(b)) for k, (a, b) in det["head"].items()}
    cfg = T_CFG.rpn if post_k is None else dataclasses.replace(T_CFG.rpn, post_nms_topk_test=post_k)
    tb, ts, tv = find_top_proposals(head, _anchors(det["model"], det["pyramid"]), HW, cfg)
    np.testing.assert_array_equal(n(tv), np.asarray(wv))
    np.testing.assert_array_equal(n(ts), np.asarray(ws))
    np.testing.assert_allclose(n(tb), np.asarray(wb), atol=1e-3)
    if post_k:
        assert tv.shape == (2, 191) and 10 < n(tv).sum() < 2 * 191  # NMS dropped some, kept many


def test_roi_heads_and_inference_from_jax_proposals(det):
    wb, _, wv = _jax_proposals(det)
    p = det["jv"]["params"]
    wscores, wdeltas = jax.jit(lambda p, pyr, b: JROIHeads(J_CFG.roi).apply({"params": p}, pyr, b, FPN_STRIDES))(
        p["roi_heads"], det["pyramid"], wb)
    pyramid = {k: t(v) for k, v in det["pyramid"].items()}
    with torch.no_grad():
        tscores, tdeltas = det["model"].roi_heads(pyramid, t(wb), FPN_STRIDES)
    np.testing.assert_allclose(n(tscores), np.asarray(wscores), atol=1e-4 * np.abs(np.asarray(wscores)).max())
    np.testing.assert_allclose(n(tdeltas), np.asarray(wdeltas), atol=1e-4 * np.abs(np.asarray(wdeltas)).max())

    want = jax.jit(jax.vmap(lambda s, d, b, v: j_fast_rcnn_inference(s, d, b, v, HW, J_CFG.roi)))(
        wscores, wdeltas, wb, wv)
    got = fast_rcnn_inference(t(wscores), t(wdeltas), t(wb), t(wv), HW, T_CFG.roi)
    np.testing.assert_array_equal(n(got["valid"]), np.asarray(want["valid"]))
    np.testing.assert_array_equal(n(got["classes"]), np.asarray(want["classes"]))
    np.testing.assert_array_equal(n(got["scores"]), np.asarray(want["scores"]))
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3)
    assert n(got["valid"]).all()


def test_end_to_end_detections(det):
    want = jax.jit(lambda v, x: det["jmodel"].apply(v, x, train=False))(det["jv"], jnp.asarray(det["images"]))
    with torch.no_grad():
        got = det["model"](t(det["images"]))
    np.testing.assert_array_equal(n(got["valid"]), np.asarray(want["valid"]))
    np.testing.assert_allclose(n(got["scores"]), np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3)
    best = trcnn.select_best_box(got, HW)
    np.testing.assert_allclose(n(best), np.asarray(jrcnn.select_best_box(want, HW)), atol=1e-3)


def test_select_best_box_full_frame_fallback():
    dets = {
        "boxes": torch.tensor([[[1.0, 2, 3, 4], [5, 6, 7, 8]], [[1, 1, 2, 2], [3, 3, 9, 9]]]),
        "scores": torch.tensor([[0.2, 0.9], [0.5, 0.7]]),
        "valid": torch.tensor([[False, False], [True, False]]),
    }
    want = jrcnn.select_best_box({k: jnp.asarray(n(v)) for k, v in dets.items()}, (48, 64))
    got = trcnn.select_best_box(dets, (48, 64))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(got), [[0, 0, 64, 48], [1, 1, 2, 2]])


def test_fast_rcnn_inference_per_class_boxes():
    """Per-class box regression and class-aware NMS (three classes), which
    the single-class presets do not reach."""
    from spacecraft_pose_estimation_tpu.models.roi_heads import ROIHeadsConfig as JROICfg
    from spacecraft_pose_estimation_tpu_torch.models.roi_heads import ROIHeadsConfig as TROICfg

    rng = np.random.default_rng(5)
    b, r, c = 2, 24, 3
    xy = rng.uniform(0, 40, (b, r, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 30, (b, r, 2))], -1).astype(np.float32)
    scores = rng.normal(0, 2, (b, r, c + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (b, r, 4 * c)).astype(np.float32)
    valid = rng.uniform(size=(b, r)) > 0.2
    kw = dict(num_classes=c, cls_agnostic_bbox_reg=False, detections_per_image=10, score_thresh=0.1)
    want = jax.vmap(lambda s, d, p, v: j_fast_rcnn_inference(s, d, p, v, HW, JROICfg(**kw)))(
        scores, deltas, props, valid)
    got = fast_rcnn_inference(t(scores), t(deltas), t(props), t(valid), HW, TROICfg(**kw))
    for key in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(n(got[key]), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3)
    assert len(set(n(got["classes"])[n(got["valid"])].tolist())) > 1
