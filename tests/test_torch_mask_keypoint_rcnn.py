"""Port parity of Mask and Keypoint R-CNN: the heads, their losses and
decoding, the detector's two new branches, the mask ops and the segm AP,
on the CPU against the JAX package.

* ``MaskHead`` and ``KeypointHead`` (one conv of 8 channels, 2 classes / 4
  keypoints) forward on weights carried by ``convert.flax_to_state_dict``,
  within 1e-5 of their scale, and ``module_to_flax`` giving JAX's tree back
  bit for bit: the keypoint head's transposed conv is ``score_lowres``,
  which the bridge must flip as it flips a ``deconv``.
* ``mask_loss``, ``keypoint_loss`` and ``keypoints_from_logits`` on logits
  with tied maxima (the first maximum wins in both).
* ``RCNN_TINY`` with both heads (``num_keypoints=4``, ``mask_resolution=7``,
  as the JAX package's own test builds it) at 64x64, batch 2, float32, one
  numpy-seeded tree: inference (boxes, scores, valid, ``mask_logits`` (2, 2,
  14, 14, 1), ``keypoint_logits`` (2, 2, 28, 28, 4)); the training losses on
  JAX's own sampling draws, ``loss_mask`` and ``loss_keypoint`` included,
  with a GT box given twice (its ROIs take the first copy's mask and
  keypoints, the L1-nearest of two at distance 0) and a padded GT, within
  1e-4 relative; the gradient of ``loss_total``: its global norm within
  1e-4 relative and every head parameter's within 1e-4 of its scale. A
  bridge round trip of the whole model is bit-equal.
* ``polygon_to_bitmask`` and ``paste_masks_in_image`` equal to JAX's;
  ``mask_iou`` and ``evaluate_instance_segmentation`` equal on seeded masks.
* The chain of the JAX package's ``TestHeadsAreEvaluable``: inference ->
  pasted masks -> keypoints -> segm AP and keypoint AP, the port's chain on
  its outputs against JAX's on its own: the same pasted pixels but at most
  1e-3 of them, keypoints within 1e-3 px, the APs within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from spacecraft_pose_estimation_tpu.data import coco_eval as jce
from spacecraft_pose_estimation_tpu.models import cascade as jcascade
from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.ops import masks as jmasks
from spacecraft_pose_estimation_tpu_torch import convert
from spacecraft_pose_estimation_tpu_torch.data import coco_eval as tce
from spacecraft_pose_estimation_tpu_torch.models import cascade as tcascade
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.ops import masks as tmasks
from spacecraft_pose_estimation_tpu_torch.train.optim import global_norm

from torch_port_util import few_threads, jax_detection_draws, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HW, B, G, K = (64, 64), 2, 3, 4
HEADS = dict(with_mask=True, with_keypoints=True, num_keypoints=K, mask_resolution=7)
OVERRIDES = {"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05, "cls_score": 0.05}


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


# ------------------------------------------------------------------ the heads alone


@pytest.mark.parametrize("which", ["mask", "keypoint"])
def test_head_forward_and_bridge_match_jax(which):
    pooled = np.random.default_rng(1).normal(size=(3, 14, 14, 8)).astype(np.float32)
    if which == "mask":
        jm, tm = jcascade.MaskHead(num_classes=2, conv_dim=8, num_convs=1), tcascade.MaskHead(8, 2, 8, 1)
        shape = (3, 28, 28, 2)
    else:
        jm, tm = jcascade.KeypointHead(num_keypoints=K, conv_dim=8, num_convs=1), tcascade.KeypointHead(8, K, 8, 1)
        shape = (3, 56, 56, K)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(pooled)), 5)
    tm.load_state_dict(convert.flax_to_state_dict(variables))
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(pooled)))
    with torch.no_grad():
        got = n(tm(t(pooled)))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    back = flat(convert.module_to_flax(tm)["params"])
    assert set(back) == set(flat(variables["params"]))
    for k, v in flat(variables["params"]).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def tied_logits():
    """(3, 6, 6, 2) logits with tied maxima in some (ROI, keypoint) maps."""
    rng = np.random.default_rng(2)
    x = np.round(rng.normal(size=(3, 6, 6, 2)), 1).astype(np.float32)
    x[0, 1, 4, 0] = x[0, 3, 2, 0] = x[0, 5, 5, 0] = 9.0  # three-way tie: (1, 4) first
    x[2, 0, 0, 1] = x[2, 0, 1, 1] = 7.0
    return x


def test_head_losses_and_decoding_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 14, 14, 3)).astype(np.float32)
    gt = rng.uniform(size=(4, 14, 14)) > 0.5
    cls = np.array([0, 2, 5, 1], np.int32)  # 5: clipped to the last channel
    fg = np.array([1, 1, 0, 1], np.float32)
    want = float(jcascade.mask_loss(jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(fg)))
    got = float(tcascade.mask_loss(t(logits), t(gt), t(cls), t(fg)))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert float(tcascade.mask_loss(t(logits), t(gt), t(cls), torch.zeros(4))) == 0.0
    kp = tied_logits()
    idx = rng.integers(0, 36, (3, 2)).astype(np.int32)
    valid = np.array([[1, 0], [1, 1], [0, 1]], np.float32)
    kfg = np.array([1, 1, 0], np.float32)
    want = float(jcascade.keypoint_loss(jnp.asarray(kp), jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(kfg)))
    got = float(tcascade.keypoint_loss(t(kp), t(idx), t(valid), t(kfg)))
    assert abs(got - want) <= 1e-6 * abs(want)
    # batched over a leading image axis: one loss an image
    two = tcascade.keypoint_loss(t(np.stack([kp, kp[::-1]])), t(np.stack([idx, idx[::-1]])),
                                 t(np.stack([valid, valid[::-1]])), t(np.stack([kfg, kfg[::-1]])))
    assert two.shape == (2,) and abs(float(two[0]) - want) <= 1e-6 * abs(want)
    boxes = np.array([[10.0, 20.0, 40.0, 30.0], [0.0, 0.0, 6.0, 6.0], [5.0, 5.0, 5.0, 9.0]], np.float32)
    want = np.asarray(jcascade.keypoints_from_logits(jnp.asarray(kp), jnp.asarray(boxes)))
    got = n(tcascade.keypoints_from_logits(t(kp), t(boxes)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    # the three-way tie decodes to its first cell, (row 1, column 4) of box 0
    assert got[0, 0, 0] == pytest.approx(10.0 + 4.5 * 30.0 / 6) and got[0, 0, 1] == pytest.approx(20.0 + 1.5 * 10 / 6)


# --------------------------------------------------------- the detector with both heads


def images():
    return np.random.default_rng(7).uniform(0, 255, (B, *HW, 3)).astype(np.float32)


def gt_batch():
    """Image 0: two boxes and the first again (its ROIs match the first copy
    at L1 distance 0: argmin's first index), each with its own mask and
    keypoints; image 1: two boxes and a padded one."""
    rng = np.random.default_rng(0)
    boxes = np.array([[[8, 8, 40, 40], [30, 30, 60, 60], [8, 8, 40, 40]],
                      [[4, 10, 50, 44], [20, 2, 36, 22], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, True], [True, True, False]])
    masks = np.zeros((B, G, *HW), bool)
    for b in range(B):
        for g in range(G):
            if valid[b, g]:
                poly = np.array([[boxes[b, g, 0], boxes[b, g, 3]], [(boxes[b, g, 0] + boxes[b, g, 2]) / 2,
                                 boxes[b, g, 1]], [boxes[b, g, 2], boxes[b, g, 3] - 3 * g]], np.float32)
                masks[b, g] = np.asarray(jmasks.polygon_to_bitmask(jnp.asarray(poly), *HW))
    kps = np.zeros((B, G, K, 3), np.float32)
    for b in range(B):
        for g in range(G):
            x0, y0, x1, y1 = boxes[b, g]
            kps[b, g, :, 0] = rng.uniform(x0 - 4, x1 + 2, K)  # some outside their box
            kps[b, g, :, 1] = rng.uniform(y0, y1, K)
            kps[b, g, :, 2] = [2, 2, 1, 0]  # the last one not labelled
    return {"gt_boxes": boxes, "gt_classes": np.zeros((B, G), np.int32), "gt_valid": valid, "gt_masks": masks,
            "gt_keypoints": kps}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jrcnn.RCNN_TINY, **HEADS)
    jmodel = jrcnn.GeneralizedRCNN(config=jcfg)
    x = jnp.asarray(images())
    variables = random_variables(lambda: jmodel.init({"params": jax.random.key(0)}, x, train=False), 2, OVERRIDES)
    model = trcnn.GeneralizedRCNN(dataclasses.replace(trcnn.RCNN_TINY, **HEADS), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def inference(models):
    jmodel, variables, model = models
    x = images()
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x))
    return {k: np.asarray(v) for k, v in want.items()}, {k: n(v) for k, v in got.items()}


def test_bridge_round_trip_of_the_model_is_bit_equal(models):
    _, variables, model = models
    back = flat(convert.module_to_flax(model)["params"])
    want = flat(variables["params"])
    assert set(back) == set(want) and any("score_lowres" in k for k in want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_inference_matches_jax(inference):
    want, got = inference
    assert set(got) == set(want)
    assert got["mask_logits"].shape == (B, 2, 14, 14, 1) and got["keypoint_logits"].shape == (B, 2, 28, 28, K)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)
    for k in ("mask_logits", "keypoint_logits"):  # every detection's, the invalid ones' too
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * np.abs(want[k]).max(), rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def training(models):
    jmodel, variables, model = models
    x, g = images(), gt_batch()
    key = jax.random.key(11)
    n_anchors = sum(s * s * 3 for s in (16, 8, 4, 2, 1))
    draws = jax_detection_draws(jmodel, variables, key, B, n_anchors, 32 + G)

    def loss_fn(params, im, gb, gc, gv, gm, gk):
        losses = jmodel.apply({"params": params}, im, gt_boxes=gb, gt_classes=gc, gt_valid=gv, gt_masks=gm,
                              gt_keypoints=gk, train=True, rngs={"sampling": key})
        return losses["loss_total"], losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(variables["params"]), jnp.asarray(x), *(jnp.asarray(g[k]) for k in
                                                       ("gt_boxes", "gt_classes", "gt_valid", "gt_masks",
                                                        "gt_keypoints")))
    model.zero_grad()
    got = model.losses(t(x), t(g["gt_boxes"]), t(g["gt_classes"]), t(g["gt_valid"]),
                       draws={k: t(v) for k, v in draws.items()}, gt_masks=t(g["gt_masks"]),
                       gt_keypoints=t(g["gt_keypoints"]))
    got["loss_total"].backward()
    return ({k: float(v) for k, v in want.items()}, {k: float(v) for k, v in got.items()},
            convert.flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)}),
            {name: p.grad for name, p in model.named_parameters()}, float(optax.global_norm(grads)))


def test_training_losses_match_jax(training):
    want, got, *_ = training
    assert set(got) == set(want) and {"loss_mask", "loss_keypoint"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)
    assert got["loss_mask"] > 0 and got["loss_keypoint"] > 0


def test_training_gradient_matches_jax(training):
    _, _, want, got, want_norm = training
    grads = [torch.zeros_like(want[k]) if g is None else g for k, g in got.items()]
    norm = float(global_norm(grads))
    assert abs(norm - want_norm) <= 1e-4 * want_norm, (norm, want_norm)
    heads = [k for k in want if k.startswith(("mask_head.", "keypoint_head."))]
    assert len(heads) == 2 * (4 + 1 + 1) + 2 * (8 + 1)
    for k in heads:
        # score_lowres.bias shifts a keypoint's whole heatmap, which its softmax ignores: its gradient is
        # rounding noise in both (~1e-8), held to 1e-9 of the norm
        w = want[k]
        atol = 1e-4 * max(float(w.abs().max()), 1e-5 * want_norm)
        np.testing.assert_allclose(n(got[k]), n(w), atol=atol, rtol=0, err_msg=k)


def test_keypoint_targets_truncate_toward_zero_then_clip():
    rois = torch.tensor([[10.0, 10.0, 20.0, 30.0]])
    kps = torch.tensor([[[10.4, 29.99, 2.0], [9.9, 10.0, 2.0], [25.0, 15.0, 2.0], [12.0, 12.0, 0.0]]])
    idx, valid = trcnn.keypoint_targets(kps, rois, 28)
    # x 0.4 * 2.8 = 1.12 -> 1, y 19.99 * 1.4 = 27.99 -> 27; x -0.28 -> 0 (truncated, not floored to -1); 42 -> 27
    assert idx.tolist() == [[27 * 28 + 1, 0 * 28 + 0, 7 * 28 + 27, 2 * 28 + 5]]
    assert valid.tolist() == [[1.0, 0.0, 0.0, 0.0]]


# ------------------------------------------------------------------ masks and segm AP


def test_polygon_and_paste_match_jax():
    rng = np.random.default_rng(4)
    poly = np.array([[3.0, 4.0], [40.5, 2.0], [30.0, 33.0], [20.0, 18.0], [5.0, 30.0]], np.float32)
    want = np.asarray(jmasks.polygon_to_bitmask(jnp.asarray(poly), 36, 48))
    got = n(tmasks.polygon_to_bitmask(t(poly), 36, 48))
    np.testing.assert_array_equal(got, want)
    assert 100 < got.sum() < 36 * 48
    masks = rng.uniform(size=(4, 14, 14)).astype(np.float32)
    boxes = np.array([[3.2, 4.7, 30.1, 20.9], [-5.0, 10.0, 20.0, 40.0], [10.0, 10.0, 10.5, 11.0],
                      [0.0, 0.0, 48.0, 36.0]], np.float32)
    want = np.asarray(jmasks.paste_masks_in_image(jnp.asarray(masks), jnp.asarray(boxes), 36, 48))
    got = n(tmasks.paste_masks_in_image(t(masks), t(boxes), 36, 48))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(n(tmasks.paste_mask_in_image(t(masks[0]), t(boxes[0]), 36, 48)), want[0])


def seg_case(seed):
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for i in range(3):
        g = np.zeros((2 + i % 2, 40, 40), bool)
        for j in range(len(g)):
            y, x = rng.integers(0, 25, 2)
            g[j, y:y + rng.integers(6, 15), x:x + rng.integers(6, 15)] = True
        d = np.concatenate([g, g[:1]]) ^ (rng.uniform(size=(len(g) + 1, 40, 40)) > 0.93)
        gts.append({"masks": g})
        dets.append({"masks": d, "scores": np.round(rng.uniform(size=len(d)), 1)})  # ties in the scores
    dets[1] = {"masks": np.zeros((0, 40, 40), bool), "scores": np.zeros(0)}  # an image with no detection
    return dets, gts


def test_mask_iou_and_segm_ap_match_jax():
    dets, gts = seg_case(6)
    np.testing.assert_array_equal(tce.mask_iou(dets[0]["masks"], gts[0]["masks"]),
                                  jce.mask_iou(dets[0]["masks"], gts[0]["masks"]))
    assert tce.mask_iou(np.zeros((0, 4, 4), bool), gts[0]["masks"]).shape == (0, len(gts[0]["masks"]))
    want = jce.evaluate_instance_segmentation(dets, gts)
    got = tce.evaluate_instance_segmentation(dets, gts)
    assert set(got) == set(want)
    for k, w in want.items():
        assert (np.isnan(w) and np.isnan(got[k])) or got[k] == w, (k, got[k], w)
    assert 0 < got["AP"] < 100


def test_heads_are_evaluable_as_in_jax(inference):
    """The JAX package's TestHeadsAreEvaluable chain, each package on its own
    inference outputs of the same seeded model and images."""
    want, got = inference
    g = gt_batch()

    def chain(out, paste, decode, sig, ce, mod):
        seg_d, seg_g, kp_d, kp_g, pasted_all, kps_all = [], [], [], [], [], []
        for b in range(B):
            valid = out["valid"][b]
            pasted = np.asarray(paste(sig(out["mask_logits"][b, :, :, :, 0]), out["boxes"][b], *HW))
            kps = np.asarray(decode(out["keypoint_logits"][b], out["boxes"][b]))
            gv = g["gt_valid"][b]
            gb = g["gt_boxes"][b][gv]
            seg_d.append({"masks": pasted[valid], "scores": out["scores"][b][valid]})
            seg_g.append({"masks": g["gt_masks"][b][gv]})
            kp_d.append({"keypoints": kps[valid], "scores": out["scores"][b][valid]})
            kp_g.append({"keypoints": g["gt_keypoints"][b][gv],
                         "boxes": np.concatenate([gb[:, :2], gb[:, 2:] - gb[:, :2]], axis=1)})
            pasted_all.append(pasted)
            kps_all.append(kps)
        return (mod.evaluate_instance_segmentation(seg_d, seg_g), mod.evaluate_keypoints(kp_d, kp_g),
                np.stack(pasted_all), np.stack(kps_all))

    jw = chain({k: jnp.asarray(v) for k, v in want.items()}, jmasks.paste_masks_in_image,
               jcascade.keypoints_from_logits, jax.nn.sigmoid, jce, jce)
    tw = chain({k: t(v) for k, v in got.items()}, tmasks.paste_masks_in_image, tcascade.keypoints_from_logits,
               torch.sigmoid, tce, tce)
    (jseg, jkp, jpasted, jkps), (tseg, tkp, tpasted, tkps) = jw, tw
    assert (tpasted != jpasted).mean() <= 1e-3
    np.testing.assert_allclose(tkps, jkps, atol=1e-3, rtol=0)
    for want_res, got_res in ((jseg, tseg), (jkp, tkp)):
        assert set(got_res) == set(want_res)
        for k, w in want_res.items():
            assert (np.isnan(w) and np.isnan(got_res[k])) or abs(got_res[k] - w) <= 1e-6, (k, got_res[k], w)
        assert 0.0 <= got_res["AP"] <= 100.0 or np.isnan(got_res["AP"])
    for b in range(B):  # the keypoints land inside their boxes
        for r in range(tkps.shape[1]):
            if got["valid"][b, r]:
                assert (tkps[b, r, :, 0] >= got["boxes"][b, r, 0] - 1e-3).all()
                assert (tkps[b, r, :, 0] <= got["boxes"][b, r, 2] + 1e-3).all()
