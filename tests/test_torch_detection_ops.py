"""Port parity: the detector's training ops against the JAX package, on the CPU.

* ``get_deltas``, ``elementwise_iou`` and ``match_to_gt`` (ties to the
  first maximum, as ``jnp.argmax``); ``subsample_labels`` and
  ``gather_topk_mask`` on JAX's own uniform draws (``jax.random.split`` /
  ``uniform`` of the same keys), handed to the port;
* ``rpn_losses``, ``sample_proposals`` and ``fast_rcnn_losses`` per image
  against the JAX functions on the same draws;
* the pooler's gradient: ``roi_align_multilevel`` under autograd (K2's
  plain version, ``impl="windowed"``) against ``jax.grad`` of
  ``multilevel_roi_align(impl="windowed")`` on boxes of every level,
  across the image's edges, larger than the read window and on level
  boundaries;
* the ``config_4`` deviation: ``pooler_impl="pallas"``, which ``jax.grad``
  cannot differentiate, trains in the port, and its ROI heads' gradient
  equals the windowed pooler's where the two windows pick the same taps;
* K4's plain version at N = 1025, 2000 and 2048 against the XLA
  ``nms_mask``, and the wrapper raising at 2049.

Masks and indices must be equal; floats within 1e-6 relative (1e-6 of the
scale where a value is near 0); the pooler's gradient within 1e-5 of its
scale (the same bilinear weights, summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import roi_heads as jroi
from spacecraft_pose_estimation_tpu.models import rpn as jrpn
from spacecraft_pose_estimation_tpu.models import sampling as jsampling
from spacecraft_pose_estimation_tpu.ops import boxes as jboxes
from spacecraft_pose_estimation_tpu.ops import nms as jnms
from spacecraft_pose_estimation_tpu.ops.roi_align import multilevel_roi_align
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import roi_heads as troi_heads
from spacecraft_pose_estimation_tpu_torch.models import rpn as trpn
from spacecraft_pose_estimation_tpu_torch.models import sampling as tsampling
from spacecraft_pose_estimation_tpu_torch.ops import boxes as tboxes
from spacecraft_pose_estimation_tpu_torch.ops import nms as tnms
from spacecraft_pose_estimation_tpu_torch.ops import roi_align as troi

from torch_port_util import few_threads, n, random_variables, t  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

STRIDES = (4, 8, 16, 32)


def close(got, want, rtol=1e-6):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=rtol * scale)


def jax_pri(key, n_items):
    """The (pos, neg) priorities ``subsample_labels`` draws from ``key``."""
    kp, kn = jax.random.split(key)
    return np.asarray(jax.random.uniform(kp, (n_items,))), np.asarray(jax.random.uniform(kn, (n_items,)))


def random_boxes(rng, k, size=100.0, degenerate=True):
    xy = rng.uniform(0, size, (k, 2))
    wh = rng.uniform(1, size / 2, (k, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if degenerate:  # zero width and zero height: the 1e-7 clamps of get_deltas
        b[::7, 2] = b[::7, 0]
        b[3::11, 3] = b[3::11, 1]
    return b


def test_get_deltas_and_elementwise_iou():
    rng = np.random.default_rng(0)
    src, tgt = random_boxes(rng, 64), random_boxes(rng, 64)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        close(tboxes.get_deltas(t(src), t(tgt), w), jboxes.get_deltas(jnp.asarray(src), jnp.asarray(tgt), w))
    close(tboxes.elementwise_iou(t(src), t(tgt)), jboxes.elementwise_iou(jnp.asarray(src), jnp.asarray(tgt)))


@pytest.mark.parametrize("thresholds,labels,low_quality", [((0.3, 0.7), (0, -1, 1), True),
                                                           ((0.5,), (0, 1), False)])
def test_match_to_gt_ties_and_padding(thresholds, labels, low_quality):
    """IoUs quantized to tenths give ties between GT rows and between
    candidates; two zero rows are padding."""
    rng = np.random.default_rng(1)
    iou = np.round(rng.uniform(0, 1, (6, 200)), 1).astype(np.float32)
    iou[4:] = 0.0
    iou[:, :10] = 0.0  # candidates no GT overlaps
    iou[1, 20] = iou[2, 20] = 0.9  # a tie on one candidate
    mi, lab = tboxes.match_to_gt(t(iou), thresholds, labels, low_quality)
    jmi, jlab = jboxes.match_to_gt(jnp.asarray(iou), thresholds, labels, low_quality)
    np.testing.assert_array_equal(n(mi), np.asarray(jmi))
    np.testing.assert_array_equal(n(lab), np.asarray(jlab))
    assert n(mi)[20] == 1 and set(np.unique(n(lab))) == set(labels)


@pytest.mark.parametrize("num,frac,pos_share", [(64, 0.25, 0.3), (64, 0.5, 0.02), (512, 0.25, 0.1)])
def test_subsample_labels_and_gather_on_jax_draws(num, frac, pos_share):
    rng = np.random.default_rng(2)
    k = 400
    u = rng.uniform(size=k)
    labels = np.where(u < pos_share, 1, np.where(u < 0.8, 0, -1)).astype(np.int32)
    key = jax.random.key(3)
    pos, neg = jsampling.subsample_labels(jnp.asarray(labels), num, frac, key)
    pri_pos, pri_neg = jax_pri(key, k)
    tpos, tneg = tsampling.subsample_labels(t(labels)[None], num, frac, t(pri_pos)[None], t(pri_neg)[None])
    np.testing.assert_array_equal(n(tpos)[0], np.asarray(pos))
    np.testing.assert_array_equal(n(tneg)[0], np.asarray(neg))
    gkey = jax.random.key(4)
    for kk in (32, min(num, k)):  # fewer and more than the selected
        idx, valid = jsampling.gather_topk_mask(pos | neg, kk, gkey)
        tidx, tvalid = tsampling.gather_topk_mask(tpos | tneg, kk, t(np.asarray(jax.random.uniform(gkey, (k,))))[None])
        np.testing.assert_array_equal(n(tidx)[0], np.asarray(idx))
        np.testing.assert_array_equal(n(tvalid)[0], np.asarray(valid))


def _rpn_case(rng, b=3):
    shapes = {"p2": (8, 8), "p3": (4, 4), "p4": (2, 2)}
    anchors, head = {}, {}
    for i, (lvl, (h, w)) in enumerate(shapes.items()):
        s = 4 * 2**i
        cy, cx = np.meshgrid((np.arange(h) + 0.5) * s, (np.arange(w) + 0.5) * s, indexing="ij")
        per = []
        for size in (8 * s, 12 * s, 16 * s):  # three anchors a cell
            per.append(np.stack([cx - size / 2, cy - size / 2, cx + size / 2, cy + size / 2], -1))
        anchors[lvl] = np.stack(per, 2).reshape(-1, 4).astype(np.float32)
        head[lvl] = (rng.normal(0, 2, (b, h, w, 3)).astype(np.float32),
                     rng.normal(0, 0.2, (b, h, w, 12)).astype(np.float32))
    gt = np.zeros((b, 4, 4), np.float32)
    gt_valid = np.zeros((b, 4), bool)
    gt[0, :2] = [[4, 6, 30, 28], [10, 2, 60, 50]]
    gt_valid[0, :2] = True
    gt[1, 0] = [0, 0, 64, 64]
    gt_valid[1, 0] = True  # image 2 has no GT: only negatives
    return anchors, head, gt, gt_valid


@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_rpn_losses_on_jax_draws(beta):
    rng = np.random.default_rng(5)
    anchors, head, gt, gt_valid = _rpn_case(rng)
    cfg = jrpn.RPNConfig(batch_size_per_image=32, smooth_l1_beta=beta)
    tcfg = trpn.RPNConfig(batch_size_per_image=32, smooth_l1_beta=beta)
    n_anchors = sum(a.shape[0] for a in anchors.values())
    keys = jax.random.split(jax.random.key(6), gt.shape[0])
    draws = [jax_pri(k, n_anchors) for k in keys]
    got = trpn.rpn_losses({k: (t(a), t(d)) for k, (a, d) in head.items()}, {k: t(v) for k, v in anchors.items()},
                          t(gt), t(gt_valid), t(np.stack([d[0] for d in draws])), t(np.stack([d[1] for d in draws])),
                          tcfg)
    for i in range(gt.shape[0]):
        want = jrpn.rpn_losses({k: (jnp.asarray(a[i]), jnp.asarray(d[i])) for k, (a, d) in head.items()},
                               {k: jnp.asarray(v) for k, v in anchors.items()}, jnp.asarray(gt[i]),
                               jnp.asarray(gt_valid[i]), keys[i], cfg)
        for name, v in want.items():
            close(got[name][i], v)
    assert float(got["loss_rpn_loc"][2]) == 0.0 and float(got["loss_rpn_loc"][0]) > 0


@pytest.mark.parametrize("agnostic,num_classes,beta", [(True, 1, 0.0), (False, 3, 0.5)])
def test_sample_proposals_and_fast_rcnn_losses_on_jax_draws(agnostic, num_classes, beta):
    rng = np.random.default_rng(7)
    b, p, g = 2, 40, 4
    props = np.stack([random_boxes(rng, p, 64, degenerate=False) for _ in range(b)])
    prop_valid = rng.uniform(size=(b, p)) < 0.85
    gt = np.zeros((b, g, 4), np.float32)
    gt[:, :3] = np.stack([random_boxes(rng, 3, 64, degenerate=False) for _ in range(b)])
    props[:, :6] = gt[:, [0, 0, 1, 1, 2, 2]] + rng.normal(0, 2, (b, 6, 4)).astype(np.float32)  # some positives
    gt_valid = np.zeros((b, g), bool)
    gt_valid[0, :3] = True
    gt_valid[1, :1] = True
    gt_classes = rng.integers(0, num_classes, (b, g)).astype(np.int32)
    cfg = jroi.ROIHeadsConfig(num_classes=num_classes, batch_size_per_image=24, cls_agnostic_bbox_reg=agnostic,
                              smooth_l1_beta=beta)
    tcfg = troi_heads.ROIHeadsConfig(num_classes=num_classes, batch_size_per_image=24,
                                     cls_agnostic_bbox_reg=agnostic, smooth_l1_beta=beta)
    keys = jax.random.split(jax.random.key(8), b)
    pri = {"pos": [], "neg": [], "gather": []}
    for k in keys:
        k1, k2 = jax.random.split(k)
        pp, pn = jax_pri(k1, p + g)
        pri["pos"].append(pp)
        pri["neg"].append(pn)
        pri["gather"].append(np.asarray(jax.random.uniform(k2, (p + g,))))
    sampled = troi_heads.sample_proposals(t(props), t(prop_valid), t(gt), t(gt_classes), t(gt_valid),
                                          *(t(np.stack(pri[k])) for k in ("pos", "neg", "gather")), tcfg)
    scores = rng.normal(0, 1, (b, 24, num_classes + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (b, 24, 4 * (1 if agnostic else num_classes))).astype(np.float32)
    losses = troi_heads.fast_rcnn_losses(t(scores), t(deltas), sampled, tcfg)
    for i in range(b):
        want = jroi.sample_proposals(jnp.asarray(props[i]), jnp.asarray(prop_valid[i]), jnp.asarray(gt[i]),
                                     jnp.asarray(gt_classes[i]), jnp.asarray(gt_valid[i]), keys[i], cfg)
        for name in ("valid", "gt_classes", "is_fg"):
            np.testing.assert_array_equal(n(sampled[name][i]), np.asarray(want[name]), err_msg=name)
        np.testing.assert_array_equal(n(sampled["boxes"][i]), np.asarray(want["boxes"]))
        np.testing.assert_array_equal(n(sampled["gt_boxes"][i]), np.asarray(want["gt_boxes"]))
        jl = jroi.fast_rcnn_losses(jnp.asarray(scores[i]), jnp.asarray(deltas[i]), want, cfg)
        for name, v in jl.items():
            close(losses[name][i], v)
    assert n(sampled["is_fg"]).any() and float(losses["loss_box_reg"].sum()) > 0


# image 256 x 256: P2..P5 of 64, 32, 16, 8 cells
POOL_BOXES = np.array([
    [4, 6, 20, 30], [100, 90, 140, 150], [230, 10, 262, 40],  # P2; the last across the right edge
    [100, 100, 212, 212], [-20, 120, 92, 232],  # sqrt(area) 112: the P2/P3 boundary, one across the left edge
    [30, 40, 254, 264], [10.5, 0, 234.5, 224],  # 224: the P3/P4 boundary
    [0, 0, 448, 448], [-60, -60, 300, 300],  # 448 and more: P5
    [20, 100, 244, 116],  # sqrt(area) 60 (P2) but 224 wide: 56 cells, larger than the 16-cell window
    [60, 10, 76, 250],  # 240 tall on P2: larger than the window
], np.float32)


def _pool_case(rng, c=8, b=2, sides=tuple(256 // s for s in STRIDES)):
    feats = [rng.normal(size=(b, side, side, c)).astype(np.float32) for side in sides]
    batch_idx = np.arange(len(POOL_BOXES)) % b
    return feats, batch_idx


# the pyramid's sides P2..P5 and the level left without a box: the 256 image;
# sides that are not multiples of 16, as K2b's tiles meet at 800^2 (200, 100,
# 50, 25); and P4 with no box, whose gradient is exactly 0
POOL_GRAD_CASES = {
    "sides 64-8": ((64, 32, 16, 8), None),
    "sides 50, 25, 13, 7": ((50, 25, 13, 7), None),
    "no box on P4": ((64, 32, 16, 8), 2),
}


@pytest.mark.parametrize("case", POOL_GRAD_CASES)
def test_pooler_gradient_matches_jax_grad_of_the_windowed_pooler(case):
    """The port's CPU gradient of K2 (autograd of the plain version, and
    ``roi_align_multilevel_backward_plain``, K2b's yardstick on the card)
    against ``jax.grad`` of the windowed pooler, within 1e-5 of the
    gradient's scale; a level no box reaches is exactly 0 in all three."""
    sides, empty = POOL_GRAD_CASES[case]
    rng = np.random.default_rng(9)
    window = 16
    feats, batch_idx = _pool_case(rng, sides=sides)
    levels = n(troi.assign_levels(t(POOL_BOXES), 4, 2))
    assert set(levels) == {0, 1, 2, 3}
    g = rng.normal(size=(len(POOL_BOXES), 7, 7, feats[0].shape[-1])).astype(np.float32)
    keep = levels != empty
    boxes, batch_idx, g = POOL_BOXES[keep], batch_idx[keep], g[keep]

    def jloss(fs):
        total = 0.0
        for i in range(feats[0].shape[0]):
            sel = np.flatnonzero(batch_idx == i)
            out = multilevel_roi_align([f[i] for f in fs], jnp.asarray(boxes[sel]), 7, STRIDES,
                                       sampling_ratio=2, impl="windowed", window=window)
            total = total + jnp.sum(out * g[sel])
        return total

    with pytest.warns(UserWarning):
        want = jax.grad(jloss)([jnp.asarray(f) for f in feats])
    leaves = [t(f).requires_grad_() for f in feats]
    with pytest.warns(UserWarning, match="window"):
        out = troi.roi_align_multilevel(leaves, t(boxes), t(batch_idx, torch.int32), 7, STRIDES, 2, window,
                                        impl="windowed")
    out.backward(t(g))
    plain = troi.roi_align_multilevel_backward_plain(t(g), [f.shape for f in feats], torch.float32, t(boxes),
                                                     t(batch_idx, torch.int32), 7, STRIDES, 2, window,
                                                     impl="windowed")
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for lvl, (leaf, yardstick, w) in enumerate(zip(leaves, plain, want)):
        got = np.zeros_like(feats[lvl]) if leaf.grad is None else n(leaf.grad)  # autograd leaves an unused leaf None
        if lvl == empty:
            assert not np.asarray(w).any() and not got.any() and not n(yardstick).any(), f"P{lvl + 2}"
            continue
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5 * scale, err_msg=f"P{lvl + 2}")
        np.testing.assert_allclose(n(yardstick), np.asarray(w), atol=1e-5 * scale, err_msg=f"P{lvl + 2}, plain")
        assert np.abs(np.asarray(w)).max() > 0


def test_pallas_pooler_impl_trains_as_the_windowed_one():
    """``config_4`` sets ``pooler_impl="pallas"``: ``jax.grad`` through the
    Pallas pooler raises, so the reference cannot train it; the port can.
    Where the two windows pick the same taps (boxes inside the window, map
    widths whose x origin needs no rounding), the port's ROI heads' gradient
    with the Pallas window equals ``jax.grad`` of the JAX heads with the
    windowed pooler."""
    rng = np.random.default_rng(10)
    feats, _ = _pool_case(rng, c=8, b=2)
    boxes = np.stack([POOL_BOXES[:9], POOL_BOXES[:9] + 3.0])  # (2, 9, 4), all inside a 48-cell window
    jcfg = jroi.ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, fc_dim=16, pooler_impl="windowed")
    jheads = jroi.StandardROIHeads(jcfg)
    jfeats = {f"p{i + 2}": jnp.asarray(f) for i, f in enumerate(feats)}
    strides = {f"p{i + 2}": s for i, s in enumerate(STRIDES)}
    variables = random_variables(lambda: jheads.init(jax.random.key(0), jfeats, jnp.asarray(boxes), strides), 11)
    gs, gd = rng.normal(size=(2, 9, 2)).astype(np.float32), rng.normal(size=(2, 9, 4)).astype(np.float32)

    def jloss(fs):
        s, d = jheads.apply(variables, fs, jnp.asarray(boxes), strides)
        return jnp.sum(s * gs) + jnp.sum(d * gd)

    want = jax.grad(jloss)(jfeats)
    heads = troi_heads.StandardROIHeads(dataclasses.replace(
        troi_heads.ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, fc_dim=16), pooler_impl="pallas"), 8)
    heads.load_state_dict(flax_to_state_dict(variables))
    leaves = {k: t(np.asarray(v)).requires_grad_() for k, v in jfeats.items()}
    s, d = heads(leaves, t(boxes), strides)
    (torch.sum(s * t(gs)) + torch.sum(d * t(gd))).backward()
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, leaf in leaves.items():
        np.testing.assert_allclose(n(leaf.grad), np.asarray(want[k]), atol=1e-5 * scale, err_msg=k)


def _nms_problem(rng, k, all_invalid=False):
    centers = rng.uniform(0, 400, (6, 2))
    c = centers[rng.integers(0, 6, k)] + rng.normal(0, 10, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.floor(rng.uniform(0, k // 4, k)).astype(np.float32)  # ties
    valid = rng.uniform(size=k) < 0.85
    dst, src = rng.integers(0, k, k // 4), rng.integers(0, k, k // 4)
    boxes[dst] = boxes[src]  # duplicates
    zero = rng.integers(0, k, k // 8)
    boxes[zero[::2], 2] = boxes[zero[::2], 0]  # zero width
    boxes[zero[1::2], 3] = boxes[zero[1::2], 1]  # zero height
    if all_invalid:
        valid[:] = False
    return boxes, scores, valid


@pytest.mark.parametrize("k,thresh,all_invalid", [(1025, 0.7, False), (2000, 0.7, False), (2000, 0.5, True),
                                                   (2048, 0.3, False)])
def test_nms_plain_at_training_sizes_matches_jax(k, thresh, all_invalid):
    boxes, scores, valid = _nms_problem(np.random.default_rng(k), k, all_invalid)
    want = np.asarray(jax.jit(jnms.nms_mask, static_argnums=2)(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                                                jnp.asarray(valid)))
    got = n(tnms.nms_mask(t(boxes), t(scores), thresh, t(valid)))
    np.testing.assert_array_equal(got, want)
    assert (not got.any()) if all_invalid else 0 < got.sum() < valid.sum()


def test_nms_raises_above_2048_boxes():
    with pytest.raises(ValueError, match="at most 2048"):
        tnms.nms_mask_sorted(torch.zeros(1, 2049, 4), torch.ones(1, 2049, dtype=torch.bool), 0.5)
