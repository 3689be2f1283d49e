"""Port parity of ``ops/rotated_boxes.py`` and the rotated-box AP
(``data/coco_eval.evaluate_rotated_detections``) on the CPU against the
JAX package.

* ``pairwise_iou_rotated`` on the JAX tests' ``random_rboxes`` draws
  (seeds 0-2) and on special pairs (identical, axis-aligned, nested,
  disjoint, sharing an edge, zero-area, 90-degree turns): within 1e-5
  (float32 corners through cos / sin and polygon sums); the row-chunked
  form (a chunk of 7 pairs) equal to one chunk bit for bit.
* ``nms_rotated_mask``: keep-masks equal to JAX's on near-duplicates, on
  the random draws at 0.4, and on a clustered set of 96 boxes with tied
  scores and invalid boxes at 0.5 and 0.7.
* ``evaluate_rotated_detections`` on 8 seeded images (1-3 GT boxes, 0-6
  detections jittered around them; areas spanning every range): every AP
  entry within 1e-9 (the matching is float64 on the same float32 IoU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.data import coco_eval as jce
from spacecraft_pose_estimation_tpu.ops import rotated_boxes as jrb
from spacecraft_pose_estimation_tpu_torch.data import coco_eval as tce
from spacecraft_pose_estimation_tpu_torch.ops import rotated_boxes as trb

from test_rotated_boxes import random_rboxes
from torch_port_util import n, t

SPECIAL = np.array([
    [50, 50, 20, 20, 0], [60, 50, 20, 20, 0],  # axis-aligned, half overlap
    [50, 50, 30, 10, 37], [50, 50, 30, 10, 37],  # identical
    [50, 50, 40, 40, 15], [52, 49, 10, 6, -70],  # nested
    [10, 10, 5, 5, 15], [100, 100, 5, 5, 70],  # disjoint
    [0, 0, 10, 10, 0], [10, 0, 10, 10, 0],  # sharing an edge
    [30, 30, 0, 10, 20], [30, 30, 10, 10, 20],  # zero width
    [70, 70, 40, 10, 0], [70, 70, 40, 10, 90],  # a cross
], np.float32)


def _iou_cases():
    rng = {s: np.random.default_rng(s) for s in range(3)}
    cases = {f"random{s}": (random_rboxes(rng[s], 8), random_rboxes(rng[s], 6)) for s in range(3)}
    cases["special"] = (SPECIAL, SPECIAL)
    return cases


@pytest.mark.parametrize("name", sorted(_iou_cases()))
def test_pairwise_iou_rotated_matches_jax(name):
    a, b = _iou_cases()[name]
    # eager, as the JAX tests run it: jitted, XLA rounds the 5x5 box at 70 degrees against itself to 1.0000244
    want = np.asarray(jrb.pairwise_iou_rotated(jnp.asarray(a), jnp.asarray(b)))
    got = n(trb.pairwise_iou_rotated(t(a), t(b)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want > 0.05).any() and (want == 0).any()


def test_row_chunks_equal_one_chunk(monkeypatch):
    a, b = _iou_cases()["random1"]
    whole = trb.pairwise_iou_rotated(t(a), t(b))
    monkeypatch.setattr(trb, "PAIRS_PER_CHUNK", 7)  # one row a chunk here
    assert torch.equal(trb.pairwise_iou_rotated(t(a), t(b)), whole)


def clustered_rboxes(seed, clusters=12, per=8):
    """Boxes jittered around a few centres (NMS keeps some of each cluster)."""
    rng = np.random.default_rng(seed)
    centres = random_rboxes(rng, clusters)
    boxes = np.repeat(centres, per, axis=0)
    boxes[:, :2] += rng.normal(0, 3, (len(boxes), 2))
    boxes[:, 2:4] *= rng.uniform(0.8, 1.2, (len(boxes), 2))
    boxes[:, 4] += rng.normal(0, 10, len(boxes))
    return boxes.astype(np.float32)


def _nms_cases():
    rng = np.random.default_rng(3)
    base = random_rboxes(rng, 4)
    dup = base.copy()
    dup[:, :2] += rng.normal(0, 1.0, (4, 2))
    cases = {"duplicates": (np.concatenate([base, dup]), np.repeat([0.9, 0.5], 4).astype(np.float32), None, 0.5)}
    rng = np.random.default_rng(4)
    cases["random"] = (random_rboxes(rng, 16), rng.uniform(size=16).astype(np.float32), None, 0.4)
    rng = np.random.default_rng(5)
    boxes = clustered_rboxes(5)
    scores = np.round(rng.uniform(size=len(boxes)), 1).astype(np.float32)  # ties
    valid = rng.uniform(size=len(boxes)) > 0.15
    for thr in (0.5, 0.7):
        cases[f"clustered{thr}"] = (boxes, scores, valid, thr)
    return cases


@pytest.mark.parametrize("name", sorted(_nms_cases()))
def test_nms_rotated_mask_matches_jax(name):
    boxes, scores, valid, thr = _nms_cases()[name]
    jv = None if valid is None else jnp.asarray(valid)
    want = np.asarray(jax.jit(jrb.nms_rotated_mask, static_argnums=2)(jnp.asarray(boxes), jnp.asarray(scores), thr, jv))
    got = n(trb.nms_rotated_mask(t(boxes), t(scores), thr, None if valid is None else t(valid)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < (len(got) if valid is None else valid.sum())


def rotated_scene(seed, n_images=8):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_images):
        g = random_rboxes(rng, int(rng.integers(1, 4))).astype(np.float64)
        g[:, 2:4] *= rng.choice([0.3, 1.0, 2.0], (len(g), 1))  # small, medium and large areas
        k = int(rng.integers(0, 7))
        src = g[rng.integers(0, len(g), k)] if k else np.zeros((0, 5))
        d = src + rng.normal(0, 1, src.shape) * [4, 4, 3, 3, 8]
        dets.append({"boxes": d, "scores": rng.uniform(size=k)})
        gts.append({"boxes": g})
    return dets, gts


@pytest.mark.parametrize("max_dets", [100, 2])
def test_evaluate_rotated_detections_matches_jax(max_dets):
    dets, gts = rotated_scene(6)
    want = jce.evaluate_rotated_detections(dets, gts, max_dets=max_dets)
    got = tce.evaluate_rotated_detections(dets, gts, max_dets=max_dets, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=k)
    assert 0 < want["AP50"] < 100
