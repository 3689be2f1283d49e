"""Port parity: ops/nms (kernel K4's plain version) against the JAX NMS.

The JAX side runs both its XLA ``nms_mask`` and the Pallas kernel
(``nms_mask_pallas``, interpret mode on the CPU). Keep-masks must agree
exactly: the IoU is the same float32 formula on the same boxes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops import nms as jnms
from spacecraft_pose_estimation_tpu.ops.pallas_nms import nms_mask_pallas
from spacecraft_pose_estimation_tpu_torch.ops import nms as tnms

from torch_port_util import n, t


def _problem(rng, k, clustered=True):
    centers = rng.uniform(0, 200, (4 if clustered else k, 2))
    c = centers[rng.integers(0, len(centers), k)] + rng.normal(0, 8, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    scores[rng.integers(0, k, 4)] = scores[0]  # score ties: input order decides
    valid = rng.uniform(size=k) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("seed,k,thresh", [(0, 64, 0.5), (1, 200, 0.7), (2, 17, 0.3)])
def test_nms_mask_matches_jax(seed, k, thresh):
    boxes, scores, valid = _problem(np.random.default_rng(seed), k)
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh, jnp.asarray(valid)))
    want_pallas = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh, jnp.asarray(valid)))
    got = n(tnms.nms_mask(t(boxes), t(scores), thresh, t(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    assert 0 < got.sum() < valid.sum()


def test_many_problems_in_one_call():
    """Leading dims are independent problems (the RPN's image x level)."""
    rng = np.random.default_rng(3)
    probs = [_problem(rng, 48) for _ in range(6)]
    boxes = np.stack([p[0] for p in probs]).reshape(2, 3, 48, 4)
    scores = np.stack([p[1] for p in probs]).reshape(2, 3, 48)
    valid = np.stack([p[2] for p in probs]).reshape(2, 3, 48)
    got = n(tnms.nms_mask(t(boxes), t(scores), 0.6, t(valid)))
    for i, (b, s, v) in enumerate(probs):
        want = np.asarray(jnms.nms_mask(jnp.asarray(b), jnp.asarray(s), 0.6, jnp.asarray(v)))
        np.testing.assert_array_equal(got.reshape(6, 48)[i], want)


def test_batched_nms_mask_matches_jax():
    rng = np.random.default_rng(4)
    boxes, scores, valid = _problem(rng, 60)
    cls = rng.integers(0, 3, 60).astype(np.int32)
    want = np.asarray(jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), 0.5,
                                            jnp.asarray(valid)))
    got = n(tnms.batched_nms_mask(t(boxes)[None], t(scores)[None], t(cls)[None], 0.5, t(valid)[None]))[0]
    np.testing.assert_array_equal(got, want)


def test_sorted_core_plain_matches_pallas_kernel():
    """nms_mask_sorted_plain is K4's plain version: same keep-mask as the
    Pallas kernel on score-sorted input."""
    from spacecraft_pose_estimation_tpu.ops.pallas_nms import nms_mask_sorted_pallas

    boxes, scores, valid = _problem(np.random.default_rng(5), 128)
    order = np.argsort(-scores, kind="stable")
    want = np.asarray(nms_mask_sorted_pallas(jnp.asarray(boxes[order]), jnp.asarray(valid[order]), 0.5))
    got = n(tnms.nms_mask_sorted_plain(t(boxes[order])[None], t(valid[order])[None], 0.5))[0]
    np.testing.assert_array_equal(got, want)


def _edge_problem(rng, k, all_invalid=False):
    """_problem with exact duplicate boxes (some also tied in score),
    zero-width and zero-height boxes, or no valid box at all."""
    boxes, scores, valid = _problem(rng, k)
    dst, src = rng.integers(0, k, k // 4 + 1), rng.integers(0, k, k // 4 + 1)
    boxes[dst] = boxes[src]
    scores[dst[::2]] = scores[src[::2]]
    zero = rng.integers(0, k, k // 8 + 1)
    boxes[zero[::2], 2] = boxes[zero[::2], 0]
    boxes[zero[1::2], 3] = boxes[zero[1::2], 1]
    if all_invalid:
        valid[:] = False
    return boxes, scores, valid


CASES = [(k, thresh, False) for k in (1, 63, 64, 65, 256) for thresh in (0.0, 0.99)]
CASES += [(k, 0.5, True) for k in (1, 64, 65)]


@pytest.mark.parametrize("k,thresh,all_invalid", CASES)
def test_sorted_core_suppresses_later_boxes_only(k, thresh, all_invalid):
    """K4's plain version in the kernel's form (a kept box removes only the
    boxes after it) against the Pallas kernel on the same sorted input and,
    through nms_mask's sort and scatter, against the JAX XLA nms_mask: at
    every word edge of the kernel's 64-bit masks, with duplicates, ties,
    zero-area boxes and problems with no valid box."""
    from spacecraft_pose_estimation_tpu.ops.pallas_nms import nms_mask_sorted_pallas

    boxes, scores, valid = _edge_problem(np.random.default_rng(k), k, all_invalid)
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    want = np.asarray(nms_mask_sorted_pallas(jnp.asarray(boxes[order]), jnp.asarray(valid[order]), thresh))
    got = n(tnms.nms_mask_sorted_plain(t(boxes[order])[None], t(valid[order])[None], thresh))[0]
    np.testing.assert_array_equal(got, want)
    want_xla = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh, jnp.asarray(valid)))
    np.testing.assert_array_equal(n(tnms.nms_mask(t(boxes), t(scores), thresh, t(valid))), want_xla)
    if all_invalid:
        assert not got.any()
    elif k > 1:
        assert 0 < got.sum() < valid.sum()
