"""Port parity of ``structures.py`` and three small helpers:
``ops/nms.top_k_by_score`` and ``ops/geometry.quat_to_rotmat`` /
``rotmat_to_rodrigues``, on the CPU against the JAX package.

* ``Boxes``: area, clip, nonempty and IoU of seeded boxes (zero-area and
  out-of-frame ones among them) equal to JAX's (exact: the same float32
  operations).
* ``Instances``: ``create``'s ValueError, ``num_instances``, ``masked``
  and ``to_numpy`` equal; ``instances_from_detections`` on a padded batch.
* ``top_k_by_score`` with ties and invalid rows: the indices equal
  ``lax.top_k``'s (ties to the lower index), the values exactly.
* ``quat_to_rotmat`` on seeded quaternions within 1e-6;
  ``rotmat_to_rodrigues`` at theta = 0, 1 and pi - 1e-7 (the near-pi
  branch: the axis from the diagonal, the signs from the skew part) about
  several axes, within 1e-6 rad.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import structures as jst
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import nms as jnms
from spacecraft_pose_estimation_tpu_torch import structures as tst
from spacecraft_pose_estimation_tpu_torch.ops import geometry as tgeo
from spacecraft_pose_estimation_tpu_torch.ops import nms as tnms

from torch_port_util import n, t


def _boxes(seed, k=12):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 60, (k, 2))
    wh = rng.uniform(0, 30, (k, 2))
    wh[3] = 0.0  # zero-area
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_boxes_match_jax():
    a, b = _boxes(0), _boxes(1)
    jb, tb = jst.Boxes(jnp.asarray(a)), tst.Boxes(t(a))
    np.testing.assert_array_equal(n(tb.area()), np.asarray(jb.area()))
    np.testing.assert_array_equal(n(tb.clip(40, 50).tensor), np.asarray(jb.clip(40, 50).tensor))
    for thr in (0.0, 5.0):
        np.testing.assert_array_equal(n(tb.nonempty(thr)), np.asarray(jb.nonempty(thr)))
    np.testing.assert_array_equal(n(tb.iou(tst.Boxes(t(b)))), np.asarray(jb.iou(jst.Boxes(jnp.asarray(b)))))
    assert len(tb) == len(jb) == 12


def test_instances_match_jax():
    rng = np.random.default_rng(2)
    valid = np.array([True, False, True, True, False])
    fields = {"boxes": _boxes(3, 5), "scores": rng.uniform(size=5).astype(np.float32),
              "classes": rng.integers(0, 4, 5).astype(np.int32), "masks": rng.uniform(size=(5, 3, 3)) > 0.5}
    ji = jst.Instances.create(jnp.asarray(valid), **{k: jnp.asarray(v) for k, v in fields.items()})
    ti = tst.Instances.create(t(valid), **{k: t(v) for k, v in fields.items()})
    assert int(ti.num_instances()) == int(ji.num_instances()) == 3
    for name in fields:
        assert ti.has(name) and ji.has(name)
        np.testing.assert_array_equal(n(ti.get(name)), np.asarray(ji.get(name)))
        np.testing.assert_array_equal(n(ti.masked(name)), np.asarray(ji.masked(name)))
    np.testing.assert_array_equal(n(ti.masked("scores", fill=-1.0)), np.asarray(ji.masked("scores", fill=-1.0)))
    assert not ti.has("keypoints")
    got, want = ti.to_numpy(), ji.to_numpy()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for mod, arr in ((jst, jnp.asarray), (tst, t)):
        with pytest.raises(ValueError, match="leading dim"):
            mod.Instances.create(arr(np.ones(3, bool)), boxes=arr(np.ones((2, 4), np.float32)))


def test_instances_from_detections_match_jax():
    rng = np.random.default_rng(4)
    dets = {"boxes": np.stack([_boxes(5, 6), _boxes(6, 6)]), "scores": rng.uniform(size=(2, 6)).astype(np.float32),
            "classes": rng.integers(0, 3, (2, 6)).astype(np.int32), "valid": rng.uniform(size=(2, 6)) > 0.4}
    jl = jst.instances_from_detections({k: jnp.asarray(v) for k, v in dets.items()})
    tl = tst.instances_from_detections({k: t(v) for k, v in dets.items()})
    assert len(tl) == len(jl) == 2
    for ti, ji in zip(tl, jl):
        np.testing.assert_array_equal(n(ti.valid), np.asarray(ji.valid))
        got, want = ti.to_numpy(), ji.to_numpy()
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "with_invalid"])
def test_top_k_by_score_matches_lax_top_k(masked):
    rng = np.random.default_rng(7)
    scores = rng.choice([0.1, 0.5, 0.5, 0.9, -1.0], (3, 20)).astype(np.float32)  # many ties
    valid = rng.uniform(size=(3, 20)) > 0.3 if masked else None
    for k in (1, 7, 20):
        jv, ji = jnms.top_k_by_score(jnp.asarray(scores), k, None if valid is None else jnp.asarray(valid))
        tv, ti = tnms.top_k_by_score(t(scores), k, None if valid is None else t(valid))
        np.testing.assert_array_equal(n(ti), np.asarray(ji))
        np.testing.assert_array_equal(n(tv), np.asarray(jv))


def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(8).normal(size=(16, 4)).astype(np.float32)
    want = np.stack([np.asarray(jgeo.quat_to_rotmat(jnp.asarray(qi))) for qi in q])
    np.testing.assert_allclose(n(tgeo.quat_to_rotmat(t(q))), want, atol=1e-6)


@pytest.mark.parametrize("theta", [0.0, 1.0, math.pi - 1e-7], ids=["zero", "one", "near_pi"])
def test_rotmat_to_rodrigues_matches_jax(theta):
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 2, 3], [-2, 1, -0.5], [0.3, -1, 2]], np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rvecs = (axes * theta).astype(np.float32)
    rs = n(tgeo.rodrigues(t(rvecs)))
    want = np.stack([np.asarray(jgeo.rotmat_to_rodrigues(jnp.asarray(r))) for r in rs])
    got = n(tgeo.rotmat_to_rodrigues(t(rs)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    if theta > 3:  # the near-pi branch recovers the rotation up to the axis' sign
        np.testing.assert_allclose(np.abs(got), np.abs(rvecs), atol=2e-3)
