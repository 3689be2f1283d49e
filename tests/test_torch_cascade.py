"""Port parity of the gather pooler, the whole-map ROIAlign, Cascade R-CNN's
ROI heads and the IoU losses, on the CPU against the JAX package.

* ``roi_align_multilevel_plain(impl="gather")`` (K2's plain version in the
  gather read) against JAX ``multilevel_roi_align(impl="gather")`` at
  P = 7 and 14, sampling ratio 2, on two images of 192x256 (P2 48x64 ...
  P5 6x8) with boxes longer than the 48-cell window on their level, boxes
  across the image's edge and boxes of side 112, 224 and 448 px (on the
  level boundaries): values within 1e-5 of their scale, and the gradient in
  the features against ``jax.grad`` within 1e-5 of its scale. The windowed
  read, on the same boxes, must miss the gather's values (the boxes are
  beyond its window).
* the whole-map ``roi_align_maps`` (the mask head's GT crop: C = 1, output
  28, scale 1) on one map against JAX ``roi_align`` on a bitmask, given as
  float32 and as bool: equal to the op run eagerly, within 1e-5 of it
  jitted (XLA's fusion rounds a few values ulps apart); and over several
  maps against itself map by map.
* ``CascadeROIHeads`` (three stages on the gather read, fc 16) on those
  levels in float32, weights carried by ``convert.flax_to_state_dict``: the
  mean scores and the last stage's boxes, and the gradient of a weighted
  sum of both in every parameter against ``jax.grad`` (the earlier stages'
  boxes carry none in either).
* ``giou_loss``, ``diou_loss``, ``ciou_loss`` elementwise, with nested,
  disjoint, touching and zero-area pairs, and their gradients (CIoU's alpha
  carries none; ties split in half, as ``jnp.maximum``'s gradient does).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import cascade as jcascade
from spacecraft_pose_estimation_tpu.models import roi_heads as jroi
from spacecraft_pose_estimation_tpu.ops import boxes as jboxes
from spacecraft_pose_estimation_tpu.ops import roi_align as jra
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import cascade as tcascade
from spacecraft_pose_estimation_tpu_torch.models import roi_heads as troi
from spacecraft_pose_estimation_tpu_torch.ops import boxes as tboxes
from spacecraft_pose_estimation_tpu_torch.ops import roi_align as tra

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HW, B, C = (192, 256), 2, 8
STRIDES = (4, 8, 16, 32)
LEVELS = ("p2", "p3", "p4", "p5")


def feats():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, HW[0] // s, HW[1] // s, C)).astype(np.float32) for s in STRIDES]


def boxes():
    """Per image 12 boxes: 3 longer than 48 cells on their level (P2 and P3),
    4 more across the image's edges, the 3 level-boundary sides, one small."""
    one = [
        [2.0, 50.0, 252.0, 70.0], [10.0, -10.0, 26.0, 200.0],  # 62 and 52 cells long on P2
        [-80.0, 60.0, 340.0, 100.0],  # 52 cells long on P3
        [40.0, 5.0, 240.0, 185.0],  # P4
        [-30.0, 20.0, 60.0, 90.0], [200.0, -25.0, 290.0, 60.0], [100.0, 150.0, 170.0, 230.0],
        [-50.0, -40.0, 300.0, 240.0],
        [20.0, 20.0, 132.0, 132.0], [10.0, 0.0, 234.0, 224.0], [-100.0, -120.0, 348.0, 328.0],
        [60.0, 70.0, 75.0, 88.0],
    ]
    out = np.array([one, [[x0 + 3.5, y0 - 2.25, x1 + 3.5, y1 - 2.25] for x0, y0, x1, y1 in one]], np.float32)
    return out  # (B, R, 4)


def jax_gather(fs, bx, p):
    """JAX's gather pooler, one image at a time (as the heads vmap it)."""
    return jax.vmap(lambda f, b: jra.multilevel_roi_align(list(f), b, p, STRIDES, sampling_ratio=2))(fs, bx)


def port_gather(fs, bx, p, impl="gather"):
    r = bx.shape[1]
    bidx = torch.arange(B, dtype=torch.int32).repeat_interleave(r)
    return tra.roi_align_multilevel_plain(fs, bx.reshape(-1, 4), bidx, p, STRIDES, 2, impl=impl)


def test_boxes_reach_beyond_the_window_and_every_level():
    bx = t(boxes()).reshape(-1, 4)
    levels = tra.assign_levels(bx, 4, 2)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    stride = torch.tensor(STRIDES, dtype=torch.float32)[levels]
    long = ((bx[:, 2] - bx[:, 0]) / stride > 48) | ((bx[:, 3] - bx[:, 1]) / stride > 48)
    edge = (bx[:, :2] < 0).any(-1) | (bx[:, 2] > HW[1]) | (bx[:, 3] > HW[0])
    assert int(long.sum()) == 6 and int(edge.sum()) >= 12


@pytest.mark.parametrize("p", [7, 14])
def test_gather_pooler_matches_jax(p):
    fs, bx = feats(), boxes()
    want = np.asarray(jax.jit(jax_gather, static_argnums=2)([jnp.asarray(f) for f in fs], jnp.asarray(bx), p))
    got = n(port_gather([t(f) for f in fs], t(bx), p)).reshape(want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    # the windowed read (a 48-cell window) cannot hold these boxes: it pools other values
    windowed = n(port_gather([t(f) for f in fs], t(bx), p, impl="windowed")).reshape(want.shape)
    assert np.abs(windowed - want).max() > 1e-2 * scale


@pytest.mark.parametrize("p", [7, 14])
def test_gather_pooler_gradient_matches_jax_grad(p):
    fs, bx = feats(), boxes()
    g = np.random.default_rng(1).normal(size=(B, bx.shape[1], p, p, C)).astype(np.float32)
    loss = lambda f: jnp.sum(jax_gather(f, jnp.asarray(bx), p) * g)
    want = jax.jit(jax.grad(loss))([jnp.asarray(f) for f in fs])
    leaves = [t(f).requires_grad_() for f in fs]
    (port_gather(leaves, t(bx), p).reshape(g.shape) * t(g)).sum().backward()
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for lvl, (leaf, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(w), atol=1e-5 * scale, rtol=0, err_msg=f"P{lvl + 2}")


def mask_and_boxes():
    rng = np.random.default_rng(2)
    m = np.zeros((3, 40, 56), np.float32)
    m[0, 5:30, 8:44] = 1.0
    m[1] = rng.uniform(size=(40, 56)) > 0.5
    m[2, 10:, :20] = 1.0
    bx = np.array([[4.0, 3.0, 46.0, 31.0], [-6.0, -4.0, 20.0, 50.0], [10.5, 7.25, 11.5, 7.75],
                   [30.0, 20.0, 70.0, 45.0], [0.0, 0.0, 56.0, 40.0], [12.0, 9.0, 12.0, 30.0]], np.float32)
    return m, bx


@pytest.mark.parametrize("bitmask", [False, True], ids=["float32", "bool"])
def test_whole_map_roi_align_matches_jax_at_one_channel(bitmask):
    m, bx = mask_and_boxes()
    maps = t(m[..., None] > 0.5) if bitmask else t(m[..., None])  # a bool map reads as 0 / 1
    one_map = torch.zeros(len(bx), dtype=torch.int64)
    for i in range(len(m)):
        args = (jnp.asarray(m[i][..., None]), jnp.asarray(bx))
        eager = np.asarray(jra.roi_align(*args, 28, 1.0, 2))
        fused = np.asarray(jax.jit(lambda f, b: jra.roi_align(f, b, 28, 1.0, 2))(*args))
        got = n(tra.roi_align_maps(maps[i:i + 1], one_map, t(bx), 28, 1.0, 2))
        # bit-equal to JAX's op as written; XLA's fusion of it rounds a few values ulps apart
        np.testing.assert_array_equal(got, eager, err_msg=f"map {i}")
        np.testing.assert_allclose(got, fused, atol=1e-5, rtol=0, err_msg=f"map {i}")
    # many maps: box r on map map_idx[r], read where the taps lie
    idx = np.array([2, 0, 1, 1, 0, 2])
    got = tra.roi_align_maps(maps, t(idx), t(bx), 28, 1.0, 2)
    for r in range(len(bx)):
        one = tra.roi_align_maps(maps[idx[r]:idx[r] + 1], one_map[:1], t(bx[r:r + 1]), 28, 1.0, 2)
        assert torch.equal(got[r:r + 1], one), r


CASCADE_BASE = dict(num_classes=1, cls_agnostic_bbox_reg=True, fc_dim=16)


@pytest.fixture(scope="module")
def cascade():
    jcfg = jcascade.CascadeConfig(base=jroi.ROIHeadsConfig(**CASCADE_BASE))
    jm = jcascade.CascadeROIHeads(config=jcfg)
    fs = {lvl: jnp.asarray(f) for lvl, f in zip(LEVELS, feats())}
    strides = dict(zip(LEVELS, STRIDES))
    bx = jnp.asarray(boxes())
    variables = random_variables(lambda: jm.init(jax.random.key(0), fs, bx, strides, HW), 3,
                                 {"bbox_pred": 0.05, "cls_score": 0.05})
    tm = tcascade.CascadeROIHeads(tcascade.CascadeConfig(base=troi.ROIHeadsConfig(**CASCADE_BASE)), C, device="cpu")
    tm.load_state_dict(flax_to_state_dict(variables))
    return jm, variables, tm, strides


def weights(shape_scores, shape_boxes):
    rng = np.random.default_rng(4)
    return (rng.normal(size=shape_scores).astype(np.float32), rng.normal(size=shape_boxes).astype(np.float32))


def test_cascade_matches_jax(cascade):
    jm, variables, tm, strides = cascade
    fs, bx = feats(), boxes()
    want_s, want_b = jax.jit(lambda v, f, b: jm.apply(v, f, b, strides, HW))(
        to_jax(variables), {lvl: jnp.asarray(f) for lvl, f in zip(LEVELS, fs)}, jnp.asarray(bx))
    with torch.no_grad():
        got_s, got_b = tm({lvl: t(f) for lvl, f in zip(LEVELS, fs)}, t(bx), strides, HW)
    assert got_s.shape == (B, bx.shape[1], 2) and got_b.shape == bx.shape
    np.testing.assert_allclose(n(got_s), np.asarray(want_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(got_b), np.asarray(want_b), atol=1e-3, rtol=0)  # pixels
    assert n(got_b).min() >= 0.0 and np.abs(n(got_b) - bx).max() > 1e-3  # clipped, and moved


def test_cascade_parameter_gradients_match_jax(cascade):
    jm, variables, tm, strides = cascade
    fs, bx = feats(), boxes()
    ws, wb = weights((B, bx.shape[1], 2), bx.shape)
    jfeats = {lvl: jnp.asarray(f) for lvl, f in zip(LEVELS, fs)}

    def loss(params):
        s, b = jm.apply({"params": params}, jfeats, jnp.asarray(bx), strides, HW)
        return jnp.sum(s * ws) + jnp.sum(b * wb) * 1e-2

    want = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(to_jax(variables["params"])))})
    tm.zero_grad()
    s, b = tm({lvl: t(f) for lvl, f in zip(LEVELS, fs)}, t(bx), strides, HW)
    ((s * t(ws)).sum() + (b * t(wb)).sum() * 1e-2).backward()
    got = {name: p.grad for name, p in tm.named_parameters()}
    assert set(got) == set(want)
    # the earlier stages' box regressors: no gradient reaches them, the boxes they refine being cut
    # from the graph (JAX's zeros, the port's None)
    cut = {f"predictor{s}.bbox_pred.{k}" for s in (0, 1) for k in ("weight", "bias")}
    for name, w in want.items():
        if name in cut:
            assert float(w.abs().max()) == 0.0 and got[name] is None, name
            continue
        scale = max(float(w.abs().max()), 1e-6)
        np.testing.assert_allclose(n(got[name]), n(w), atol=1e-4 * scale, rtol=0, err_msg=name)


def iou_pairs():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, size=(64, 2))
    wh = rng.uniform(1, 40, size=(64, 2))
    a = np.concatenate([xy, xy + wh], -1)
    b = a + rng.normal(0, 8, size=a.shape)
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 0.5)
    fixed_a = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 10], [5, 5, 5, 9], [0, 0, 4, 4]], float)
    fixed_b = np.array([[2, 2, 8, 8], [20, 20, 30, 30], [10, 0, 20, 10], [0, 0, 10, 10], [0, 0, 4, 4]], float)
    return (np.concatenate([a, fixed_a]).astype(np.float32), np.concatenate([b, fixed_b]).astype(np.float32))


@pytest.mark.parametrize("name", ["giou_loss", "diou_loss", "ciou_loss"])
def test_iou_losses_match_jax(name):
    a, b = iou_pairs()
    want = np.asarray(jax.jit(getattr(jboxes, name))(jnp.asarray(a), jnp.asarray(b)))
    got = n(getattr(tboxes, name)(t(a), t(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    # the gradient too: CIoU's alpha is a constant of it in both, and ties (touching or zero-area boxes)
    # split as jnp.maximum splits them
    gw = jax.jit(jax.grad(lambda p: jnp.sum(getattr(jboxes, name)(p, jnp.asarray(b)))))(jnp.asarray(a))
    pa = t(a).requires_grad_()
    getattr(tboxes, name)(pa, t(b)).sum().backward()
    np.testing.assert_allclose(n(pa.grad), np.asarray(gw), atol=1e-5, rtol=1e-4)
