"""Port parity of the landmark trainer's data-side pieces: losses, PCK, targets, the rotated crop,
the training transform and the batch order.

Each test feeds numpy-seeded inputs (and, for the transform, JAX's own
random draws) to the JAX function and to its port on the CPU:

* ``joints_mse_loss`` / ``joints_ohkm_mse_loss``: 1e-6 relative (float32
  sums in another order);
* ``pck_accuracy``: equal, -1 where a joint has no ground truth;
* ``generate_target``: within 1e-7 (the same float32 exp), weights equal,
  joints across and beyond every edge of the map and invisible ones;
* the rotated crop against ``affine_warp`` (the JAX gather path) at
  rotations up to 60 degrees with taps off the frame: bit-equal on equal
  matrices; through each package's matrix, 1e-3 grey (see
  :func:`assert_crops_close` for pixels whose taps straddle the frame's edge);
* ``device_transform`` with the half-body crop on: crops as above,
  targets 1e-6, target weights equal;
* ``index_iterator``: the same order, index for index.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.data import landmark_dataset as jld
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo, heatmap as jhm, warp as jwarp
from spacecraft_pose_estimation_tpu.pipeline import IMAGENET_STD
from spacecraft_pose_estimation_tpu.train import accuracy as jacc, loss as jloss
from spacecraft_pose_estimation_tpu_torch.data import landmark_dataset as tld
from spacecraft_pose_estimation_tpu_torch.ops import geometry as tgeo, heatmap as thm, warp as twarp
from spacecraft_pose_estimation_tpu_torch.train import accuracy as tacc, landmark_loop, loss as tloss

from torch_port_util import n, smooth_frames, t

B, J, IMG, HM = 4, 11, (64, 64), (16, 16)


def assert_crops_close(got, want, M_got, M_want, frame_hw, grey=1e-3):
    """Crops within ``grey`` wherever a pixel's four taps lie all in or all
    off the frame. Where they straddle its edge, the zeroed taps make the
    crop step with position at up to 255 grey a pixel, and the two
    packages' matrices differ by an ulp of float32 cos/sin: there the bar is
    255 grey times the largest tap displacement the matrices' difference
    gives (a few 1e-6 px). The warp itself is bit-equal on equal matrices
    (``test_rotated_crop_matches_affine_warp``)."""
    h, w = frame_hw
    out_h, out_w = want.shape[1:3]
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    sx = M_want[:, 0, 0, None, None] * xs + M_want[:, 0, 1, None, None] * ys + M_want[:, 0, 2, None, None]
    sy = M_want[:, 1, 0, None, None] * xs + M_want[:, 1, 1, None, None] * ys + M_want[:, 1, 2, None, None]
    x0, y0 = np.floor(sx), np.floor(sy)
    inside = [(x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h) for dy in (0, 1) for dx in (0, 1)]
    straddle = np.any(inside, axis=0) & ~np.all(inside, axis=0)
    dm = np.abs(M_got.astype(np.float64) - M_want).max(axis=0)
    shift = dm[:, 0] * out_w + dm[:, 1] * out_h + dm[:, 2]  # (2,): the largest tap displacement, x and y
    err = np.abs(got - want).max(-1)
    assert err[~straddle].max() <= grey, err[~straddle].max()
    assert err[straddle].max(initial=0.0) <= 255.0 * shift.sum() + grey, (err[straddle].max(), shift)
    return int(straddle.sum())


@pytest.mark.parametrize("weighted", [True, False], ids=["target_weight", "no_weight"])
def test_losses_match_jax(weighted):
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(B, *HM, J)).astype(np.float32) for _ in range(2))
    tw = (rng.uniform(size=(B, J)) > 0.3).astype(np.float32) if weighted else None
    tw_t = None if tw is None else t(tw)
    for jfn, tfn in ((jloss.joints_mse_loss, tloss.joints_mse_loss),
                     (lambda *a: jloss.joints_ohkm_mse_loss(*a, topk=8),
                      lambda *a: tloss.joints_ohkm_mse_loss(*a, topk=8))):
        want = float(jfn(jnp.asarray(pred), jnp.asarray(target), None if tw is None else jnp.asarray(tw)))
        got = float(tfn(t(pred), t(target), tw_t))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # bf16 predictions are reduced in float32 on both sides
    pb = t(pred).to(torch.bfloat16)
    want = float(jloss.joints_mse_loss(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target)))
    np.testing.assert_allclose(float(tloss.joints_mse_loss(pb, t(target))), want, rtol=1e-6)


def test_generate_target_and_pck_match_jax():
    rng = np.random.default_rng(1)
    # joints inside, near and beyond every edge of the 64x64 input (16x16 map, 3-sigma box of 6)
    joints = rng.uniform(-40, 104, size=(B, J, 2)).astype(np.float32)
    joints[0, :4] = [[-27.9, 30.0], [91.9, 30.0], [30.0, -28.1], [30.0, 92.1]]
    joints[1, :4] = [[-26.0, 30.0], [89.9, 30.0], [30.0, -25.9], [30.0, 90.0]]
    vis = (rng.uniform(size=(B, J)) > 0.2).astype(np.float32)
    vis[0, :4] = vis[1, :4] = 1.0
    vis[2] = 0.0  # one example with no visible joint
    want_t, want_w = jax.vmap(lambda a, b: jhm.generate_target(a, b, IMG, HM, 2.0))(joints, vis)
    got_t, got_w = thm.generate_target(t(joints), t(vis), IMG, HM, 2.0)
    assert got_t.shape == (B, *HM, J) and got_t.dtype == torch.float32
    np.testing.assert_array_equal(n(got_w), np.asarray(want_w))
    np.testing.assert_allclose(n(got_t), np.asarray(want_t), atol=1e-7)
    assert 0 < n(got_w).sum() < B * J  # some joints fall off the map, some stay
    assert np.all(n(got_t)[2] == 0)
    # PCK on noisy predictions, with the -1 of joints that have no GT anywhere
    pred = np.asarray(want_t) + rng.normal(0, 0.3, size=want_t.shape).astype(np.float32)
    want_acc, want_mean = jacc.pck_accuracy(jnp.asarray(pred), want_t)
    got_acc, got_mean = tacc.pck_accuracy(t(pred), got_t)
    np.testing.assert_array_equal(n(got_acc), np.asarray(want_acc))
    assert float(got_mean) == pytest.approx(float(want_mean), rel=1e-6)
    assert -1.0 in n(got_acc)


def test_rotated_crop_matches_affine_warp():
    """The rotated crop against the JAX gather path, boxes partly off the
    frame so that taps fall outside it, rotations up to 60 degrees."""
    frames = smooth_frames(2, B * 2, 48, 80)
    rng = np.random.default_rng(3)
    centers = np.concatenate([rng.uniform(0, 80, (B, 2)), [[0, 0], [80, 48], [-5, 20], [40, 24]]]).astype(np.float32)
    scales = np.concatenate([rng.uniform(0.1, 0.4, (B, 2)), [[0.3, 0.3], [0.2, 0.2], [0.5, 0.5], [0.05, 0.05]]])
    scales = scales.astype(np.float32)
    rots = np.array([-60, -37.5, 0, 12.25, 60, 45, -90 / 2, 59.9], np.float32)
    want = np.asarray(jwarp.batched_crop_and_resize(jnp.asarray(frames), centers, scales, rots, (40, 32),
                                                   method="gather"))
    got = twarp.rotated_crop_and_resize(t(frames), t(centers), t(scales), t(rots), (40, 32))
    assert got.shape == (8, 32, 40, 3) and got.dtype == torch.float32
    M = np.asarray(jax.vmap(lambda c, s, r: jgeo.crop_affine_matrix(c, s, r, (40, 32), inv=True))(
        centers, scales, rots))
    M_t = n(tgeo.crop_affine_matrix(t(centers), t(scales), t(rots), (40, 32), inv=True))
    np.testing.assert_allclose(M_t, M, atol=1e-5)
    edge = assert_crops_close(n(got), want, M_t, M, frames.shape[1:3])
    assert edge > 0 and (want == 0).all(-1).any(axis=(1, 2)).sum() >= 3  # taps off the frame, zeroed
    # the warp itself is bit-equal on equal matrices
    want = np.asarray(jax.vmap(lambda im, m: jwarp.affine_warp(im, m, (40, 32)))(jnp.asarray(frames), M))
    np.testing.assert_array_equal(n(twarp.affine_warp(t(frames), t(M), (40, 32))), want)


def jax_draws(key, b, sf, rf):
    """The draws JAX's device_transform makes from ``key`` (half-body on)."""
    key, hb_key = jax.random.split(key)
    k1, k2 = jax.random.split(hb_key)
    s_mult, rots = jld.sample_augmentation(key, b, sf, rf)
    return {"hb_uniform": t(jax.random.uniform(k1, (b,))), "hb_coin": t(jax.random.normal(k2, (b,))),
            "s_mult": t(s_mult), "rots": t(rots)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_transform_matches_jax(seed):
    b = 6
    frames = smooth_frames(10 + seed, b, 72, 96)
    rng = np.random.default_rng(20 + seed)
    bboxes = np.concatenate([rng.uniform(0, 40, (b, 2)), rng.uniform(20, 50, (b, 2))], 1).astype(np.float32)
    joints = (bboxes[:, None, :2] + rng.uniform(0, 1, (b, J, 2)) * bboxes[:, None, 2:]).astype(np.float32)
    vis = (rng.uniform(size=(b, J)) > 0.15).astype(np.float32)
    kw = dict(image_size=IMG, heatmap_size=HM, sigma=2.0, train=True, scale_factor=0.25, rot_factor=30.0,
              upper_body_ids=(0, 1, 2, 3, 4), num_joints_half_body=3, prob_half_body=0.5)
    key = jax.random.key(seed)
    want = jld.device_transform(jnp.asarray(frames), bboxes, joints, vis, key, **kw)
    got = tld.device_transform(t(frames), t(bboxes), t(joints), t(vis),
                               draws=jax_draws(key, b, 0.25, 30.0), **kw)
    for k in ("centers", "scales", "rotations"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    grey = np.asarray(IMAGENET_STD, np.float32) * 255.0
    M_want = np.asarray(jax.vmap(lambda c, s, r: jgeo.crop_affine_matrix(c, s, r, IMG, inv=True))(
        want["centers"], want["scales"], want["rotations"]))
    M_got = n(tgeo.crop_affine_matrix(got["centers"], got["scales"], got["rotations"], IMG, inv=True))
    assert_crops_close(n(got["image"]) * grey, np.asarray(want["image"]) * grey, M_got, M_want, frames.shape[1:3])
    np.testing.assert_allclose(n(got["target"]), np.asarray(want["target"]), atol=1e-6)
    np.testing.assert_array_equal(n(got["target_weight"]), np.asarray(want["target_weight"]))
    # the half-body crop replaced some boxes and kept others
    bbox_centers = bboxes[:, :2] + bboxes[:, 2:] / 2
    replaced = ~np.isclose(np.asarray(want["centers"]), bbox_centers, rtol=1e-6).all(1)
    print("half-body crops", replaced.tolist())
    assert 0 < replaced.sum() < b


def test_eval_transform_has_no_draws():
    frames = smooth_frames(5, 2, 48, 64)
    bboxes = np.array([[8, 6, 30, 24], [20, 10, 40, 30]], np.float32)
    joints = np.random.default_rng(6).uniform(10, 40, (2, J, 2)).astype(np.float32)
    vis = np.ones((2, J), np.float32)
    kw = dict(image_size=IMG, heatmap_size=HM, sigma=2.0, train=False)
    want = jld.device_transform(jnp.asarray(frames), bboxes, joints, vis, jax.random.key(0), **kw)
    got = tld.device_transform(t(frames), t(bboxes), t(joints), t(vis), **kw)
    np.testing.assert_allclose(n(got["image"]), np.asarray(want["image"]), atol=1e-3 / 58.0)
    np.testing.assert_allclose(n(got["target"]), np.asarray(want["target"]), atol=1e-6)


@pytest.mark.parametrize("shuffle", [True, False])
def test_index_iterator_matches_jax(shuffle):
    want = jld.index_iterator(23, 4, shuffle=shuffle, seed=7)
    got = tld.index_iterator(23, 4, shuffle=shuffle, seed=7)
    for _ in range(3 * (23 // 4)):  # three passes
        np.testing.assert_array_equal(next(got), next(want))
    one = list(tld.index_iterator(10, 3, seed=1, loop=False))
    assert len(one) == 3 and all(len(i) == 3 for i in one)


def test_augmentation_stream_is_reproducible():
    """The port's draws are its own (not ``jax.random``'s): one seed gives one
    stream, and step ``s`` of a resumed run draws what step ``s`` of an
    uninterrupted run drew."""
    a = tld.sample_draws(landmark_loop.step_generator(1, 5), 8, 0.25, 30.0, half_body=True)
    b = tld.sample_draws(landmark_loop.step_generator(1, 5), 8, 0.25, 30.0, half_body=True)
    c = tld.sample_draws(landmark_loop.step_generator(1, 6), 8, 0.25, 30.0, half_body=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rots"], c["rots"])
    s, r = a["s_mult"], a["rots"]
    assert ((s >= 0.75) & (s <= 1.25)).all() and ((r >= -60) & (r <= 60)).all()
    assert (r == 0).any() or len(r) < 4  # applied with probability 0.6


def test_batch_iterator_order_and_parallel_decode(tmp_path):
    """Whole batches in ``index_iterator``'s order, the same from the thread
    pool as decoded in the calling thread, and the device cache's gather
    equal to them."""
    from spacecraft_pose_estimation_tpu_torch.data import coco_io
    from spacecraft_pose_estimation_tpu_torch.train.metrics import JSONWriter, MetricStorage, TensorboardWriter

    frames = smooth_frames(7, 10, 24, 32)
    names = [f"img{i:06d}.png" for i in range(10)]
    rng = np.random.default_rng(8)
    anns = [coco_io.keypoint_annotation(np.concatenate([rng.uniform(0, 24, (J, 2)), np.full((J, 1), 2.0)], 1),
                                        [2.0, 3.0, 20.0, 15.0], i, i) for i in range(10)]
    coco_io.save_coco(coco_io.build_coco_dict([coco_io.image_record(nm, 32, 24, i) for i, nm in enumerate(names)],
                                              anns, J), str(tmp_path / "a.json"))
    ex = tld.LandmarkExamples(str(tmp_path / "a.json"), frames=dict(zip(names, frames)))
    serial = tld.batch_iterator(ex, 3, seed=4, num_workers=0)
    pooled = tld.batch_iterator(ex, 3, seed=4, num_workers=3, prefetch=2)
    order = tld.index_iterator(10, 3, seed=4)
    cache = tld.DeviceDatasetCache(ex, "cpu")
    assert cache.nbytes == frames.nbytes
    for _ in range(7):  # past the end of a pass
        a, b, idx = next(serial), next(pooled), next(order)
        np.testing.assert_array_equal(a["image_id"], idx)
        for k in ("image", "bbox", "joints", "joints_vis"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["image"], frames[idx][..., ::-1])  # RGB
        for got, want in zip(cache.gather(idx), (a["image"], a["bbox"], a["joints"], a["joints_vis"])):
            np.testing.assert_array_equal(n(got), want)
    # a resumed stream starts at its batch
    resumed, whole = tld.index_iterator(10, 3, seed=4, start=5), tld.index_iterator(10, 3, seed=4)
    for _ in range(5):
        next(whole)
    for _ in range(4):
        np.testing.assert_array_equal(next(resumed), next(whole))
    # the metric writers: JSON lines; tensorboardX absent or present, no error
    storage = MetricStorage()
    storage.step = 3
    storage.put_scalars(loss=0.5, acc=0.25)
    w = JSONWriter(str(tmp_path / "m" / "metrics.json"))
    w.write(storage)
    w.close()
    tb = TensorboardWriter(str(tmp_path / "tb"))
    tb.write(storage)
    tb.close()
    import json

    assert json.loads((tmp_path / "m" / "metrics.json").read_text()) == {"iteration": 3, "loss": 0.5, "acc": 0.25}
