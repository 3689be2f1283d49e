"""Port parity of ``models/extra_layers.py`` (``ASPP``, ``IouTracker``) and
``models/layers.ConvSeq``, on the CPU against the JAX package.

* ``ASPP`` (8 features, dilations 2 and 4, and the DeepLab default 6, 12
  and 18 on a map smaller than the widest dilation) on seeded NHWC input,
  JAX's parameters carried by ``convert.flax_to_state_dict``: within 1e-5
  of the output's scale.
* ``ConvSeq`` (three ConvBN specs, strides 1 and 2, with and without ReLU)
  with running statistics and in train mode (batch statistics, and the
  updated running statistics): within 1e-5 of scale.
* ``IouTracker`` over seeded frames of jittered boxes, with tied IoUs
  (identical boxes, boxes moved by the same amount), objects leaving and
  coming back and tracks aged out: the ids frame by frame equal JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import extra_layers as jext
from spacecraft_pose_estimation_tpu.models import layers as jlayers
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import extra_layers as text
from spacecraft_pose_estimation_tpu_torch.models import layers as tlayers

from torch_port_util import n, random_variables, t, to_jax


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("features,dilations,hw", [(8, (2, 4), (16, 16)), (8, (6, 12, 18), (12, 20))],
                         ids=["small", "deeplab_dilations"])
def test_aspp_matches_jax(features, dilations, hw):
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    jm = jext.ASPP(features=features, dilations=dilations)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    tm = text.ASPP(5, features, dilations, device="cpu")
    tm.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(tm(t(x)))
    assert got.shape == want.shape == (2, *hw, features)
    _close(got, want)


SPECS = ((6, 3, 1, True), (8, 3, 2, True), (4, 1, 1, False))


@pytest.mark.parametrize("train", [False, True], ids=["running_stats", "batch_stats"])
def test_conv_seq_matches_jax(train):
    x = np.random.default_rng(2).normal(size=(2, 12, 12, 5)).astype(np.float32)
    jm = jlayers.ConvSeq(SPECS)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    tm = tlayers.ConvSeq(5, SPECS)
    tm.load_state_dict(flax_to_state_dict(variables))
    tm.train(train)
    if train:
        want, mutated = jm.apply(to_jax(variables), jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(n(got), np.asarray(want))
    if train:
        for i in range(len(SPECS)):
            for leaf in ("mean", "var"):
                _close(n(getattr(getattr(tm, f"seq{i}").bn, leaf)),
                       np.asarray(mutated["batch_stats"][f"seq{i}"]["bn"][leaf]))


def _frames(seed, n_frames=12):
    """Boxes a frame: objects drifting by jitter, a pair of identical boxes
    (tied IoUs), objects that leave for a few frames and come back."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([rng.uniform(0, 200, (6, 2)), rng.uniform(0, 200, (6, 2)) + 20], 1)
    base[:, 2:] = base[:, :2] + np.abs(base[:, 2:] - base[:, :2]) + 10
    base[5] = base[4]  # two identical objects: every IoU against them tied
    frames = []
    for f in range(n_frames):
        boxes = base + rng.normal(0, 2.0, base.shape) * (np.arange(6) < 4)[:, None] + f * 1.5
        keep = np.ones(6, bool)
        if 3 <= f < 6:
            keep[1] = False  # leaves for 3 frames: aged out at max_missed 2
        if f % 4 == 2:
            keep[2] = False
        frames.append(boxes[keep])
    return frames


@pytest.mark.parametrize("seed,threshold,max_missed", [(0, 0.5, 2), (1, 0.3, 0), (2, 0.7, 5)])
def test_iou_tracker_ids_match_jax(seed, threshold, max_missed):
    jt = jext.IouTracker(iou_threshold=threshold, max_missed=max_missed)
    tt = text.IouTracker(iou_threshold=threshold, max_missed=max_missed, device="cpu")
    for boxes in _frames(seed):
        assert tt.update(boxes) == jt.update(boxes)
        assert set(tt.tracks) == set(jt.tracks)
    assert tt._next_id == jt._next_id
