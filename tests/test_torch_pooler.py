"""Port parity: ops/roi_align (kernel K2's plain version) against the JAX poolers.

The JAX reference is ``multilevel_roi_align_pallas`` (interpret mode on
the CPU) and, where the window covers every box, the exact gather
ROIAlign. Tolerance 1e-4 on unit-scale features: the same bilinear
weights summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops.pallas_pooler import multilevel_roi_align_pallas
from spacecraft_pose_estimation_tpu.ops.roi_align import multilevel_roi_align
from spacecraft_pose_estimation_tpu_torch.ops import roi_align as troi

from torch_port_util import n, t

STRIDES = (4, 8, 16, 32)


def _feats(rng, b, size, c):
    return [rng.normal(size=(b, size // s, size // s, c)).astype(np.float32) for s in STRIDES]


def _boxes(rng, r, size):
    xy = rng.uniform(-10, size * 0.7, (r, 2))
    s = np.exp(rng.uniform(np.log(8), np.log(size * 0.9), (r, 1)))  # every level gets boxes
    wh = s * rng.uniform(0.7, 1.4, (r, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("window", [32, 48])
def test_matches_pallas_pooler(window):
    rng = np.random.default_rng(0)
    size, b, r = 256, 2, 24
    feats = _feats(rng, b, size, 8)
    boxes = _boxes(rng, b * r, size)
    want = np.concatenate([
        np.asarray(multilevel_roi_align_pallas(
            tuple(jnp.asarray(f[i]) for f in feats), jnp.asarray(boxes[i * r:(i + 1) * r]), 7, STRIDES,
            sampling_ratio=2, window=window))
        for i in range(b)
    ])
    batch_idx = torch.arange(b, dtype=torch.int32).repeat_interleave(r)
    got = troi.roi_align_multilevel([t(f) for f in feats], t(boxes), batch_idx, 7, STRIDES, 2, window)
    np.testing.assert_allclose(n(got), want, atol=1e-4)


def test_matches_exact_roi_align_when_the_window_covers():
    rng = np.random.default_rng(1)
    size = 256
    feats = _feats(rng, 1, size, 8)
    xy = rng.uniform(0, size * 0.6, (12, 2))
    wh = rng.uniform(20, 90, (12, 1)) * rng.uniform(0.8, 1.25, (12, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    want = multilevel_roi_align([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes), 7, STRIDES,
                                impl="gather")
    got = troi.roi_align_multilevel([t(f) for f in feats], t(boxes), torch.zeros(12, dtype=torch.int32),
                                    7, STRIDES, 2, 48)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


def test_level_assignment():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 111, 113], [0, 0, 112, 112], [0, 0, 224, 224],
                      [0, 0, 448, 448], [0, 0, 2000, 2000], [5, 5, 5, 5]], np.float32)
    # floor(4 + log2(sqrt(area) / 224 + 1e-8)) clipped to p2..p5: sqrt(area)
    # 112 is exactly p3's lower edge, 111.99 stays on p2
    got = n(troi.assign_levels(t(boxes), 4, 2))
    np.testing.assert_array_equal(got, [0, 0, 1, 2, 3, 3, 0])


def test_small_top_level_and_warning():
    """Levels smaller than the window (padded by the JAX kernel) and the
    coarse-level coverage warning."""
    rng = np.random.default_rng(2)
    feats = _feats(rng, 1, 64, 4)  # p5 is 2x2, far below the window
    boxes = _boxes(rng, 10, 64)
    want = multilevel_roi_align_pallas(tuple(jnp.asarray(f[0]) for f in feats), jnp.asarray(boxes), 7,
                                       STRIDES, window=16)
    with pytest.warns(UserWarning, match="cannot cover"):
        got = troi.roi_align_multilevel([t(f) for f in feats], t(boxes), torch.zeros(10, dtype=torch.int32),
                                        7, STRIDES, 2, 8)
    got = troi.roi_align_multilevel([t(f) for f in feats], t(boxes), torch.zeros(10, dtype=torch.int32),
                                    7, STRIDES, 2, 16)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
