"""Port parity: the single-level windowed ROIAlign (kernel K3's plain version)
against the JAX ``roi_align_pallas`` (interpret mode on the CPU, as
``tests/test_pallas_pooler.py`` runs it) and, where the read window covers
every box, against ``roi_align_windowed``.

Tolerance 1e-4 on unit-scale features, as ``test_torch_pooler.py`` holds
K2: the same bilinear weights summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.ops.pallas_pooler import roi_align_pallas
from spacecraft_pose_estimation_tpu.ops.roi_align import roi_align_windowed
from spacecraft_pose_estimation_tpu_torch.ops import roi_align as troi

from torch_port_util import n, t


def boxes_in(rng, r, lo, hi, x_max, y_max):
    """r boxes of side lo..hi (image pixels) with top-left corners in
    [0, x_max) x [0, y_max)."""
    xy = rng.uniform(0, 1, (r, 2)) * [x_max, y_max]
    wh = rng.uniform(lo, hi, (r, 1)) * rng.uniform(0.8, 1.25, (r, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def border_boxes(rng, h, w, scale):
    """Boxes touching or crossing the right and bottom borders of the map."""
    img_h, img_w = h / scale, w / scale
    x0 = rng.uniform(img_w * 0.6, img_w - 4, 6)
    y0 = rng.uniform(img_h * 0.6, img_h - 4, 6)
    side = rng.uniform(8, 40, 6)
    return np.stack([x0, y0, np.minimum(x0 + side, img_w) + [0, 0, 3, 3, 0, 5],
                     np.minimum(y0 + side, img_h) + [0, 3, 0, 3, 6, 0]], 1).astype(np.float32)


# name: (H, W, C, spatial_scale, window, boxes(rng), windowed covers every box)
CASES = {
    "narrow-map": (20, 36, 8, 0.25, 48, lambda rng: boxes_in(rng, 8, 10, 60, 80, 40), True),
    "right-bottom-borders": (48, 64, 8, 0.25, 32, lambda rng: border_boxes(rng, 48, 64, 0.25), True),
    "boxes-over-the-window": (96, 112, 8, 0.25, 16, lambda rng: boxes_in(rng, 8, 80, 200, 200, 160), False),
    "scale-0.3": (40, 56, 8, 0.3, 32, lambda rng: boxes_in(rng, 8, 10, 60, 120, 90), True),
    "scale-1/12": (30, 44, 8, 1.0 / 12, 24, lambda rng: boxes_in(rng, 8, 30, 200, 300, 200), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_roi_align_pallas(case):
    h, w, c, scale, window, make_boxes, covered = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    feat = rng.normal(size=(h, w, c)).astype(np.float32)
    boxes = make_boxes(rng)
    want = np.asarray(roi_align_pallas(jnp.asarray(feat), jnp.asarray(boxes), 7, scale, 2, window))
    got = troi.roi_align_single(t(feat), t(boxes), 7, scale, 2, window)
    assert got.dtype == torch.float32 and got.shape == (boxes.shape[0], 7, 7, c)
    np.testing.assert_allclose(n(got), want, atol=1e-4)
    if covered:  # both windows hold every box: both are exact ROIAlign
        exact = np.asarray(roi_align_windowed(jnp.asarray(feat), jnp.asarray(boxes), 7, scale, 2, window + 16))
        np.testing.assert_allclose(n(got), exact, atol=1e-4)
    else:  # the window cuts these boxes: the answer is the window's, not ROIAlign's
        exact = np.asarray(roi_align_windowed(jnp.asarray(feat), jnp.asarray(boxes), 7, scale, 2, 64))
        assert np.abs(n(got) - exact).max() > 1e-2


def test_bf16_features():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(48, 56, 16)).astype(np.float32)
    boxes = boxes_in(rng, 10, 16, 80, 150, 120)
    feat_bf16 = jnp.asarray(feat, jnp.bfloat16)
    want = np.asarray(roi_align_pallas(feat_bf16, jnp.asarray(boxes), 7, 0.25, 2, 32))
    got = troi.roi_align_single(t(feat).to(torch.bfloat16), t(boxes), 7, 0.25, 2, 32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, atol=1e-4)


def test_single_level_taps_match_k2_at_one_level():
    """On a map at least as large as the window, K3 at spatial_scale 1 / stride
    reads what K2 reads for a box of that level."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(1, 64, 64, 8)).astype(np.float32)
    boxes = boxes_in(rng, 6, 40, 100, 300, 300)
    levels = troi.assign_levels(t(boxes), 1, 3)
    assert (levels == 0).all()
    got = troi.roi_align_single(t(feat[0]), t(boxes), 7, 1 / 8, 2, 48)
    with pytest.warns(UserWarning, match="cannot cover"):  # K2's check for the level's largest boxes
        want = troi.roi_align_multilevel([t(feat)], t(boxes), torch.zeros(6, dtype=torch.int32), 7, (8,), 2, 48)
    np.testing.assert_array_equal(n(got), n(want))


def test_launches_or_raises_off_the_cpu():
    """A tensor on neither the CPU nor CUDA never reaches the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        troi.roi_align_single(torch.zeros(8, 8, 4, device=meta), torch.zeros(2, 4, device=meta), 7, 0.25)
