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


def edge_boxes(rng, h, w, scale, window):
    """Boxes on an (h, w) map at ``scale``: across each of its four edges,
    larger than the (window, window + 8) read window, and zero-area."""
    img_h, img_w = h / scale, w / scale
    big = (window + 24) / scale
    return np.array([
        [-30, 0.3 * img_h, 0.4 * img_w, 0.6 * img_h],  # left edge
        [0.2 * img_w, -25, 0.5 * img_w, 0.4 * img_h],  # top edge
        [0.7 * img_w, 0.2 * img_h, img_w + 40, 0.5 * img_h],  # right edge
        [0.3 * img_w, 0.8 * img_h, 0.6 * img_w, img_h + 35],  # bottom edge
        [-20, -20, img_w + 20, img_h + 20],  # all four
        [0.1 * img_w, 0.1 * img_h, 0.1 * img_w + big, 0.1 * img_h + big],  # over the window
        [0.5 * img_w, 0.5 * img_h, 0.5 * img_w, 0.5 * img_h + 9],  # zero width
    ], np.float32)


# name: (H, W, stride, window, boxes(rng, h, w, stride, window))
SHARED_WINDOW_CASES = {
    "64x64": (64, 64, 8, 48, lambda rng, *_: boxes_in(rng, 6, 40, 100, 300, 300)),
    "h-under-window": (20, 96, 4, 48, lambda rng, h, w, s, win: edge_boxes(rng, h, w, 1 / s, win)),
    "w-under-window-plus-8": (64, 40, 8, 48, lambda rng, h, w, s, win: edge_boxes(rng, h, w, 1 / s, win)),
    "both-under": (24, 30, 16, 32, lambda rng, h, w, s, win: edge_boxes(rng, h, w, 1 / s, win)),
    "edges-and-over-the-window": (64, 72, 4, 16, lambda rng, h, w, s, win: np.concatenate(
        [edge_boxes(rng, h, w, 1 / s, win), boxes_in(rng, 6, 40, 120, 4 * w, 4 * h)])),
}


@pytest.mark.parametrize("case", list(SHARED_WINDOW_CASES))
def test_single_level_taps_match_k2_at_one_level(case):
    """K3's shrunk window (min(window, H) x min(window + 8, W)) and K2's
    window over the level padded up to it pick the same taps at spatial
    scale 1 / stride, on maps larger and smaller than the window: the CUDA
    K3 is K2's kernel on one level."""
    h, w, stride, window, make_boxes = SHARED_WINDOW_CASES[case]
    rng = np.random.default_rng(3 + list(SHARED_WINDOW_CASES).index(case))
    feat = rng.normal(size=(1, h, w, 8)).astype(np.float32)
    boxes = make_boxes(rng, h, w, stride, window)
    lvl_min = int(np.log2(stride))
    assert (troi.assign_levels(t(boxes), 1, lvl_min) == 0).all()
    single = troi.single_taps(t(boxes), h, w, 1 / stride, 7, 2, window)
    level = troi.level_taps(t(boxes), h, w, stride, 7, 2, window)
    for a, b in zip((*single[0], *single[1]), (*level[0], *level[1])):
        np.testing.assert_array_equal(n(a), n(b))
    got = troi.roi_align_single_plain(t(feat[0]), t(boxes), 7, 1 / stride, 2, window)
    want = troi.roi_align_multilevel_plain([t(feat)], t(boxes), torch.zeros(len(boxes), dtype=torch.int32), 7,
                                           (stride,), 2, window)
    np.testing.assert_array_equal(n(got), n(want))
    assert np.abs(n(got)).max() > 0


def test_launches_or_raises_off_the_cpu():
    """A tensor on neither the CPU nor CUDA never reaches the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        troi.roi_align_single(torch.zeros(8, 8, 4, device=meta), torch.zeros(2, 4, device=meta), 7, 0.25)
