"""Port parity of ``data/lvis_panoptic.py`` (LVIS AP, panoptic quality)
and ``data/coco_eval.evaluate_semantic_segmentation`` on the CPU against
the JAX package.

Every case of ``tests/test_lvis_panoptic.py`` (the LVIS ignore rule, the
cap across categories, the frequency bins; PQ with void, crowd, category
mismatch and the thing / stuff split) and seeded scenes (LVIS: 6 images,
5 categories, negative categories, jittered detections; PQ: 4 images of
random rectangles; semantic segmentation: 4 label maps with ignored
pixels) go through both packages: every entry equal within 1e-12 (the same
float64 arithmetic), NaN where JAX gives NaN.
"""

import numpy as np
import pytest

from spacecraft_pose_estimation_tpu.data import coco_eval as jce
from spacecraft_pose_estimation_tpu.data import lvis_panoptic as jlp
from spacecraft_pose_estimation_tpu_torch.data import coco_eval as tce
from spacecraft_pose_estimation_tpu_torch.data import lvis_panoptic as tlp


def _box(x, y, w, h):
    return [x, y, x + w, y + h]


def _image(assignments, shape=(10, 10)):
    m = np.zeros(shape, np.int32)
    for sid, (r0, r1, c0, c1) in assignments.items():
        m[r0:r1, c0:c1] = sid
    return m


def lvis_scene(seed, n_images=6, cats=5):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for i in range(n_images):
        g = int(rng.integers(1, 5))
        xy = rng.uniform(0, 300, (g, 2))
        wh = rng.choice([20.0, 60.0, 150.0], (g, 1)) * rng.uniform(0.7, 1.3, (g, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gc = rng.integers(1, cats + 1, g)
        k = int(rng.integers(0, 8))
        src = rng.integers(0, g, k)
        db = gb[src] + rng.normal(0, 6, (k, 4))
        dc = np.where(rng.uniform(size=k) < 0.8, gc[src], rng.integers(1, cats + 1, k))
        gt = {"boxes": gb, "classes": gc}
        if i % 2:
            gt["neg_classes"] = [int(c) for c in rng.choice(np.arange(1, cats + 1), 2, replace=False)
                                 if c not in gc]
        dets.append({"boxes": db, "scores": rng.uniform(size=k), "classes": dc})
        gts.append(gt)
    return dets, gts


def _lvis_cases():
    cases = {
        "perfect": ([{"boxes": [_box(0, 0, 50, 50)], "scores": [0.9], "classes": [1]}],
                    [{"boxes": [_box(0, 0, 50, 50)], "classes": [1]}], {}),
        "max_dets_cap": ([{"boxes": [_box(100, 100, 10, 10), _box(0, 0, 50, 50)], "scores": [0.9, 0.8],
                           "classes": [1, 1]}], [{"boxes": [_box(0, 0, 50, 50)], "classes": [1]}], {"max_dets": 1}),
        "frequency_bins": ([{"boxes": [_box(0, 0, 50, 50), _box(60, 0, 50, 50)], "scores": [0.9, 0.9],
                             "classes": [1, 2]}],
                           [{"boxes": [_box(0, 0, 50, 50), _box(60, 0, 50, 50), _box(0, 60, 50, 50)],
                             "classes": [1, 2, 3]}], {"category_image_counts": {1: 5, 2: 50, 3: 500}}),
    }
    ignore_dets = [{"boxes": [_box(0, 0, 50, 50)], "scores": [0.9], "classes": [2]},
                   {"boxes": [_box(0, 0, 50, 50), _box(60, 60, 20, 20)], "scores": [0.8, 0.7], "classes": [2, 2]}]
    ignore_gts = [{"boxes": [_box(0, 0, 40, 40)], "classes": [7]}, {"boxes": [_box(0, 0, 50, 50)], "classes": [2]}]
    cases["not_exhaustive_ignored"] = (ignore_dets, ignore_gts, {})
    cases["verified_absent"] = (ignore_dets, [dict(ignore_gts[0], neg_classes=[2]), ignore_gts[1]], {})
    for seed in (0, 1):
        dets, gts = lvis_scene(seed)
        cases[f"scene{seed}"] = (dets, gts, {"category_image_counts": {1: 3, 2: 40, 3: 400, 4: 10, 5: 101}})
        cases[f"scene{seed}_cap3"] = (dets, gts, {"max_dets": 3})
    return cases


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", sorted(_lvis_cases()))
def test_evaluate_lvis_matches_jax(name):
    dets, gts, kw = _lvis_cases()[name]
    _assert_same(tlp.evaluate_lvis(dets, gts, **kw), jlp.evaluate_lvis(dets, gts, **kw))


def test_frequency_bins_match_jax():
    counts = {1: 0, 2: 10, 3: 11, 4: 100, 5: 101, 6: 5000}
    assert tlp.lvis_frequency_bins(counts) == jlp.lvis_frequency_bins(counts)


def panoptic_scene(seed, n_images=4):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_images):
        out = []
        for crowd in (True, False):
            k = int(rng.integers(2, 6))
            assign, segs = {}, []
            for sid in range(1, k + 1):
                r0, c0 = (int(v) for v in rng.integers(0, 16, 2))
                assign[sid] = (r0, r0 + int(rng.integers(3, 10)), c0, c0 + int(rng.integers(3, 10)))
                seg = {"id": sid, "category": int(rng.integers(1, 4))}
                if crowd and rng.uniform() < 0.2:
                    seg["iscrowd"] = 1
                segs.append(seg)
            out.append((_image(assign, (20, 20)), segs))
        gts.append(out[0])
        preds.append(out[1])
    return preds, gts


def _panoptic_cases():
    m = _image({1: (0, 5, 0, 10), 2: (5, 10, 0, 10)})
    segs = [{"id": 1, "category": 10}, {"id": 2, "category": 20}]
    gt4 = _image({1: (0, 4, 0, 10)})
    cases = {
        "perfect": ([(m, segs)], [(m, segs)], {}),
        "partial": ([(_image({4: (0, 5, 0, 10)}), [{"id": 4, "category": 3}])],
                    [(_image({1: (0, 6, 0, 10)}), [{"id": 1, "category": 3}])], {}),
        "void_union": ([(_image({9: (0, 10, 0, 10)}), [{"id": 9, "category": 3}])],
                       [(_image({1: (0, 5, 0, 10)}), [{"id": 1, "category": 3}])], {}),
        "mismatch": ([(_image({1: (0, 10, 0, 10)}), [{"id": 1, "category": 5}])],
                     [(_image({1: (0, 10, 0, 10)}), [{"id": 1, "category": 6}])], {}),
        "mostly_void": ([(_image({2: (0, 10, 0, 10)}), [{"id": 2, "category": 4}])],
                        [(gt4, [{"id": 1, "category": 3}])], {}),
        "less_void": ([(_image({2: (0, 6, 0, 10)}), [{"id": 2, "category": 4}])],
                      [(gt4, [{"id": 1, "category": 3}])], {}),
        "crowd": ([(_image({2: (0, 10, 0, 10)}), [{"id": 2, "category": 3}])],
                  [(_image({1: (0, 10, 0, 10)}), [{"id": 1, "category": 3, "iscrowd": 1}])], {}),
        "thing_stuff": ([(_image({1: (0, 5, 0, 10)}), [{"id": 1, "category": 1}])],
                        [(_image({1: (0, 5, 0, 10), 2: (5, 10, 0, 10)}),
                          [{"id": 1, "category": 1}, {"id": 2, "category": 2}])], {"thing_categories": {1}}),
    }
    for seed in (0, 1):
        preds, gts = panoptic_scene(seed)
        cases[f"scene{seed}"] = (preds, gts, {"thing_categories": {1, 2}})
    return cases


@pytest.mark.parametrize("name", sorted(_panoptic_cases()))
def test_evaluate_panoptic_matches_jax(name):
    preds, gts, kw = _panoptic_cases()[name]
    _assert_same(tlp.evaluate_panoptic(preds, gts, **kw), jlp.evaluate_panoptic(preds, gts, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_semantic_segmentation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    classes = 6
    gts = [rng.integers(0, classes - 1, (24, 32)) for _ in range(4)]  # the last class never in the GT
    for g in gts:
        g[rng.uniform(size=g.shape) < 0.1] = 255
    preds = [np.where(rng.uniform(size=g.shape) < 0.7, np.where(g == 255, 0, g), rng.integers(0, classes, g.shape))
             for g in gts]
    got = tce.evaluate_semantic_segmentation(preds, gts, classes)
    _assert_same(got, jce.evaluate_semantic_segmentation(preds, gts, classes))
    assert 0 < got["mIoU"] < 100
