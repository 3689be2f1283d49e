"""Port parity of the detector's data and evaluation: ``detection_batches``,
``evaluate_detections`` and ``padded_detections_to_list``.

``detection_batches`` on 5 seeded PNG frames of different sizes with one
to three boxes each, against the JAX function on the same json and
seed: the same batches in the same order (the shuffle, and the flip, angle
and shift draws of each example, show in the image ids and the boxes), GT
boxes within 1e-3 px, the classes, validity and scales equal. The images:
the JAX package warps and resizes with cv2 on the host, the port with
tensor ops; on these frames (noise blurred over 3 px) the two are at most
0.002 grey apart with the rotation and shift, 0.00018 without (measured
here; bars 0.01 and 0.001 grey, means 1e-4).

``evaluate_detections`` (the numpy backend on both sides, one detection
an image and 100) and ``padded_detections_to_list``: equal.
"""

import json

import numpy as np
import pytest
import torch

from spacecraft_pose_estimation_tpu.data import coco_eval as jeval
from spacecraft_pose_estimation_tpu.data import detection_dataset as jdata
from spacecraft_pose_estimation_tpu_torch.data import coco_eval as teval
from spacecraft_pose_estimation_tpu_torch.data import detection_dataset as tdata

from torch_port_util import few_threads, n, smooth_frames  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

SIZES = ((72, 96), (120, 80), (64, 64), (90, 150), (100, 100))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("det_scene")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        frame = smooth_frames(10 + i, 1, h, w)[0]
        assert cv2.imwrite(str(root / f"{i}.png"), frame)
        images.append({"id": 100 + i, "file_name": f"{i}.png", "height": h, "width": w})
        for _ in range(1 + i % 3):
            x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(6, w - x0), rng.uniform(6, h - y0)
            anns.append({"id": len(anns), "image_id": 100 + i, "category_id": 1 + len(anns) % 2,
                         "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0})
    coco = {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    (root / "det.json").write_text(json.dumps(coco))
    return root


def batches(mod, examples, k, **kw):
    it = mod.detection_batches(examples, 2, (64, 64), num_workers=0, **kw)
    return [next(it) for _ in range(k)] if kw.get("train", True) else list(it)


@pytest.mark.parametrize("train,flip,shift", [(True, True, 100.0), (True, False, 12.0), (False, False, 0.0)])
def test_detection_batches_match_jax(scene, train, flip, shift):
    """The default shift of up to 100 px moves most boxes off a 64x64
    letterbox, so a second case shifts by up to 12 px."""
    jex = jdata.DetectionExamples(str(scene / "det.json"), str(scene))
    tex = tdata.DetectionExamples(str(scene / "det.json"), str(scene))
    kw = dict(train=True, flip=flip, seed=3, translation_range=shift) if train else dict(train=False, augment=False)
    want, got = batches(jdata, jex, 5, **kw), batches(tdata, tex, 5, **kw)
    assert len(got) == len(want) == (5 if train else 3)
    worst, means = 0.0, []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image_id"], w["image_id"])
        np.testing.assert_allclose(g["scale"], w["scale"], rtol=1e-12)
        np.testing.assert_allclose(n(g["gt_boxes"]), w["gt_boxes"], atol=1e-3)
        np.testing.assert_array_equal(n(g["gt_valid"]), w["gt_valid"])
        np.testing.assert_array_equal(n(g["gt_classes"]), w["gt_classes"])
        assert g["count"] == w["count"]
        d = np.abs(n(g["image"]) - w["image"])
        worst, means = max(worst, float(d.max())), means + [float(d.mean())]
    print(f"images (train={train}, flip={flip}): max {worst:.4g} grey, mean {max(means):.4g}")
    assert worst <= (0.01 if train else 0.001) and max(means) <= 1e-4
    assert sum(int(n(g["gt_valid"]).sum()) for g in got) > 0


def test_a_resumed_stream_goes_on_from_its_batch(scene):
    tex = tdata.DetectionExamples(str(scene / "det.json"), str(scene))
    whole = batches(tdata, tex, 5, train=True, flip=True)
    later = list(zip(range(2), tdata.detection_batches(tex, 2, (64, 64), flip=True, start=3, num_workers=0)))
    for (_, g), w in zip(later, whole[3:]):
        np.testing.assert_array_equal(g["image_id"], w["image_id"])
        assert torch.equal(g["image"], w["image"]) and torch.equal(g["gt_boxes"], w["gt_boxes"])


def test_frames_in_memory_equal_the_files(scene):
    import cv2

    files = tdata.DetectionExamples(str(scene / "det.json"), str(scene))
    frames = {f"{i}.png": torch.from_numpy(cv2.imread(str(scene / f"{i}.png"))) for i in range(len(SIZES))}
    mem = tdata.DetectionExamples(str(scene / "det.json"), frames=frames)
    for a, b in zip(batches(tdata, files, 3, flip=True), batches(tdata, mem, 3, flip=True)):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["gt_boxes"], b["gt_boxes"])


def _dets_and_gts(rng, k=12):
    dets = {"boxes": rng.uniform(0, 60, (k, 5, 4)).astype(np.float32), "scores": rng.uniform(size=(k, 5)),
            "valid": rng.uniform(size=(k, 5)) < 0.7}
    dets["boxes"][..., 2:] += dets["boxes"][..., :2]
    gts = []
    for i in range(k):
        g = dets["boxes"][i, :2] + rng.normal(0, 3, (2, 4))  # near the first two detections
        gts.append({"boxes": g[: 1 + i % 2]})
    gts[3] = {"boxes": np.zeros((0, 4))}  # an image without GT
    return dets, gts


@pytest.mark.parametrize("max_dets", [1, 100])
def test_evaluate_detections_matches_jax(max_dets):
    dets, gts = _dets_and_gts(np.random.default_rng(4))
    jl, tl = jeval.padded_detections_to_list(dets), teval.padded_detections_to_list(
        {k: torch.from_numpy(np.asarray(v)) for k, v in dets.items()})
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["scores"], b["scores"])
    want = jeval.evaluate_detections(jl, gts, max_dets=max_dets, backend="numpy")
    got = teval.evaluate_detections(tl, gts, max_dets=max_dets)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, (k, got[k], v)
    assert 0 < got["AP"] < 100
