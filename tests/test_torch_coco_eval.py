"""Port parity of the keypoint-OKS evaluation (``data/coco_eval.py``) and ``landmark_loop.oks_metrics``.

Seeded detections and ground truth (several detections an image, some
unlabeled or out-of-frame keypoints, an image whose ground truth has no
labeled keypoint, an image with no detection) go through the JAX
package's ``compute_oks`` / ``evaluate_keypoints`` and the port's copies:
the OKS matrices and every AP entry agree to 1e-12 (the same float64
arithmetic in the same order).
"""

import json

import cv2
import numpy as np
import pytest

from spacecraft_pose_estimation_tpu.data import coco_eval as jce
from spacecraft_pose_estimation_tpu.data import landmark_dataset as jld
from spacecraft_pose_estimation_tpu.train import landmark_loop as jloop
from spacecraft_pose_estimation_tpu_torch.data import coco_eval as tce
from spacecraft_pose_estimation_tpu_torch.data.landmark_dataset import LandmarkExamples
from spacecraft_pose_estimation_tpu_torch.train import landmark_loop

J = 11


def _scene(seed, n_images=8):
    """Per image: 1-3 gts (boxes 20-200 px, so every area range is hit) and
    0-5 detections near them with jitter of 0.5-30 px."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for i in range(n_images):
        g = rng.integers(1, 4)
        wh = rng.uniform(20, 200, (g, 2))
        xy = rng.uniform(0, 300, (g, 2))
        kps = np.concatenate([xy[:, None] + rng.uniform(0, 1, (g, J, 2)) * wh[:, None],
                              rng.choice([0.0, 1.0, 2.0], (g, J, 1), p=[0.2, 0.2, 0.6])], -1)
        if i == 3:
            kps[0, :, 2] = 0.0  # a gt with no labeled keypoint: ignored, its box the OKS region
        gts.append({"keypoints": kps, "boxes": np.concatenate([xy, wh], 1)})
        d = 0 if i == 5 else rng.integers(1, 6)
        src = rng.integers(0, g, d)
        jitter = rng.choice([0.5, 3.0, 10.0, 30.0], d)[:, None, None]
        dk = kps[src, :, :2] + rng.normal(0, 1, (d, J, 2)) * jitter
        dets.append({"keypoints": np.concatenate([dk, rng.uniform(0.1, 1, (d, J, 1))], -1),
                     "scores": rng.uniform(0, 1, d)})
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_oks_matches_jax(seed):
    dets, gts = _scene(seed)
    sigmas = np.full(J, 0.05)
    for det, gt in zip(dets, gts):
        areas = gt["boxes"][:, 2] * gt["boxes"][:, 3]
        want = jce.compute_oks(det["keypoints"], gt["keypoints"], areas, gt["boxes"], sigmas)
        got = tce.compute_oks(det["keypoints"], gt["keypoints"], areas, gt["boxes"], sigmas)
        assert got.shape == (len(det["keypoints"]), len(gt["keypoints"]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed,max_dets", [(0, 20), (1, 20), (2, 2)])
def test_evaluate_keypoints_matches_jax(seed, max_dets):
    dets, gts = _scene(seed)
    want = jce.evaluate_keypoints(dets, gts, max_dets=max_dets)
    got = tce.evaluate_keypoints(dets, gts, max_dets=max_dets)
    assert set(got) == set(want) == {"AP", "APm", "APl", "AR", "AP50", "AP75"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)
    assert 0 < got["AP"] < 100  # neither degenerate


def test_evaluate_keypoints_person_sigmas_and_given_sigmas():
    """J = 17 takes the COCO-person sigmas, as JAX; given sigmas are used as given."""
    rng = np.random.default_rng(4)
    kps = np.concatenate([rng.uniform(0, 100, (2, 17, 2)), np.full((2, 17, 1), 2.0)], -1)
    gts = [{"keypoints": kps, "boxes": np.array([[0, 0, 100, 100], [10, 10, 90, 80]], np.float64)}]
    dets = [{"keypoints": kps + np.concatenate([rng.normal(0, 4, (2, 17, 2)), np.zeros((2, 17, 1))], -1),
             "scores": np.array([0.9, 0.4])}]
    for sigmas in (None, np.linspace(0.02, 0.1, 17)):
        want = jce.evaluate_keypoints(dets, gts, sigmas=sigmas)
        got = tce.evaluate_keypoints(dets, gts, sigmas=sigmas)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


def test_oks_metrics_matches_jax(tmp_path):
    """A validation pass's preds against a json of labeled keypoints (COCO vis
    0/1/2, mapped back from the training weights), as the JAX oks_metrics."""
    rng = np.random.default_rng(5)
    dets, gts = _scene(6, n_images=5)
    images, anns = [], []
    for i, gt in enumerate(gts):
        name = f"img{i:06d}.png"
        cv2.imwrite(str(tmp_path / name), np.zeros((8, 8, 3), np.uint8))  # the JAX examples read each frame
        images.append({"id": i, "file_name": name, "width": 400, "height": 400})
        anns.append({"id": i, "image_id": i, "bbox": gt["boxes"][0].tolist(), "category_id": 1,
                     "keypoints": gt["keypoints"][0].reshape(-1).tolist()})
    path = tmp_path / "gt.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": []}))
    preds = np.stack([gt["keypoints"][0] for gt in gts]).astype(np.float32)
    preds[..., :2] += rng.normal(0, 5, preds[..., :2].shape)
    preds[..., 2] = rng.uniform(0.2, 1, preds[..., 2].shape)
    want = jloop.oks_metrics(preds, jld.LandmarkExamples(str(path), str(tmp_path)))
    got = landmark_loop.oks_metrics(preds, LandmarkExamples(str(path), str(tmp_path)))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)
