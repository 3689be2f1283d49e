"""Port parity of the staged evaluation: ``evaluate --staged`` and its three stage tools.

Each stage function of ``spacecraft_pose_estimation_tpu_torch/tools/`` is
held to its JAX counterpart on one seeded scene (six smooth 192x120 BGR
frames written as PNGs, ``RCNN_TINY`` and ``HRNET_TINY`` in float32 from
numpy-seeded trees):

* ``export_boxes``: the JAX tool's composition (``tools/export_boxes.py``:
  cv2 letterbox, detector, argmax of the valid scores over the scale, the
  full frame when nothing is valid); boxes within 1e-2 px, as
  ``tests/test_torch_evaluate.py`` holds the same detector;
* ``test_landmarks``: JAX ``landmark_loop.validate`` with the flip test
  off and on (``shift_heatmap`` on), and the JAX tool's 2-model ensemble
  (``make_ensemble_apply``, ``method="mxu"``, no flip test), on the same
  json; keypoints within 1e-2 px, confidences 1e-4 (the crop is exact,
  the float32 models sum in another order);
* ``export_poses``: JAX ``pnp_ransac`` mapped over the frames with
  ``split(key(0), N)`` keys (the port fed that noise) and ``solve_pnp`` on
  ``adaptive_confidence_mask``, on keypoints projected from known poses
  with noise and outliers; poses within 1e-4; the finiteness audit.

Then ``evaluate.main(--staged)`` runs the three port commands as separate
processes and is held to the fused ``evaluate.main`` on the same PNGs and
``.npz`` weights at the JAX smoke test's bars
(``tests/test_tools_smoke.py``: boxes within 1.5 px, keypoint differences'
90th percentile below 6 px and median below 2 px, the same pose names).
"""

import dataclasses
import json
import os
import runpy
import subprocess
import sys

import cv2
import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import config as jconfig
from spacecraft_pose_estimation_tpu.data import landmark_dataset as jld
from spacecraft_pose_estimation_tpu.data.detection_dataset import letterbox as j_letterbox
from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo, heatmap as jhm, pnp as jpnp
from spacecraft_pose_estimation_tpu.ops.warp import batched_crop_and_resize
from spacecraft_pose_estimation_tpu.pipeline import normalize_crops as j_normalize_crops
from spacecraft_pose_estimation_tpu.train import landmark_loop as jloop
from spacecraft_pose_estimation_tpu.train.ensemble import make_ensemble_apply, stack_variables
from spacecraft_pose_estimation_tpu_torch import config as tconfig, evaluate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
from spacecraft_pose_estimation_tpu_torch.data.landmark_dataset import LandmarkExamples
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.tools import export_boxes, export_poses, test_landmarks
from spacecraft_pose_estimation_tpu_torch.train import landmark_loop

from torch_port_util import few_threads, jax_gumbel, n, random_variables, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES_HW, N_FRAMES, BATCH, SIZE, J = (120, 192), 6, 4, 64, 11
CAM = CameraModel(K=np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]]),
                  dist=np.array([-0.05, 0.01, 1e-3, -1e-3, 0.0]), width=192, height=120)
J_DET = dataclasses.replace(
    jrcnn.RCNN_TINY, roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32))
T_DET = dataclasses.replace(trcnn.RCNN_TINY, roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32))
OPTS = ["MODEL.NAME", "hrnet_tiny", "MODEL.IMAGE_SIZE", "[64, 64]", "TEST.BATCH_SIZE_PER_CHIP", str(BATCH)]


def smooth_frame(seed):
    """A seeded uint8 BGR frame, noise blurred over ~3 px (a camera image is smooth)."""
    im = cv2.GaussianBlur(np.random.default_rng(seed).integers(0, 256, (*FRAMES_HW, 3)).astype(np.float32),
                          (0, 0), 3.0)
    return np.clip(np.rint((im - im.mean()) / im.std() * 50 + 128), 0, 255).astype(np.uint8)


def _npz(tree, path):
    flat = {"/".join(str(k.key) for k in p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("staged")
    frames = np.stack([smooth_frame(90 + i) for i in range(N_FRAMES)])
    names = [f"img{i:06d}.png" for i in range(N_FRAMES)]
    scene_dir = root / "scenes" / "scene_a"
    scene_dir.mkdir(parents=True)
    for name, im in zip(names, frames):
        assert cv2.imwrite(str(scene_dir / name), im)
    jdet = jrcnn.GeneralizedRCNN(config=J_DET)
    det_vars = random_variables(
        lambda: jdet.init({"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        seed=3, overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05,
                           "cls_score": 0.05})
    jhr = JHRNet(config=J_HR_TINY.with_joints(J))
    hr_vars = [random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                                seed=seed, overrides={"final_layer": 0.1}) for seed in (4, 5)]
    tdet = trcnn.GeneralizedRCNN(T_DET, device="cpu")
    tdet.load_state_dict(flax_to_state_dict(det_vars))
    thrs = []
    for v in hr_vars:
        thrs.append(build_landmark_model("hrnet_tiny", J, device="cpu"))
        thrs[-1].load_state_dict(flax_to_state_dict(v))
    _npz(det_vars, root / "det.npz")
    _npz(hr_vars[0], root / "hrnet.npz")
    lm3d = np.random.default_rng(8).normal(0, 0.3, (J, 3))
    (root / "landmarks.csv").write_text("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in lm3d.tolist()))
    (root / "calibration.json").write_text(json.dumps(
        {"intrinsics": {"camera_matrix": CAM.K.tolist(), "distortion_coefficients": CAM.dist.tolist()}}))
    boxes, _ = export_boxes.export_boxes(frames, names, tdet, str(root / "boxes"), J, input_size=SIZE,
                                         batch_size=BATCH, width=FRAMES_HW[1], height=FRAMES_HW[0])
    return dict(root=root, scene_dir=scene_dir, frames=frames, names=names, jdet=jdet, det_vars=det_vars, jhr=jhr,
                hr_vars=hr_vars, tdet=tdet, thrs=thrs, boxes=boxes, json=str(root / "boxes" / "real_test.json"))


def test_export_boxes_matches_jax(scene):
    """The JAX tool's loop (tools/export_boxes.py:82-108) at this size, in float32."""
    infer = jax.jit(lambda imgs: scene["jdet"].apply(to_jax(scene["det_vars"]), imgs, train=False))
    want = []
    for start in range(0, N_FRAMES, BATCH):
        lbs, scales = zip(*(j_letterbox(im.astype(np.float32), (SIZE, SIZE))
                            for im in scene["frames"][start:start + BATCH]))
        batch = np.stack(list(lbs) + [lbs[-1]] * (BATCH - len(lbs)))
        dets = jax.tree_util.tree_map(np.asarray, infer(jnp.asarray(batch)))
        for i in range(len(lbs)):
            valid = dets["valid"][i]
            assert valid.any()
            want.append((dets["boxes"][i][valid] / scales[i])[dets["scores"][i][valid].argmax()])
    np.testing.assert_allclose(scene["boxes"], np.stack(want), atol=1e-2)
    apart = np.abs(scene["boxes"][:, None] - scene["boxes"][None]).max(-1) + np.eye(N_FRAMES) * 1e9
    assert apart.min() > 1e-2  # the frames' boxes differ by more than the bound
    coco = json.loads(open(scene["json"]).read())
    assert [im["file_name"] for im in coco["images"]] == scene["names"]
    assert [im["id"] for im in coco["images"]] == list(range(N_FRAMES))
    for ann, box in zip(coco["annotations"], scene["boxes"]):
        np.testing.assert_allclose(ann["bbox"], [box[0], box[1], box[2] - box[0], box[3] - box[1]], rtol=1e-6)
        assert ann["keypoints"] == [2.0] * (3 * J)


class _NoDetections(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, lb):
        b = lb.shape[0]
        return {"boxes": torch.ones(b, 5, 4), "scores": torch.ones(b, 5), "valid": torch.zeros(b, 5, dtype=torch.bool)}


def test_export_boxes_falls_back_to_the_full_frame(scene):
    """No valid detection: the whole frame of --image-width x --image-height (JAX coco_io.fallback_full_frame_box)."""
    boxes, dets = export_boxes.best_boxes(scene["frames"][:3], _NoDetections(), SIZE, 2, width=1920, height=1200)
    np.testing.assert_array_equal(boxes, np.tile([0.0, 0.0, 1920.0, 1200.0], (3, 1)))
    assert all(len(b) == 0 for b, _ in dets)


def _jax_examples(scene):
    return jld.LandmarkExamples(scene["json"], str(scene["scene_dir"]))


def cms_pair():
    """``hrnet_tiny_cms`` in both packages from one numpy-seeded tree: its
    heatmaps are the crop's size, 64x64, not a quarter of it."""
    jhr = JHRNet(config=dataclasses.replace(J_HR_TINY.with_joints(J), head="cms"))
    variables = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                                 seed=6, overrides={"head": 0.1})
    thr = build_landmark_model("hrnet_tiny_cms", J, device="cpu")
    thr.load_state_dict(flax_to_state_dict(variables))
    return jhr, variables, thr


@pytest.mark.parametrize("flip,landmark_model", [(False, "hrnet_tiny"), (True, "hrnet_tiny"),
                                                  (False, "hrnet_tiny_cms"), (True, "hrnet_tiny_cms")],
                         ids=["plain", "flip_test", "plain-cms", "flip_test-cms"])
def test_validate_matches_jax(scene, flip, landmark_model):
    if landmark_model == "hrnet_tiny":
        jhr, variables, thr = scene["jhr"], scene["hr_vars"][0], scene["thrs"][0]
    else:
        jhr, variables, thr = cms_pair()
    want = jloop.validate(jhr, to_jax(variables), _jax_examples(scene), BATCH, (64, 64),
                          flip_test=flip, shift_heatmap=True)
    examples = LandmarkExamples(scene["json"], str(scene["scene_dir"]))
    got = landmark_loop.validate(thr, examples, BATCH, (64, 64), flip_test=flip, shift_heatmap=True)
    assert got.shape == want.shape == (N_FRAMES, J, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-2)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4)
    # frames in memory (a mapping of names to BGR frames, as the card's machine hands them over) give the same
    frames = dict(zip(scene["names"], map(torch.from_numpy, scene["frames"])))
    in_memory = LandmarkExamples(scene["json"], frames=frames)
    np.testing.assert_array_equal(landmark_loop.validate(thr, in_memory, BATCH, (64, 64),
                                                         flip_test=flip, shift_heatmap=True), got)


def test_flip_test_shifts_by_repeating_column_zero():
    """The flipped heatmap moves right by one pixel with column 0 repeated
    (function.py:357-361), not rolled, as JAX's make_validate_step."""
    hm = torch.arange(2 * 3 * 5 * 2, dtype=torch.float32).reshape(2, 3, 5, 2)
    hm_on_flipped = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 5, 2)).astype(np.float32))
    images = torch.zeros(2, 3, 5, 3)
    images[:, :, 0] = 1.0  # flipped in width, the ones move to the last column
    model = lambda x: hm if x[0, 0, 0, 0] == 1 else hm_on_flipped  # noqa: E731
    centers, scales = torch.tensor([[2.0, 1.0]] * 2), torch.tensor([[0.05, 0.05]] * 2)
    _, _, got = landmark_loop.make_validate_step(model, flip_test=True)(images, centers, scales)
    back = hm_on_flipped.flip(2)
    torch.testing.assert_close(got, (hm + torch.cat([back[:, :, :1], back[:, :, :-1]], dim=2)) * 0.5,
                               rtol=0, atol=0)
    _, _, unshifted = landmark_loop.make_validate_step(model, flip_test=True, shift_heatmap=False)(
        images, centers, scales)
    torch.testing.assert_close(unshifted, (hm + back) * 0.5, rtol=0, atol=0)


def test_ensemble_matches_jax(scene):
    """Two models' mean heatmaps: the JAX tool's ensemble branch (tools/test_landmarks.py:80-106)."""
    cfg = tconfig.apply_overrides(tconfig.get_preset("events"), OPTS)
    got = test_landmarks.predict_landmarks(scene["thrs"], LandmarkExamples(scene["json"], str(scene["scene_dir"])),
                                           cfg, str(scene["root"] / "ens" / "pred.mat"))
    ens = jax.jit(make_ensemble_apply(scene["jhr"]))
    stacked = stack_variables([to_jax(v) for v in scene["hr_vars"]])
    examples = _jax_examples(scene)
    want = np.zeros((N_FRAMES, J, 3), np.float32)
    for start in range(0, N_FRAMES, BATCH):
        idx = list(range(start, min(start + BATCH, N_FRAMES)))
        exs = [examples.example(i) for i in idx]
        pad = BATCH - len(idx)
        images = np.stack([e["image"] for e in exs] + [exs[-1]["image"]] * pad)
        bboxes = np.stack([e["bbox"] for e in exs] + [exs[-1]["bbox"]] * pad)
        centers, scales = jax.vmap(jgeo.bbox_to_center_scale)(jnp.asarray(bboxes))
        crops = batched_crop_and_resize(jnp.asarray(images), centers, scales, jnp.zeros(BATCH), (64, 64),
                                        method="mxu")
        p, mv = jhm.decode_heatmaps(ens(stacked, j_normalize_crops(crops)), centers, scales, True)
        want[start:start + len(idx), :, :2] = np.asarray(p)[:len(idx)]
        want[start:start + len(idx), :, 2] = np.asarray(mv)[:len(idx)]
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-2)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4)
    np.testing.assert_array_equal(scipy.io.loadmat(scene["root"] / "ens" / "pred.mat")["preds"], got)
    examples = LandmarkExamples(scene["json"], str(scene["scene_dir"]))
    single = test_landmarks.predict_landmarks(scene["thrs"][:1], examples, cfg)
    assert np.abs(single - got).max() > 1e-3  # the second model counts


def _posed_keypoints(n_frames, seed):
    """Landmarks, and per frame keypoints projected at a known pose with
    0.5 px noise, 2 of 11 points 80 px off, confidences in [0.4, 1]."""
    rng = np.random.default_rng(seed)
    lm3d = rng.normal(0, 0.8, (J, 3))
    K = np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    cam = CameraModel(K=K, dist=np.array([-0.22, 0.18, 5e-4, -3e-4, -0.02]), width=1920, height=1200)
    preds = np.zeros((n_frames, J, 3), np.float32)
    poses = []
    for i in range(n_frames):
        q = rng.normal(size=4)
        R = np.asarray(jgeo.quat_to_dcm(jnp.asarray(q / np.linalg.norm(q), jnp.float32)), np.float64)
        tvec = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), rng.uniform(8, 12)])
        from spacecraft_pose_estimation_tpu_torch.data.coco_io import project_landmarks

        uv = project_landmarks(lm3d, R, tvec, K, cam.dist) + rng.normal(0, 0.5, (J, 2))
        uv[rng.choice(J, 2, replace=False)] += 80.0
        preds[i, :, :2] = uv
        preds[i, :, 2] = rng.uniform(0.4, 1.0, J)
        poses.append((R, tvec))
    return lm3d, cam, preds, poses


def test_export_poses_ransac_matches_jax():
    """RANSAC with 512 hypotheses over every frame at once on JAX's noise
    (``split(key(0), N)`` over frames, as the JAX tool), poses within 1e-4
    of JAX's; rotations within 1e-2 of the truth, translations 1e-2 of its norm."""
    n_frames = 5
    lm3d, cam, preds, poses = _posed_keypoints(n_frames, 11)
    K, dist, lm = (jnp.asarray(a, jnp.float32) for a in (cam.K, cam.dist, lm3d))
    solve = jax.jit(jax.vmap(lambda kp, conf, key: jpnp.pnp_ransac(lm, kp, K, dist, conf, key, num_hypotheses=512)))
    keys = jax.random.split(jax.random.key(0), n_frames)
    want = solve(jnp.asarray(preds[:, :, :2]), jnp.asarray(preds[:, :, 2]), keys)
    gumbel = t(jax_gumbel(jax.random.key(0), n_frames, 512, J))
    Rs, ts = export_poses.solve_poses(preds, lm3d, cam, "ransac", 512, "cpu", gumbel=gumbel)
    assert Rs.dtype == ts.dtype == np.float64 and Rs.shape == (n_frames, 3, 3)
    np.testing.assert_allclose(Rs, np.asarray(want["R"]), atol=1e-4)
    np.testing.assert_allclose(ts, np.asarray(want["t"]), rtol=1e-4, atol=1e-4)
    for (R, tvec), Rg, tg in zip(poses, Rs, ts):
        np.testing.assert_allclose(Rg, R, atol=1e-2)
        np.testing.assert_allclose(tg, tvec, atol=1e-2 * np.linalg.norm(tvec))
    # without noise from the caller, a seeded generator decides it
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = export_poses.solve_poses(preds, lm3d, cam, "ransac", 64, "cpu", generator=gen())
    b = export_poses.solve_poses(preds, lm3d, cam, "ransac", 64, "cpu", generator=gen())
    np.testing.assert_array_equal(a[0], b[0])


def test_export_poses_gn_matches_jax():
    lm3d, cam, preds, _ = _posed_keypoints(4, 12)
    K, dist, lm = (jnp.asarray(a, jnp.float32) for a in (cam.K, cam.dist, lm3d))
    solve = jax.jit(jax.vmap(lambda kp, conf: jpnp.solve_pnp(
        lm, kp, K, dist, jpnp.adaptive_confidence_mask(conf).astype(jnp.float32))))
    Rj, tj = solve(jnp.asarray(preds[:, :, :2]), jnp.asarray(preds[:, :, 2]))
    Rs, ts = export_poses.solve_poses(preds, lm3d, cam, "gn", device="cpu")
    np.testing.assert_allclose(Rs, np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(ts, np.asarray(tj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("broken", [False, True], ids=["nan_keypoints", "nan_poses"])
def test_export_poses_audits_finiteness(tmp_path, monkeypatch, broken):
    """A NaN pred.mat still gives finite poses (the solver's finite
    fallback) and they are written; a solver that returns a NaN pose makes
    the stage exit without writing opencv_poses.json."""
    lm3d, cam, preds, _ = _posed_keypoints(3, 13)
    preds[1] = np.nan
    names = [f"img{i:06d}.png" for i in range(3)]
    coco = {"images": [{"id": i, "file_name": f} for i, f in enumerate(names)], "annotations": []}
    if broken:
        real = export_poses.solve_poses

        def nan_pose(*a, **k):
            R, tvec = real(*a, **k)
            R[2, 0, 0] = np.nan
            return R, tvec

        monkeypatch.setattr(export_poses, "solve_poses", nan_pose)
        with pytest.raises(SystemExit, match=r"1/3 non-finite poses \(first: \['img000002.png'\]\)"):
            export_poses.export_poses(preds, coco, lm3d, cam, str(tmp_path), solver="gn", device="cpu")
        assert not (tmp_path / "opencv_poses.json").exists()
    else:
        got, Rs, ts = export_poses.export_poses(preds, coco, lm3d, cam, str(tmp_path), solver="ransac",
                                                hypotheses=64, device="cpu")
        assert got == names and np.isfinite(Rs).all() and np.isfinite(ts).all()
        assert [p["image_name"] for p in json.loads((tmp_path / "opencv_poses.json").read_text())] == names


def test_staged_main_matches_fused(scene, tmp_path):
    """``evaluate.main(--staged)`` runs the three port commands as separate
    processes (from .npz weights and PNG frames) and writes the three
    artifacts; they agree with the fused ``evaluate.main`` at the JAX smoke
    test's bars."""
    root = scene["root"]
    common = ["--scenes-dir", str(root / "scenes"), "--landmarks-file", str(root / "landmarks.csv"),
              "--calibration-file", str(root / "calibration.json"), "--detector-checkpoint", str(root / "det.npz"),
              "--landmark-checkpoint", str(root / "hrnet.npz"), "--tiny", "--batch-size", str(BATCH),
              "--input-size", str(SIZE), "--device", "cpu"]
    evaluate.main(common + ["--output-dir", str(tmp_path / "fused"), *OPTS])
    evaluate.main(common + ["--staged", "--output-dir", str(tmp_path / "staged"), *OPTS])
    fused, staged = tmp_path / "fused" / "scene_a", tmp_path / "staged" / "scene_a"
    for artifact in ("pred.mat", "real_test.json", "opencv_poses.json"):
        assert (staged / artifact).exists(), artifact
    fc, sc = (json.loads((d / "real_test.json").read_text()) for d in (fused, staged))
    assert len(fc["annotations"]) == len(sc["annotations"]) == N_FRAMES and fc["images"] == sc["images"]
    fb, sb = (np.array([a["bbox"] for a in c["annotations"]]) for c in (fc, sc))
    print(f"\nstaged vs fused: boxes max {np.abs(sb - fb).max():.3g} px")
    np.testing.assert_allclose(sb, fb, atol=1.5)
    fp, sp = (scipy.io.loadmat(d / "pred.mat")["preds"] for d in (fused, staged))
    assert fp.shape == sp.shape == (N_FRAMES, J, 3)
    diff = np.abs(sp[:, :, :2] - fp[:, :, :2])
    print(f"staged vs fused: keypoints 90th percentile {np.quantile(diff, 0.9):.3g} px, median "
          f"{np.median(diff):.3g} px, max {diff.max():.3g} px")
    assert np.quantile(diff, 0.9) < 6.0 and np.median(diff) < 2.0
    fposes, sposes = (json.loads((d / "opencv_poses.json").read_text()) for d in (fused, staged))
    assert [p["image_name"] for p in fposes] == [p["image_name"] for p in sposes] == scene["names"]
    assert np.isfinite([p["rotation_matrix"] for p in sposes]).all()


def test_landmark_examples_need_cv2_only_for_files(scene, monkeypatch):
    """Without cv2, frames in memory still serve; reading files raises and says why."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = dict(zip(scene["names"], scene["frames"]))
    ex = LandmarkExamples(scene["json"], frames=frames).example(0)
    np.testing.assert_array_equal(ex["image"], scene["frames"][0][..., ::-1])
    assert ex["image"].dtype == np.uint8 and ex["bbox"].dtype == np.float32
    with pytest.raises(RuntimeError, match="OpenCV"):
        LandmarkExamples(scene["json"], str(scene["scene_dir"])).example(0)
    with pytest.raises(ValueError, match="one of them"):
        LandmarkExamples(scene["json"])


def test_load_yaml_matches_jax(tmp_path):
    """``--cfg``: nested and dotted keys merged as the JAX loader merges them; unknown keys skipped."""
    path = tmp_path / "cfg.yaml"
    path.write_text("MODEL:\n  NAME: hrnet_tiny\n  IMAGE_SIZE: [64, 48]\nTEST.FLIP_TEST: true\nEXTRA:\n  X: 1\n")
    got = tconfig.load_yaml(tconfig.get_preset("events"), str(path))
    want = jconfig.load_yaml(jconfig.get_preset("events"), str(path))
    assert (got.model.name, tuple(got.model.image_size), got.test.flip_test) == ("hrnet_tiny", (64, 48), True)
    assert (want.model.name, tuple(want.model.image_size), want.test.flip_test) == ("hrnet_tiny", (64, 48), True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("tool", ["export_boxes", "test_landmarks", "export_poses"])
def test_tool_help_runs_without_jax(tool):
    code = ("import runpy, sys\n"
            f"sys.argv = ['{tool}', '--help']\n"
            "try:\n"
            f"    runpy.run_module('spacecraft_pose_estimation_tpu_torch.tools.{tool}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pandas', 'yaml', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and (".npz" in proc.stdout or tool == "export_poses")
