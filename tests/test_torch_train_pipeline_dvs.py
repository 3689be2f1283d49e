"""The port's DVS training pipeline end to end on the CPU: ``tools/train_pipeline_dvs``.

The scene is built as the JAX package's ``dvs_scene`` fixture builds it
(``tests/test_pipeline_drivers.py:61-120``): 10 frames of 64x64 with the 8
corners of a cube as white dots on a smooth trajectory, a probe run of
``tools.v2e`` (``clean``, duration exposure 0.02) to learn the event-frame
stems, and blender GT written for exactly those stems. Then the port's
driver runs in process at ``--tiny`` (exposure 0.02, 2 detector updates at
64^2 and batch 2, 1 landmark epoch of ``hrnet_tiny`` at 64^2 -> 16^2).
Checked: the artifacts JAX's ``test_end_to_end_tiny`` checks (the event
frames, both trainers' checkpoints, COCO dicts whose every annotation has a
box and 8 keypoints of visibility 1 or 2), that the port's
``synthetic_*.json`` equal, byte for byte, what the JAX package's
``tools/convert_to_coco.py`` writes on the port's split frames, that every
stage ran in this process, and that the driver needs CUDA or ``--device cpu``.
Also the accuracy run's scoring (``chip_dvs_run.py``) on GT keypoints and
on a body turned 180 degrees about each of its axes, and its ``--rescore``
look at saved inputs on GT keypoints.
"""

import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spacecraft_pose_estimation_tpu_torch.tools import train_pipeline_dvs, v2e

from torch_port_util import few_threads

pytestmark = pytest.mark.usefixtures("few_threads")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dvs_scene(tmp_path_factory):
    import cv2
    import pandas as pd
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("dvs")
    frames, gt = root / "video", root / "gt"
    frames.mkdir()
    gt.mkdir()
    lm = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    K = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]])
    pd.DataFrame(lm, columns=["x", "y", "z"]).to_csv(root / "landmarks.csv", index=False)

    def pose_at(phase):
        R = Rotation.from_euler("xyz", [0.05 * phase, 0.03 * phase, 0]).as_matrix()
        return R, np.array([0.0, 0.0, 4.0])

    for i in range(10):
        R, t = pose_at(i)
        uv = (lm @ R.T + t) @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        img = np.zeros((64, 64, 3), np.uint8)
        for x, y in uv:
            cv2.circle(img, (int(x), int(y)), 2, (255, 255, 255), -1)
        cv2.imwrite(str(frames / f"{i:04d}.png"), img)

    probe = root / "v2e_probe"
    v2e.main(["-i", str(frames), "-o", str(probe), "--dvs_params", "clean", "--dvs_exposure", "duration", "0.02",
              "--device", "cpu"])
    stems = sorted(int(p.stem) for p in (probe / "event-frames").glob("*.bmp"))
    assert stems, "v2e probe emitted no event frames"
    for s in stems:
        R, t = pose_at(s / max(stems[-1], 1) * 9)
        np.savetxt(str(gt / f"camera_intrinsics_{s}.txt"), K)
        (gt / f"pose_{s}.json").write_text(json.dumps({"rotation": R.tolist(), "translation": t.tolist()}))
    return root


def pipeline_args(scene, work, device="cpu"):
    return ["--frames-dir", str(scene / "video"), "--gt-dir", str(scene / "gt"),
            "--landmarks-file", str(scene / "landmarks.csv"), "--work-dir", str(work), "--exposures", "0.02",
            "--image-width", "64", "--image-height", "64", "--detector-iters", "2", "--detector-input-size", "64",
            "--detector-batch-size", "2", "--landmark-epochs", "1", "--tiny", "--device", device,
            "MODEL.IMAGE_SIZE", "[64, 64]", "MODEL.HEATMAP_SIZE", "[16, 16]", "TRAIN.BATCH_SIZE_PER_CHIP", "2",
            "TEST.BATCH_SIZE_PER_CHIP", "2"]


def test_end_to_end_tiny(dvs_scene, tmp_path, monkeypatch):
    import subprocess

    def no_subprocess(*a, **k):
        raise AssertionError("a stage started a process of its own")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    work = tmp_path / "work"
    out = train_pipeline_dvs.main(pipeline_args(dvs_scene, work))
    monkeypatch.undo()
    assert (work / "events_0.02" / "event-frames").is_dir()
    assert (work / "detector" / "checkpoints").is_dir()
    assert (work / "landmarks" / "checkpoints").is_dir()
    assert sorted(out.seconds) == ["convert", "split", "train_detector", "train_landmarks", "v2e"]
    # the final checkpoints the evaluation entry reads
    assert list((work / "detector" / "checkpoints").glob("*/model.npz"))
    assert list((work / "landmarks" / "checkpoints").glob("*/model.npz"))

    dicts = work / "events_0.02" / "event-frames_dicts"
    coco = json.loads((dicts / "synthetic_train.json").read_text())
    assert coco["images"] and coco["annotations"]
    for ann in coco["annotations"]:
        assert ann["bbox"][2] > 0 and ann["bbox"][3] > 0
        kps = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        assert kps.shape[0] == 8
        assert set(np.unique(kps[:, 2])) <= {1.0, 2.0}

    # the JAX converter on the port's split frames writes the same dicts
    old = sys.argv
    sys.argv = ["convert_to_coco", "blender", "--frames-dir", str(work / "events_0.02" / "event-frames_split"),
                "--gt-dir", str(dvs_scene / "gt"), "--landmarks-file", str(dvs_scene / "landmarks.csv"),
                "--output-dir", str(tmp_path / "jax_dicts"), "--image-width", "64", "--image-height", "64"]
    try:
        runpy.run_path(str(ROOT / "tools" / "convert_to_coco.py"), run_name="__main__")
    finally:
        sys.argv = old
    for split in ("train", "validation", "test"):
        name = f"synthetic_{split}.json"
        assert (dicts / name).read_bytes() == (tmp_path / "jax_dicts" / name).read_bytes(), name
    n_split = sum(len(os.listdir(work / "events_0.02" / "event-frames_split" / s))
                  for s in ("train", "validation", "test"))
    assert n_split == len(list((work / "events_0.02" / "event-frames").glob("*.bmp")))


def test_driver_needs_cuda_or_an_explicit_device(dvs_scene, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_pipeline_dvs.main(pipeline_args(dvs_scene, tmp_path / "w", device="cuda")[:-10])
    assert not (tmp_path / "w").exists()


def test_accuracy_run_scores_gt_keypoints_as_exact(tmp_path):
    """``chip_dvs_run.py``'s scoring: the GT poses' own projections, solved
    by the port's RANSAC PnP, score 0 keypoint px and ~0 rotation and
    translation error against the rendered scene's GT poses (its pose
    convention is the scene's: x_cam = R X + t); 25 px of noise does not."""
    sys.path.insert(0, str(ROOT))
    import chip_dvs_run

    from spacecraft_pose_estimation_tpu_torch.data import coco_io
    from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
    from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene as scene_tool
    from spacecraft_pose_estimation_tpu_torch.tools.export_poses import solve_poses

    scene_tool.main(["render", "--output-dir", str(tmp_path), "--num-frames", "40", "--width", "320",
                     "--height", "180"])
    scene = json.loads((tmp_path / "scene.json").read_text())
    lm = coco_io.load_landmarks_csv(str(tmp_path / "landmarks.csv"))
    cam = CameraModel.from_calibration_json(str(tmp_path / "calibration.json"))
    gt = tmp_path / "gt"
    gt.mkdir()
    names, preds, Rs, ts = [], [], [], []
    for i in range(0, 40, 4):
        R, t = scene_tool.pose_at(scene, float(i))
        (gt / f"pose_{i}.json").write_text(json.dumps({"rotation": R.tolist(), "translation": t.tolist()}))
        uv = coco_io.project_landmarks(lm, R, t, cam.K)
        names.append(f"{i}.bmp")
        preds.append(np.column_stack([uv, np.ones(len(uv))]))
        Rs.append(R)
        ts.append(t)
    preds = np.stack(preds)
    coco = coco_io.poses_to_coco(names, np.stack(Rs), np.stack(ts), lm, cam.K, 320, 180)
    kp = chip_dvs_run.keypoint_errors(coco, preds, names, lm)[0]
    assert kp["kp_err_mean_px_all"] < 1e-9 and kp["keypoints_all"] == 10 * len(lm)
    assert kp["body_kp_best_turn_counts"]["none"] == 10
    errs = {}
    for noise in (0.0, 25.0):
        p = preds.copy()
        p[:, :, :2] += np.random.default_rng(0).normal(size=p[:, :, :2].shape) * noise
        R, t = solve_poses(p, lm, cam, device="cpu")
        poses = [{"image_name": n, "rotation_matrix": r.tolist(), "T": v.reshape(3, 1).tolist()}
                 for n, r, v in zip(names, R, t)]
        errs[noise] = chip_dvs_run.pose_errors(poses, str(gt))[0]
    assert errs[0.0]["rot_err_median_deg"] < 0.05 and errs[0.0]["trans_rel_err_median"] < 1e-4
    assert errs[25.0]["rot_err_median_deg"] > 1.0


@pytest.mark.parametrize("turn", ["x", "y", "z"])
def test_accuracy_run_names_a_turned_body(tmp_path, turn):
    """``chip_dvs_run.py``'s turn readings: poses and keypoints of the body
    turned by 180 degrees about one of its axes score ~180 degrees and tens
    of pixels as they are, ~0 under that turn, and that turn wins every frame."""
    import cv2

    sys.path.insert(0, str(ROOT))
    import chip_dvs_run

    from spacecraft_pose_estimation_tpu_torch.data import coco_io
    from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene as scene_tool

    lm = scene_tool.craft_geometry()[0]
    K = np.array([[800.0, 0.0, 640.0], [0.0, 800.0, 360.0], [0.0, 0.0, 1.0]])
    S = chip_dvs_run.TURNS[turn]
    gt = tmp_path / "gt"
    gt.mkdir()
    rng = np.random.default_rng(3)
    names, preds, poses, Rs, ts = [], [], [], [], []
    for i in range(6):
        R, _ = cv2.Rodrigues(rng.normal(size=3))
        t = np.array([0.1 * i - 0.3, 0.05, 8.0 + i])
        (gt / f"pose_{i}.json").write_text(json.dumps({"rotation": R.tolist(), "translation": t.tolist()}))
        names.append(f"{i}.bmp")
        uv = coco_io.project_landmarks(lm, R @ S, t, K)
        preds.append(np.column_stack([uv, np.ones(len(uv))]))
        poses.append({"image_name": names[-1], "rotation_matrix": (R @ S).tolist(), "T": t.reshape(3, 1).tolist()})
        Rs.append(R)
        ts.append(t)
    coco = coco_io.poses_to_coco(names, np.stack(Rs), np.stack(ts), lm, K, 1280, 720)
    kp = chip_dvs_run.keypoint_errors(coco, np.stack(preds), names, lm)[0]
    assert kp["body_kp_err_median_px"] > 10.0 and kp["body_kp_err_median_px_best_turn"] < 1e-6
    assert kp["body_kp_best_turn_counts"][turn] == 6
    pose = chip_dvs_run.pose_errors(poses, str(gt))[0]
    assert pose["rot_err_median_deg"] > 179.9 and pose["rot_err_over_150_share"] == 1.0
    assert pose["rot_err_median_deg_any_turn"] < 1e-4 and pose["rot_best_turn_counts"][turn] == 6
    assert pose["trans_rel_err_median"] == 0.0


def test_accuracy_rescore_reads_gt_keypoints_as_exact(tmp_path):
    """``chip_dvs_run.py --rescore`` on saved inputs whose predictions are
    the GT's own projections: every landmark counts as learned and nearest
    to itself, and every re-solved pose is the GT's."""
    sys.path.insert(0, str(ROOT))
    import shutil

    import chip_dvs_run

    from spacecraft_pose_estimation_tpu_torch.data import coco_io
    from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
    from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene as scene_tool

    scene_tool.main(["render", "--output-dir", str(tmp_path), "--num-frames", "24", "--width", "320",
                     "--height", "180"])
    out = tmp_path / "out"
    out.mkdir()
    for name in ("landmarks.csv", "calibration.json"):
        shutil.copy(tmp_path / name, out / name)
    scene = json.loads((tmp_path / "scene.json").read_text())
    lm = coco_io.load_landmarks_csv(str(out / "landmarks.csv"))
    cam = CameraModel.from_calibration_json(str(out / "calibration.json"))
    gts, frames, preds = {}, [], []
    for i in range(0, 24, 3):
        R, t = scene_tool.pose_at(scene, float(i))
        gts[f"{i}.bmp"] = {"rotation": R.tolist(), "translation": t.tolist()}
        frames.append({"file": f"{i}.bmp", "kp_err_px": [0.0] * len(lm)})
        preds.append(np.column_stack([coco_io.project_landmarks(lm, R, t, cam.K), np.ones(len(lm))]))
    (out / "gt_test.json").write_text(json.dumps(gts))
    (out / "per_frame.json").write_text(json.dumps(frames))
    coco_io.save_pred_mat(np.stack(preds), str(out / "pred.mat"))
    res = chip_dvs_run.rescore(str(out))
    assert res["learned_landmarks"] == list(range(len(lm))) and res["frames_learned_within_threshold"] == 8
    assert [int(np.argmax(c)) for c in res["nearest_gt_landmark_by_landmark"]] == list(range(len(lm)))
    for key in ("solved_all", "solved_learned", "solved_learned_clean_frames", "solved_gt_0px_all"):
        assert res[key]["frames"] == 8 and res[key]["rot_err_median_deg"] < 0.05, (key, res[key])
    assert json.loads((out / "rescore.json").read_text()) == res
