"""The port's landmark trainer end to end on the CPU: ``tools/train_landmarks``.

The scene is the JAX workflow smoke test's (``tests/test_tools_smoke.py``):
white-dot landmarks of a cube projected into 64x64 PNG frames, 8 to train
on and 2 to validate, with its overrides (``hrnet_tiny``, 64x64 -> 16x16,
batch 4, float32); the COCO jsons are written with the port's
``coco_io``. Checked:

* the command writes the periodic and final checkpoints (``state.pt`` and
  the ``.npz``), ``best.json``, ``metrics.json`` and ``pred_val.mat``, and
  ``tools/test_landmarks`` reads the ``.npz``;
* an ``AUTO_RESUME`` run of 1 epoch, then one to 2 epochs, ends with the
  parameters, BN statistics and optimizer state bit-equal to one 2-epoch
  run: the batch order and the augmentation draws are those of the steps
  (the resumed run also reads the frames from files instead of the device
  cache, so the two data paths are held equal too);
* ``--help`` runs without JAX.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import scipy.io
import torch
from scipy.spatial.transform import Rotation

from spacecraft_pose_estimation_tpu_torch.data import coco_io
from spacecraft_pose_estimation_tpu_torch.tools import test_landmarks, train_landmarks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["MODEL.NAME", "hrnet_tiny", "MODEL.IMAGE_SIZE", "[64, 64]", "MODEL.HEATMAP_SIZE", "[16, 16]",
        "TRAIN.BATCH_SIZE_PER_CHIP", "4", "TEST.BATCH_SIZE_PER_CHIP", "4", "MODEL.COMPUTE_DTYPE", "float32"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The smoke test's cube scene: 12 landmarks, poses near 4 m ahead."""
    root = tmp_path_factory.mktemp("train_scene")
    rng = np.random.default_rng(0)
    lm = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
                  + [[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0], [0, 0, 0.3]])
    K = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]])
    frames = root / "frames"
    frames.mkdir()
    for split, count in (("train", 8), ("validation", 2)):
        images, anns = [], []
        for _ in range(count):
            idx = len(list(frames.iterdir()))
            R = Rotation.from_euler("xyz", rng.uniform(-0.3, 0.3, 3)).as_matrix()
            uv = coco_io.project_landmarks(lm, R, np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, 3), K)
            img = np.zeros((64, 64, 3), np.uint8)
            for x, y in uv:
                cv2.circle(img, (int(x), int(y)), 1, (255, 255, 255), -1)
            name = f"{idx}.png"
            assert cv2.imwrite(str(frames / name), img)
            lo, hi = uv.min(0) - 2, uv.max(0) + 2
            images.append(coco_io.image_record(name, 64, 64, idx))
            anns.append(coco_io.keypoint_annotation(np.concatenate([uv, np.full((12, 1), 2.0)], 1),
                                                    [lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], idx, idx))
        coco_io.save_coco(coco_io.build_coco_dict(images, anns, 12), str(root / f"{split}.json"))
    return root


def train_args(scene, out, epochs, val=True):
    args = ["--preset", "events", "--train-json", str(scene / "train.json"), "--image-dir", str(scene / "frames"),
            "--output", str(out), "--device", "cpu"]
    if val:
        args += ["--val-json", str(scene / "validation.json")]
    return args + OPTS + ["TRAIN.END_EPOCH", str(epochs)]


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    out = tmp_path_factory.mktemp("train_out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "spacecraft_pose_estimation_tpu_torch.tools.train_landmarks",
                           *train_args(scene, out, 2)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def test_command_writes_checkpoints_metrics_and_predictions(scene, trained, tmp_path):
    ck = trained / "checkpoints"
    # 8 frames in batches of 4: 2 steps an epoch, a checkpoint each epoch
    assert sorted(int(d) for d in os.listdir(ck) if d.isdigit()) == [2, 4]
    for step in (2, 4):
        assert (ck / str(step) / "state.pt").exists() and (ck / str(step) / "model.npz").exists()
    assert json.loads((ck / "meta_4.json").read_text()) == {"epoch": 1, "final": True}
    assert (ck / "best" / "meta_2.json").exists() or (ck / "best" / "meta_4.json").exists()
    best = json.loads((ck / "best.json").read_text())
    rows = [json.loads(line) for line in (trained / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
    # each epoch's row is written before its validation, as the JAX trainer does
    assert {"loss", "grad_norm", "acc"} <= set(rows[0]) and "val_mean_conf" in rows[1]
    assert best["perf"] >= rows[1]["val_mean_conf"]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in rows)
    preds = scipy.io.loadmat(str(trained / "pred_val.mat"))["preds"]
    assert preds.shape == (2, 12, 3) and np.isfinite(preds).all()
    # the trained .npz goes straight into the staged landmark stage
    test_landmarks.main(["--test-json", str(scene / "validation.json"), "--image-dir", str(scene / "frames"),
                         "--checkpoint", str(ck / "4" / "model.npz"), "--output", str(tmp_path),
                         "--pred-name", "pred", "--device", "cpu"] + OPTS)
    got = scipy.io.loadmat(str(tmp_path / "pred.mat"))["preds"]
    np.testing.assert_allclose(got, preds, atol=1e-4)  # the same weights, the same crops


def final_state(out):
    return torch.load(os.path.join(out, "checkpoints", "4", "state.pt"), weights_only=True)


def test_auto_resume_equals_an_uninterrupted_run(scene, tmp_path, monkeypatch):
    train_landmarks.main(train_args(scene, tmp_path / "whole", 2, val=False))
    monkeypatch.setenv("SPE_DEVICE_CACHE", "0")  # the resumed run reads its frames from the files
    train_landmarks.main(train_args(scene, tmp_path / "resumed", 1, val=False))
    assert sorted(os.listdir(tmp_path / "resumed" / "checkpoints")) == ["2", "meta_2.json"]
    train_landmarks.main(train_args(scene, tmp_path / "resumed", 2, val=False))
    whole, resumed = final_state(tmp_path / "whole"), final_state(tmp_path / "resumed")
    assert whole["step"] == resumed["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(v, resumed["model"][k]), k
    for i, s in whole["optimizer"]["state"].items():
        assert all(torch.equal(s[k], resumed["optimizer"]["state"][i][k]) for k in s), i


def test_help_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['train_landmarks', '--help']\n"
            "try:\n"
            "    runpy.run_module('spacecraft_pose_estimation_tpu_torch.tools.train_landmarks', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--train-json" in proc.stdout and "--device" in proc.stdout
