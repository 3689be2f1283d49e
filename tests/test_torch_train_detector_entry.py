"""The port's detector trainer end to end on the CPU: ``tools/train_detector``.

Eight 64x64 PNG frames of noise with one bright box each (6 to train on, 2
to validate), ``--preset config_1 --tiny --input-size 64 --batch-size 2``:
``RCNN_TINY`` with the preset's flip and SGD schedule. Checked:

* the command writes the periodic and final checkpoints (``state.pt``
  with the parameters, SGD's momentum and the step, and the ``.npz``),
  ``metrics.json`` with every loss, ``grad_norm`` and the box AP of its
  evaluations; the final ``.npz`` loads through ``evaluate.load_detector``
  and gives the trained model's detections, 0 apart;
* a run of 2 updates, then one resumed to 4, ends bit-equal to one run of
  4 updates: parameters, momentum and step;
* ``--arch retinanet --tiny --input-size 96`` (``RETINANET_TINY``, no preset) writes the
  same artifacts with the focal and box losses, ``num_fg`` and the EMA
  ``loss_normalizer`` (saved in ``state.pt``, moved off its 100), the box
  AP of its evaluations, and a final ``.npz`` that gives the trained
  RetinaNet's detections, 0 apart;
* ``--preset config_20 --tiny`` (its flip and schedule): a run of 2
  updates resumed to 4 ends bit-equal to one run of 4, the loss
  normalizer included;
* ``--arch`` against its preset's architecture is refused; ``--help`` runs
  without JAX. (``--photometric-augs`` is held in
  ``test_torch_photometric.py``.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spacecraft_pose_estimation_tpu_torch import evaluate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.data.detection_dataset import DetectionExamples, detection_batches
from spacecraft_pose_estimation_tpu_torch.models.retinanet import RETINANET_TINY, RetinaNet
from spacecraft_pose_estimation_tpu_torch.tools import train_detector

from torch_port_util import few_threads  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("det_train_scene")
    rng = np.random.default_rng(0)
    for split, ids in (("train", range(6)), ("val", range(6, 8))):
        images, anns = [], []
        for i in ids:
            img = rng.integers(0, 40, (64, 64, 3)).astype(np.uint8)
            x0, y0 = rng.integers(4, 30, 2)
            w, h = rng.integers(14, 30, 2)
            img[y0:y0 + h, x0:x0 + w] = 230
            assert cv2.imwrite(str(root / f"{i}.png"), img)
            images.append({"id": i, "file_name": f"{i}.png", "height": 64, "width": 64})
            anns.append({"id": i, "image_id": i, "category_id": 1, "bbox": [int(x0), int(y0), int(w), int(h)],
                         "area": int(w * h), "iscrowd": 0})
        (root / f"{split}.json").write_text(json.dumps({"images": images, "annotations": anns,
                                                        "categories": [{"id": 1, "name": "spacecraft"}]}))
    return root


def args(scene, out, max_iter, val=True, extra=(), preset=("--preset", "config_1")):
    # RetinaNet at 96: at 64 its p6 is 1x1, where the CPU's bf16 channels_last convolution (oneDNN, torch
    # 2.13) returns a wrong weight gradient for the stride-2 p7 conv; from 2x2 on it is right
    size = "96" if "retinanet" in preset or "config_20" in preset else "64"
    a = [*preset, "--tiny", "--input-size", size, "--batch-size", "2", "--max-iter", str(max_iter),
         "--checkpoint-period", "2", "--eval-period", "2", "--train-json", str(scene / "train.json"),
         "--image-dir", str(scene), "--output", str(out), "--device", "cpu", *extra]
    return a + (["--val-json", str(scene / "val.json")] if val else [])


def test_command_writes_checkpoints_metrics_and_a_loadable_npz(scene, tmp_path):
    out = tmp_path / "run"
    train_detector.main(args(scene, out, 4))
    ck = out / "checkpoints"
    assert sorted(int(d) for d in os.listdir(ck) if d.isdigit()) == [2, 4]
    payload = torch.load(ck / "4" / "state.pt", weights_only=True)
    assert payload["step"] == 4 and payload["optimizer"]["state"]  # SGD's momentum buffers
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    last = rows[-1]
    assert {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_total", "grad_norm"} <= set(last)
    assert all(np.isfinite(r["loss_total"]) for r in rows)
    assert "bbox/AP" in last  # the evaluation after update 2: AP at one detection an image
    # the final .npz through the evaluation entry's loader
    loaded = evaluate.load_detector(str(ck / "4" / "model.npz"), True, False, torch.bfloat16, "cpu")
    parsed = train_detector.parse_args(args(scene, out, 4))
    model = train_detector.build_model(parsed, "cpu")
    model.load_state_dict({k: v for k, v in payload["model"].items()})
    batch = next(detection_batches(DetectionExamples(str(scene / "val.json"), str(scene)), 2, (64, 64),
                                   train=False, augment=False, num_workers=0))
    with torch.no_grad():
        a, b = loaded(batch["image"]), model(batch["image"])
    for k in ("boxes", "scores", "valid"):
        assert torch.equal(a[k], b[k]), k


def final_state(out):
    return torch.load(os.path.join(out, "checkpoints", "4", "state.pt"), weights_only=True)


def assert_resumed_equals_whole(scene, tmp_path, preset):
    train_detector.main(args(scene, tmp_path / "whole", 4, val=False, preset=preset))
    train_detector.main(args(scene, tmp_path / "resumed", 2, val=False, preset=preset))
    train_detector.main(args(scene, tmp_path / "resumed", 4, val=False, preset=preset))
    whole, resumed = final_state(tmp_path / "whole"), final_state(tmp_path / "resumed")
    assert whole["step"] == resumed["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(v, resumed["model"][k]), k
    for i, s in whole["optimizer"]["state"].items():
        assert all(torch.equal(s[k], resumed["optimizer"]["state"][i][k]) for k in s), i
    assert torch.equal(whole["loss_normalizer"], resumed["loss_normalizer"])
    return whole


def test_a_resumed_run_equals_an_uninterrupted_one(scene, tmp_path):
    whole = assert_resumed_equals_whole(scene, tmp_path, ("--preset", "config_1"))
    assert float(whole["loss_normalizer"]) == 100.0  # the Faster R-CNN's step leaves it alone


def test_a_resumed_retinanet_run_equals_an_uninterrupted_one(scene, tmp_path):
    parsed = train_detector.parse_args(args(scene, tmp_path, 4, preset=("--preset", "config_20")))
    assert parsed.arch == "retinanet" and parsed.flip and train_detector.model_config(parsed) == RETINANET_TINY
    whole = assert_resumed_equals_whole(scene, tmp_path, ("--preset", "config_20"))
    assert float(whole["loss_normalizer"]) < 100.0


def test_retinanet_command_trains_evaluates_and_writes_a_loadable_npz(scene, tmp_path):
    out = tmp_path / "retina"
    train_detector.main(args(scene, out, 4, preset=("--arch", "retinanet")))
    ck = out / "checkpoints"
    assert sorted(int(d) for d in os.listdir(ck) if d.isdigit()) == [2, 4]
    payload = torch.load(ck / "4" / "state.pt", weights_only=True)
    assert payload["step"] == 4 and payload["optimizer"]["state"]
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    last = rows[-1]
    assert {"loss_cls", "loss_box_reg", "loss_total", "num_fg", "loss_normalizer", "grad_norm"} <= set(last)
    assert all(np.isfinite(r["loss_total"]) and np.isfinite(r["grad_norm"]) for r in rows)
    # 100 -> 0.9 * old + 0.1 * num_fg after each of the 4 updates
    assert last["loss_normalizer"] < 100.0 and abs(float(payload["loss_normalizer"]) - last["loss_normalizer"]) < 1e-4
    assert "bbox/AP" in last
    loaded = RetinaNet(RETINANET_TINY, dtype=torch.bfloat16, device="cpu")
    loaded.load_state_dict(flax_to_state_dict({"params": evaluate.load_npz_variables(str(ck / "4" / "model.npz"))
                                               ["params"]}))
    model = train_detector.build_model(train_detector.parse_args(args(scene, out, 4, preset=("--arch", "retinanet"))),
                                       "cpu")
    model.load_state_dict(payload["model"])
    batch = next(detection_batches(DetectionExamples(str(scene / "val.json"), str(scene)), 2, (96, 96),
                                   train=False, augment=False, num_workers=0))
    with torch.no_grad():
        a, b = loaded(batch["image"]), model(batch["image"])
    assert a["boxes"].shape == (2, RETINANET_TINY.detections_per_image, 4)
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(a[k], b[k]), k


def test_arch_against_the_presets_is_refused(scene, tmp_path):
    with pytest.raises(SystemExit):
        train_detector.parse_args(args(scene, tmp_path, 1, extra=("--arch", "faster_rcnn"),
                                       preset=("--preset", "config_20")))


def test_help_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['train_detector', '--help']\n"
            "try:\n"
            "    runpy.run_module('spacecraft_pose_estimation_tpu_torch.tools.train_detector', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--preset" in proc.stdout
