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
* ``--arch retinanet`` and ``--preset config_20`` raise; ``--help`` runs
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
from spacecraft_pose_estimation_tpu_torch.data.detection_dataset import DetectionExamples, detection_batches
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


def args(scene, out, max_iter, val=True, extra=()):
    a = ["--preset", "config_1", "--tiny", "--input-size", "64", "--batch-size", "2", "--max-iter", str(max_iter),
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


def test_a_resumed_run_equals_an_uninterrupted_one(scene, tmp_path):
    train_detector.main(args(scene, tmp_path / "whole", 4, val=False))
    train_detector.main(args(scene, tmp_path / "resumed", 2, val=False))
    train_detector.main(args(scene, tmp_path / "resumed", 4, val=False))
    whole, resumed = final_state(tmp_path / "whole"), final_state(tmp_path / "resumed")
    assert whole["step"] == resumed["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(v, resumed["model"][k]), k
    for i, s in whole["optimizer"]["state"].items():
        assert all(torch.equal(s[k], resumed["optimizer"]["state"][i][k]) for k in s), i


@pytest.mark.parametrize("extra,match", [(["--arch", "retinanet", "--preset", "config_20"], "RetinaNet")])
def test_unported_options_raise(scene, tmp_path, extra, match):
    a = [x for x in args(scene, tmp_path, 1, val=False) if x not in ("--preset", "config_1")] + extra
    with pytest.raises(NotImplementedError, match=match):
        train_detector.main(a)


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
