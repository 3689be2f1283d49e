"""The port's domain-adaptation trainer end to end on the CPU: ``tools/train_landmarks_da``.

As the JAX package's ``tests/test_da_cli_smoke.py``, in process: 4 source
and 4 target 64x64 PNG frames of seeded noise, 3 landmarks each, the
``lightbox_cms`` preset with ``hrnet_tiny_cms`` at 32x32 -> 32x32, float32,
batches of 2 source and 2 target images (2 updates an epoch), the full
ResNet-34 discriminator, and 2 target frames to validate on. Checked:

* one epoch writes ``metrics.json`` with finite ``loss``, ``d_loss``,
  ``hm_loss`` and ``adv_loss``, the generator's checkpoint (``state.pt``
  and the ``.npz``) in ``checkpoints/``, both models and both optimizers in
  ``da_state/``, ``pred_val_real.mat`` and the best checkpoint; and
  ``tools/test_landmarks`` reads the ``.npz`` to the same predictions;
* an ``AUTO_RESUME`` run to 2 epochs continues from ``da_state`` at the
  next epoch and ends bit-equal to one 2-epoch run (the batch streams and
  the draws are those of the steps);
* a single-scale model is refused, and ``--help`` runs without JAX
  (``tests/test_torch_port_rules.py`` holds that it runs on CUDA or raises
  without ``--device``).
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

from spacecraft_pose_estimation_tpu_torch.data import coco_io
from spacecraft_pose_estimation_tpu_torch.tools import test_landmarks, train_landmarks_da

from torch_port_util import few_threads  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["MODEL.NAME", "hrnet_tiny_cms", "MODEL.IMAGE_SIZE", "[32, 32]", "MODEL.HEATMAP_SIZE", "[32, 32]",
        "MODEL.COMPUTE_DTYPE", "float32", "TRAIN.BATCH_SIZE_PER_CHIP", "2", "TRAIN.BATCH_SIZE_ADVERSARIAL", "2",
        "TEST.BATCH_SIZE_PER_CHIP", "2"]


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    root = tmp_path_factory.mktemp("da")
    rng = np.random.default_rng(0)
    for domain, count in (("source", 4), ("target", 4), ("validation", 2)):
        d = root / ("target" if domain == "validation" else domain)
        d.mkdir(exist_ok=True)
        images, anns = [], []
        for i in range(count):
            name = f"{domain}{i}.png"
            assert cv2.imwrite(str(d / name), rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
            images.append(coco_io.image_record(name, 64, 64, i))
            kp = np.column_stack([rng.uniform(8, 56, 3), rng.uniform(8, 56, 3), np.full(3, 2.0)])
            anns.append(coco_io.keypoint_annotation(kp, [8.0, 8.0, 32.0, 32.0], i, i))
        coco_io.save_coco(coco_io.build_coco_dict(images, anns, 3), str(root / f"{domain}.json"))
    return root


def da_args(root, out, epochs):
    return ["--preset", "lightbox_cms", "--train-json", str(root / "source.json"), "--image-dir", str(root / "source"),
            "--target-json", str(root / "target.json"), "--target-image-dir", str(root / "target"),
            "--val-json", str(root / "validation.json"), "--output", str(out), "--device", "cpu",
            *OPTS, "TRAIN.END_EPOCH", str(epochs)]


def steps_in(directory):
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


def test_one_epoch_writes_checkpoints_and_resumes(domains, tmp_path):
    out = tmp_path / "resumed"
    train_landmarks_da.main(da_args(domains, out, 1))
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [2]
    assert all(np.isfinite(rows[0][k]) for k in ("loss", "d_loss", "hm_loss", "adv_loss"))
    assert steps_in(out / "checkpoints") == [2] and steps_in(out / "da_state") == [2]
    gen = torch.load(out / "checkpoints" / "2" / "state.pt", weights_only=True)
    da = torch.load(out / "da_state" / "2" / "state.pt", weights_only=True)
    assert set(gen) == {"model", "optimizer", "step"} and gen["step"] == 2
    assert set(da) == {"generator", "discriminator", "gen_optimizer", "disc_optimizer", "step"} and da["step"] == 2
    assert all(torch.equal(v, da["generator"][k]) for k, v in gen["model"].items())
    assert json.loads((out / "checkpoints" / "best.json").read_text())["step"] == 2
    preds = scipy.io.loadmat(str(out / "pred_val_real.mat"))["preds"]
    assert preds.shape == (2, 3, 3) and np.isfinite(preds).all()
    # the generator's .npz goes straight into the staged landmark stage
    test_landmarks.main(["--preset", "lightbox_cms", "--test-json", str(domains / "validation.json"),
                         "--image-dir", str(domains / "target"), "--checkpoint",
                         str(out / "checkpoints" / "2" / "model.npz"), "--output", str(tmp_path), "--pred-name",
                         "pred", "--device", "cpu"] + OPTS)
    np.testing.assert_allclose(scipy.io.loadmat(str(tmp_path / "pred.mat"))["preds"], preds, atol=1e-4)

    # AUTO_RESUME (on by default) from da_state: epoch 1 only, then equal to an uninterrupted run
    train_landmarks_da.main(da_args(domains, out, 2))
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
    assert steps_in(out / "da_state") == [2, 4]
    train_landmarks_da.main(da_args(domains, tmp_path / "whole", 2))
    whole = torch.load(tmp_path / "whole" / "da_state" / "4" / "state.pt", weights_only=True)
    resumed = torch.load(out / "da_state" / "4" / "state.pt", weights_only=True)
    for part in ("generator", "discriminator"):
        for k, v in whole[part].items():
            assert torch.equal(v, resumed[part][k]), (part, k)
    for part in ("gen_optimizer", "disc_optimizer"):
        for i, s in whole[part]["state"].items():
            assert all(torch.equal(s[k], resumed[part]["state"][i][k]) for k in s), (part, i)


def test_a_single_scale_model_is_refused(domains, tmp_path):
    with pytest.raises(SystemExit, match="multi-scale"):
        train_landmarks_da.main(da_args(domains, tmp_path, 1) + ["MODEL.NAME", "hrnet_tiny"])


def test_help_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['train_landmarks_da', '--help']\n"
            "try:\n"
            "    runpy.run_module('spacecraft_pose_estimation_tpu_torch.tools.train_landmarks_da', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--target-json" in proc.stdout and "--device" in proc.stdout
