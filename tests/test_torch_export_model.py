"""``tools.export_model``: the pose pipeline as a ``torch.export`` program, on the CPU.

A seeded ``hrnet_tiny`` checkpoint (11 joints) is exported at batch 2, 64^2
crops of 160x120 uint8 frames, ``--device cpu``, in bf16 with the GN
solver, the JAX tool's ``serving_fn``. The 3-D landmarks are the port's
float32 keypoints on those frames lifted to depth and moved by a known pose
(``test_torch_serving.py``'s construction), so that both packages' solvers
have one exact pose to find. Checked:

* the program holds K1 as ``spe_port::crop_bilinear``; loaded back with
  ``torch.export.load`` in a fresh process that imports only the port's
  ``ops.warp`` first, it equals the eager ``make_pose_pipeline`` on the
  same checkpoint bit for bit;
* the computation the program holds, over the weights in float32, against
  the JAX ``make_pose_pipeline`` (``warp_dtype="float32"``, the exact crop
  mode, as the serving test runs it): the serving test's bounds,
  keypoints 1e-2 px, confidences 1e-4 of their peak, R, t and q 1e-4 (in
  bf16 the frameworks' roundings move argmax cells);
* without a card the command raises unless given ``--device cpu``, and it
  needs a checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu_torch import pipeline
from spacecraft_pose_estimation_tpu_torch.convert import module_to_flax
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.tools import export_model
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer
from spacecraft_pose_estimation_tpu_torch.train.state import TrainState

from torch_port_util import few_threads, n, smooth_frames, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, B, FRAME_WH, SIZE = 11, 2, (160, 120), 64
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
DIST = np.zeros(5, np.float32)
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)
FIELDS = ("keypoints", "confidence", "R", "t", "quat")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_model")
    model = build_landmark_model("hrnet_tiny", J, device="cpu", generator=torch.Generator().manual_seed(3))
    CheckpointManager(str(root / "ck")).save(0, TrainState(model, build_optimizer("adam", model.parameters(), 1e-3)))
    frames = smooth_frames(4, B, FRAME_WH[1], FRAME_WH[0])
    boxes = np.array([[30.0, 20.0, 70.0, 60.0], [60.0, 35.0, 55.0, 70.0]], np.float32)
    # the port's float32 keypoints on these frames, lifted to depths 8-12 and moved by (R_TRUE, T_TRUE)
    kp = n(pipeline.make_landmark_stage(model.eval(), pipeline.PipelineConfig(image_size=(SIZE, SIZE)))(
        t(frames), t(boxes))["keypoints"][0])
    z = np.random.default_rng(8).uniform(8, 12, J)
    cam = np.stack([(kp[:, 0] - K[0, 2]) / K[0, 0] * z, (kp[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    lm3d = ((cam - T_TRUE) @ R_TRUE).astype(np.float32)  # R^T (p_cam - t)
    (root / "landmarks.csv").write_text("x,y,z\n" + "".join(f"{x!r},{y!r},{zz!r}\n" for x, y, zz in lm3d.tolist()))
    (root / "calibration.json").write_text(json.dumps(
        {"intrinsics": {"camera_matrix": K.tolist(), "distortion_coefficients": DIST.tolist()}}))
    argv = ["--checkpoint", str(root / "ck"), "--landmarks-file", str(root / "landmarks.csv"),
            "--calibration-file", str(root / "calibration.json"), "--model", "hrnet_tiny", "--image-size",
            str(SIZE), str(SIZE), "--frame-size", *map(str, FRAME_WH), "--batch-size", str(B), "--output",
            str(root / "pose.pt2"), "--device", "cpu"]
    program = export_model.main(argv)
    return dict(root=root, argv=argv, program=program, model=model, frames=frames, boxes=boxes, lm3d=lm3d)


def test_loaded_program_equals_the_eager_pipeline(exported):
    """Loaded in a fresh process that imports only the port's op library
    first, the program gives the eager pipeline's outputs bit for bit."""
    ops = [node.target for node in exported["program"].graph.nodes if node.op == "call_function"]
    assert torch.ops.spe_port.crop_bilinear.default in ops
    root = exported["root"]
    torch.save({"frames": t(exported["frames"]), "boxes": t(exported["boxes"])}, root / "inputs.pt")
    code = ("import sys, torch\n"
            "import spacecraft_pose_estimation_tpu_torch.ops.warp\n"
            f"inp = torch.load({str(root / 'inputs.pt')!r})\n"
            f"out = torch.export.load({str(root / 'pose.pt2')!r}).module()(inp['frames'], inp['boxes'])\n"
            f"torch.save(list(out), {str(root / 'outputs.pt')!r})\n"
            "assert 'jax' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(root / "outputs.pt")
    prog = export_model.build_program(export_model.build_parser().parse_args(exported["argv"]), torch.device("cpu"))
    eager = pipeline.make_pose_pipeline(prog.model, prog.lm3d, prog.K, prog.dist, prog.config)(
        t(exported["frames"]), t(exported["boxes"]))
    for field, g in zip(FIELDS, got):
        assert torch.equal(g, eager[field]), field
    assert bool(torch.isfinite(got[2]).all() and torch.isfinite(got[3]).all())


def test_pipeline_matches_the_jax_pipeline(exported):
    """The exported computation (``pipeline.pose_outputs``, which the
    program equals bit for bit above) over the weights in float32 against
    the JAX pipeline. (In bf16 the two frameworks round the heatmaps
    differently, and one of these 22 keypoints took another argmax cell,
    36 px away.) The landmarks fit frame 0's keypoints at the known pose."""
    model = exported["model"]
    config = pipeline.PipelineConfig(image_size=(SIZE, SIZE), solver="gn")
    got = pipeline.make_pose_pipeline(model.eval(), exported["lm3d"], K, DIST, config)(
        t(exported["frames"]), t(exported["boxes"]))
    jm = JHRNet(config=J_TINY.with_joints(J))
    run = jpipe.make_pose_pipeline(jm, exported["lm3d"], K, DIST,
                                   jpipe.PipelineConfig(image_size=(SIZE, SIZE), solver="gn", warp_dtype="float32"))
    want = jax.jit(run)(to_jax(module_to_flax(model)), jnp.asarray(exported["frames"], jnp.float32),
                        jnp.asarray(exported["boxes"]))
    got = {k: n(got[k]) for k in FIELDS}
    np.testing.assert_allclose(got["keypoints"], np.asarray(want["keypoints"]), atol=1e-2)
    conf = np.asarray(want["confidence"])
    np.testing.assert_allclose(got["confidence"], conf, atol=1e-4 * np.abs(conf).max())
    for key in ("R", "t", "quat"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["R"][0], R_TRUE, atol=1e-3)
    np.testing.assert_allclose(got["t"][0], T_TRUE, atol=1e-2)


def test_command_needs_a_device_and_a_checkpoint(exported, tmp_path):
    argv = list(exported["argv"])
    argv[argv.index("--checkpoint") + 1] = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        export_model.main(argv)
    if torch.cuda.is_available():
        return
    without = argv[:argv.index("--device")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_model.main(without)
