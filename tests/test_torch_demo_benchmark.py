"""Port parity of ``tools.demo`` and ``tools.benchmark`` (the JAX ``tools/demo.py`` and ``tools/benchmark.py``).

The demo: one seeded smooth 192x120 frame and a box through
``demo.run`` with ``HRNET_TINY`` (11 joints, 64x64) in float32, against
the JAX ``make_landmark_stage`` (``solver="none"``) and
``make_pose_pipeline`` (``solver="ransac"``, key 0) on the same numpy-seeded
variables, the JAX crop at ``warp_dtype="float32"`` (the port's crop; the
served ``"bfloat16"`` deviation is pinned by ``tests/test_torch_warp_dtype.py``)
and the port given JAX's Gumbel noise. The 3-D landmarks are the port's
keypoints lifted to depth and moved by a known pose, so RANSAC is
determined. Bars, those of ``tests/test_torch_evaluate.py``: keypoints 1e-2
px (joints whose heatmap peak has its two neighbours within 1e-3 of the
peak of each other, where the decode's quarter step can flip, are
counted, at most 1, and left out), confidences 1e-4; R and t 1e-4 where
both packages refine from the same hypothesis inliers, at least 3
(``tests/test_torch_pnp_ransac.py``'s float32 rule), which this scene
must meet. The command runs on a checkpoint directory the port's
``CheckpointManager`` wrote (the trainer's format), in bf16, and writes the
overlay; an orbax directory is refused.

The benchmark: its batch functions bit-equal to the numpy batches the JAX
tool builds inline (the targets within 1e-6); one ``train`` step (Adam
1e-3) and one ``train-det`` step (SGD 1e-3, momentum 0.9, JAX's sampling
draws) of the tiny models in float32 on carried-across weights against
JAX's steps, with the train-step bars (losses and ``grad_norm`` 1e-4
relative; parameters within 1 lr, at most 50 entries beyond 1e-3 lr, or 1%
of the detector's); the commands ``--task train-det`` and ``--task data``
on the CPU print JAX's lines.
"""

import dataclasses
import json

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu.ops import heatmap as jhm
from spacecraft_pose_estimation_tpu.train import detection_state as jds
from spacecraft_pose_estimation_tpu.train import optim as joptim, state as jstate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from spacecraft_pose_estimation_tpu_torch.data import coco_io
from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp
from spacecraft_pose_estimation_tpu_torch.tools import benchmark, demo
from spacecraft_pose_estimation_tpu_torch.train import detection_state as tds
from spacecraft_pose_estimation_tpu_torch.train import state as tstate
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager

from torch_port_util import few_threads  # noqa: F401 (the fixture)
from torch_port_util import jax_detection_draws, jax_gumbel, jax_hypotheses, n, port_hypotheses, random_variables, \
    smooth_frames, t, to_jax

pytestmark = pytest.mark.usefixtures("few_threads")

J, SIZE, HYP = 11, 64, 256
BOX = [40.0, 22.0, 90.0, 76.0]  # x y w h in the 192x120 frame
CAM = CameraModel(K=np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]]),
                  dist=np.array([-0.05, 0.01, 1e-3, -1e-3, 0.0]), width=192, height=120)
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)
DET_OVERRIDES = {"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05, "cls_score": 0.05}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    bgr = smooth_frames(21, 1, 120, 192)[0]
    jm = JHRNet(config=J_HR_TINY.with_joints(J))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False),
                                 seed=4, overrides={"final_layer": 0.1})
    model = build_landmark_model("hrnet_tiny", J, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    first, _ = demo.run(bgr, model, BOX, image_size=(SIZE, SIZE))
    kp = n(first["keypoints"][0]).astype(np.float64)
    # 3-D landmarks that the port's keypoints fit exactly at (R_TRUE, T_TRUE)
    norm = n(tpnp._norm_pts(t(kp.astype(np.float32)), t(CAM.K.astype(np.float32)), t(CAM.dist.astype(np.float32))))
    z = np.random.default_rng(8).uniform(8, 12, J)
    lm3d = ((np.concatenate([norm * z[:, None], z[:, None]], 1) - T_TRUE) @ R_TRUE).astype(np.float32)
    root = tmp_path_factory.mktemp("demo")
    cv2.imwrite(str(root / "frame.png"), bgr)
    pd.DataFrame(lm3d.astype(np.float64), columns=["x", "y", "z"]).to_csv(root / "landmarks.csv", index=False)
    (root / "calibration.json").write_text(json.dumps({"intrinsics": {
        "camera_matrix": CAM.K.tolist(), "distortion_coefficients": CAM.dist.tolist()}}))
    return dict(bgr=bgr, jm=jm, variables=variables, model=model, lm3d=lm3d, root=root)


def quarter_step_ties(heatmaps):
    """(J,) bool: the heatmap peak has its two neighbours on some axis within 1e-3 of the peak of each other."""
    hm = np.pad(heatmaps[0].transpose(2, 0, 1), ((0, 0), (1, 1), (1, 1)))
    j, h, w = hm.shape
    y, x = np.unravel_index(hm[:, 1:-1, 1:-1].reshape(j, -1).argmax(-1), (h - 2, w - 2))
    ji = np.arange(j)
    dx = np.abs(hm[ji, y + 1, x + 2] - hm[ji, y + 1, x])
    dy = np.abs(hm[ji, y + 2, x + 1] - hm[ji, y, x + 1])
    return np.minimum(dx, dy) < 1e-3 * np.abs(hm[ji, y + 1, x + 1])


def jax_config(solver):
    return jpipe.PipelineConfig(image_size=(SIZE, SIZE), solver=solver, warp_dtype="float32")


def test_demo_landmark_route_matches_jax(scene):
    out, drawn = demo.run(scene["bgr"], scene["model"], BOX, image_size=(SIZE, SIZE))
    frames = jnp.asarray(scene["bgr"][None, ..., ::-1].astype(np.float32))
    want = jax.jit(jpipe.make_landmark_stage(scene["jm"], jax_config("none")))(
        to_jax(scene["variables"]), frames, jnp.asarray([BOX], jnp.float32))
    assert "R" not in out
    ties = quarter_step_ties(n(out["heatmaps"]))
    print(f"\njoints at a quarter-step tie: {int(ties.sum())} of {J}")
    assert ties.sum() <= 1
    np.testing.assert_allclose(n(out["keypoints"])[0][~ties], np.asarray(want["keypoints"])[0][~ties], atol=1e-2)
    np.testing.assert_allclose(n(out["confidence"]), np.asarray(want["confidence"]), atol=1e-4)
    assert drawn.shape == scene["bgr"].shape and drawn.dtype == np.uint8
    assert (drawn != scene["bgr"]).any(-1).sum() > 100  # the box and the keypoints are drawn on a copy
    assert not np.shares_memory(drawn, scene["bgr"])


def test_demo_pose_route_matches_jax(scene):
    key = jax.random.key(0)
    gumbel = t(jax_gumbel(key, 1, HYP, J))
    out, drawn = demo.run(scene["bgr"], scene["model"], BOX, scene["lm3d"], CAM, (SIZE, SIZE), gumbel=gumbel)
    frames = jnp.asarray(scene["bgr"][None, ..., ::-1].astype(np.float32))
    K32, d32 = CAM.K.astype(np.float32), CAM.dist.astype(np.float32)
    want = jax.jit(jpipe.make_pose_pipeline(scene["jm"], scene["lm3d"], K32, d32, jax_config("ransac")))(
        to_jax(scene["variables"]), frames, jnp.asarray([BOX], jnp.float32), key)
    ties = quarter_step_ties(n(out["heatmaps"]))
    assert ties.sum() <= 1
    kp_t, kp_j = n(out["keypoints"]), np.asarray(want["keypoints"])
    np.testing.assert_allclose(kp_t[0][~ties], kp_j[0][~ties], atol=1e-2)
    np.testing.assert_allclose(n(out["confidence"]), np.asarray(want["confidence"]), atol=1e-4)
    conf_t, conf_j = n(out["confidence"]), np.asarray(want["confidence"])
    inl_t = port_hypotheses(scene["lm3d"], kp_t, conf_t, K32, d32, n(gumbel))["best_inl"]
    inl_j = jax_hypotheses(scene["lm3d"], kp_j, conf_j, K32, d32, key, HYP)["best_inl"]
    assert (inl_t == inl_j).all() and inl_t.sum() >= 3  # both refine from the same inliers
    assert np.isfinite(n(out["R"])).all() and np.isfinite(n(out["t"])).all()
    np.testing.assert_allclose(n(out["R"]), np.asarray(want["R"]), atol=1e-4)
    np.testing.assert_allclose(n(out["t"]), np.asarray(want["t"]), rtol=1e-4, atol=1e-4)
    # the lifted landmarks pin the pose the scene was built with
    np.testing.assert_allclose(n(out["R"])[0], R_TRUE, atol=1e-3)
    plain, _ = demo.run(scene["bgr"], scene["model"], BOX, image_size=(SIZE, SIZE))
    assert (drawn != demo.run(scene["bgr"], scene["model"], BOX, image_size=(SIZE, SIZE))[1]).any()  # projections
    np.testing.assert_array_equal(n(plain["keypoints"]), kp_t)


def test_demo_command_on_a_trainer_checkpoint(scene, tmp_path, capsys):
    """``main`` restores the latest step of a ``CheckpointManager`` directory
    (the trainer's ``OUT/checkpoints``) into a bf16 model and writes the overlay."""
    from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer

    ck = tmp_path / "checkpoints"
    mgr = CheckpointManager(str(ck))
    model = scene["model"]
    mgr.save(3, tstate.TrainState(model, build_optimizer("adam", model.parameters(), 1e-3), step=3), {"epoch": 0})
    root, out_path = scene["root"], tmp_path / "demo.jpg"
    args = ["--image", str(root / "frame.png"), "--checkpoint", str(ck), "--model", "hrnet_tiny", "--image-size",
            str(SIZE), str(SIZE), "--box", *map(str, BOX), "--output", str(out_path), "--device", "cpu"]
    out = demo.main(args + ["--landmarks-file", str(root / "landmarks.csv"),
                            "--calibration-file", str(root / "calibration.json")])
    printed = capsys.readouterr().out
    assert "R=" in printed and "t=" in printed and f"wrote {out_path}; mean confidence" in printed
    assert cv2.imread(str(out_path)).shape == scene["bgr"].shape
    assert np.isfinite(n(out["R"])).all() and np.isfinite(n(out["t"])).all()
    # the restored bf16 model is the saved one: the demo of a bf16 copy of it, with the same noise, equals
    bf16 = build_landmark_model("hrnet_tiny", J, device="cpu", dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    lm3d = coco_io.load_landmarks_csv(str(root / "landmarks.csv"))
    same, _ = demo.run(scene["bgr"], bf16, BOX, lm3d, CAM, (SIZE, SIZE))
    for k in ("keypoints", "confidence", "R", "t"):
        np.testing.assert_array_equal(n(out[k]), n(same[k]))
    out = demo.main(args)  # no landmarks: the landmark stage alone
    assert "R" not in out and "R=" not in capsys.readouterr().out


def test_demo_refuses_orbax_and_missing_checkpoints(tmp_path):
    (tmp_path / "orbax" / "5" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        demo.load_model(str(tmp_path / "orbax"), "hrnet_tiny", J, "cpu")
    with pytest.raises(FileNotFoundError):
        demo.load_model(str(tmp_path / "missing"), "hrnet_tiny", J, "cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        demo.load_model(str(tmp_path / "empty"), "hrnet_tiny", J, "cpu")


# the benchmark --------------------------------------------------------------------------------------------------


def jax_train_batch(b, size, joints_n):
    """tools/benchmark.py:158-168."""
    rng = np.random.default_rng(0)
    joints = rng.uniform(0, size, (b, joints_n, 2)).astype(np.float32)
    hm = size // 4
    tgt, tw = jax.vmap(lambda j: jhm.generate_target(j, jnp.ones(joints_n), (size, size), (hm, hm), 2.0))(
        jnp.asarray(joints))
    return {"image": rng.normal(size=(b, size, size, 3)).astype(np.float32), "target": np.asarray(tgt),
            "target_weight": np.asarray(tw)}


def jax_detection_batch(b, size):
    """tools/benchmark.py:224-236."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, size * 0.6, (b, 1))
    y0 = rng.uniform(0, size * 0.6, (b, 1))
    wh = rng.uniform(size * 0.15, size * 0.35, (b, 2))
    return {"image": rng.normal(0, 60, (b, size, size, 3)).astype(np.float32) + 120,
            "gt_boxes": np.asarray(np.concatenate([x0, y0, x0 + wh[:, :1], y0 + wh[:, 1:]], 1)[:, None, :],
                                   np.float32),
            "gt_classes": np.zeros((b, 1), np.int32), "gt_valid": np.ones((b, 1), bool)}


@pytest.mark.parametrize("b,size,joints_n", [(2, 64, 11), (3, 96, 5)])
def test_benchmark_batches_equal_jax(b, size, joints_n):
    want = jax_train_batch(b, size, joints_n)
    got = {k: n(v) for k, v in benchmark.train_batch(b, size, joints_n, "cpu").items()}
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_allclose(got["target"], want["target"], atol=1e-6)
    np.testing.assert_array_equal(got["target_weight"], want["target_weight"])
    assert want["target"].max() > 0.99
    want = jax_detection_batch(b, size)
    got = {k: n(v) for k, v in benchmark.detection_batch(b, size, "cpu").items()}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(n(benchmark.eval_batch(b, size, "cpu")),
                                  np.random.default_rng(0).normal(size=(b, size, size, 3)).astype(np.float32))


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def test_benchmark_train_step_matches_jax():
    jm = JHRNet(config=J_HR_TINY.with_joints(J))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False),
                                 seed=0, overrides={"final_layer": 0.1})
    batch = jax_train_batch(2, SIZE, J)
    js = jstate.TrainState.create(jm, to_jax(variables), joptim.build_optimizer("adam", 1e-3))
    js, jmet = jax.jit(jstate.make_train_step())(js, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_landmark_model("hrnet_tiny", J, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    tmet = tstate.make_train_step()(benchmark.landmark_state(model), benchmark.train_batch(2, SIZE, J, "cpu"))
    for k in ("loss", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    jp, tp = flat(js.params), flat(state_dict_to_flax(model.state_dict(), stats=set())["params"])
    dp = np.concatenate([(np.abs(tp[k] - jp[k]) / 1e-3).ravel() for k in jp])
    assert dp.max() <= 1.0 and (dp > 1e-3).sum() <= 50, (dp.max(), (dp > 1e-3).sum())


def test_benchmark_train_det_step_matches_jax():
    b = 2
    jmodel = jrcnn.GeneralizedRCNN(config=jrcnn.RCNN_TINY)
    batch = jax_detection_batch(b, SIZE)
    variables = random_variables(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(batch["image"]),
                                                     train=False), 2, DET_OVERRIDES)
    js = jds.DetTrainState.create(jmodel, to_jax(variables), joptim.build_optimizer("sgd", 1e-3, momentum=0.9))
    key = jax.random.fold_in(jax.random.key(0), 0)
    n_anchors = sum(h * w * 3 for h, w in ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)))
    draws = jax_detection_draws(jmodel, {"params": js.params}, key, b, n_anchors, 32 + 1)
    js, jm = jax.jit(jds.make_detection_train_step(True))(js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    model = trcnn.GeneralizedRCNN(trcnn.RCNN_TINY, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    assert benchmark.detector_config("RCNN_TINY") is trcnn.RCNN_TINY
    tm = tds.make_detection_train_step()(benchmark.detector_state(model), benchmark.detection_batch(b, SIZE, "cpu"),
                                         draws={k: torch.from_numpy(v) for k, v in draws.items()})
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_total", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-6), k
    jp, tp = flat(js.params), flat(state_dict_to_flax(model.state_dict(), stats=set())["params"])
    dp = np.concatenate([(np.abs(tp[k] - jp[k]) / 1e-3).ravel() for k in jp])
    assert dp.max() <= 1.0 and (dp > 1e-3).mean() <= 0.01


def test_benchmark_train_det_command_prints_s_per_iter(capsys):
    """JAX's ``tests/test_tools_smoke.py:316-323`` on the port, with ``--device cpu``."""
    res = benchmark.main(["--task", "train-det", "--model", "RCNN_TINY", "--input-size", "64", "--batch-size", "2",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "s/iter" in out and "images/s" in out and out.startswith("detector train step (RCNN_TINY 64^2 b2): ")
    assert np.isfinite(res["ms_per_step"])


def test_benchmark_data_command(tmp_path, capsys):
    frames = smooth_frames(3, 4, 48, 64)
    images, anns = [], []
    for i, im in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), im)
        images.append(coco_io.image_record(f"f{i}.png", 64, 48, i))
        kps = np.concatenate([np.random.default_rng(i).uniform(5, 40, (3, 2)), np.full((3, 1), 2.0)], 1)
        anns.append(coco_io.keypoint_annotation(kps, [2.0, 2.0, 40.0, 40.0], i, i))
    coco_io.save_coco(coco_io.build_coco_dict(images, anns, 3), str(tmp_path / "t.json"))
    res = benchmark.main(["--task", "data", "--train-json", str(tmp_path / "t.json"), "--image-dir", str(tmp_path),
                          "--batch-size", "2", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("data loader: ") and res["images_per_s"] > 0
