"""Port parity of the fused evaluation entry (``evaluate.run_scene``, ``evaluate.main``).

The JAX side is ``tools/evaluate_pipeline.py``'s fused loop as it composes
the parts (:121-184): the cv2 letterbox of the BGR frame, the detector,
``select_best_box`` over the scale, xywh boxes, RGB frames into
``make_pose_pipeline(solver="ransac")`` with ``fold_in(key(0), start)``
per batch, the last batch padded by its last frame, and the three
artifacts written by ``data/coco_io``. Both sides run ``RCNN_TINY`` and
``HRNET_TINY`` in float32 from one numpy-seeded tree on 10 frames in
batches of 4 (the last one padded); the port gets JAX's RANSAC noise. The
JAX crop runs at ``warp_dtype="float32"``, the port's crop (its deviation
at the entry's ``"bfloat16"`` is pinned by ``tests/test_torch_warp_dtype.py``).

The frames are ten different seeded smooth images (noise blurred over
~3 px, as a camera image is smooth), so every frame has its own box and
keypoints: the test asserts the boxes differ by more than their bound, so
frames swapped, shifted or padded wrongly fail. The 3-D landmarks are the
port's frame-0 keypoints lifted to depth and moved by a known pose.
Bounds: boxes 1e-2 px, keypoints 1e-2 px, confidences 1e-4. Poses: every
frame's pose equals the port's ``pnp_ransac`` on that frame's keypoints
with its own batch's noise row (1e-6), and JAX's to
``tests/test_torch_pnp_ransac.py``'s rule (1e-4 where both packages refine
from the same hypothesis inliers, at least 3 of them; the landmarks fit
frame 0 only, and the other frames' random keypoints leave their poses
undetermined, so the count held is the one measured, ``HELD``). The
decode's quarter-cell step follows the sign of the difference of the
peak's two neighbours, so where they are within 1e-3 of the peak of each
other a box that moves by 1e-4 px moves the keypoint by half a cell: such
joints are counted, bounded and left out of the keypoint bound.
"""

import dataclasses
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.data import coco_io as jcoco
from spacecraft_pose_estimation_tpu.data.detection_dataset import letterbox as j_letterbox
from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HR_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.ops import geometry as jgeo
from spacecraft_pose_estimation_tpu_torch import evaluate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.ops import pnp as tpnp
from spacecraft_pose_estimation_tpu_torch.pipeline import PipelineConfig, make_landmark_stage

from torch_port_util import few_threads  # noqa: F401 (the fixture)
from torch_port_util import jax_gumbel, jax_hypotheses, n, port_hypotheses, random_variables, t, to_jax

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES_HW, N_FRAMES, BATCH, SIZE, J, HYP = (120, 192), 10, 4, 64, 11, 256
HELD = 1  # frames (of 10) whose poses both packages refine from the same >= 3 hypothesis inliers, as measured
CAM = CameraModel(K=np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]]),
                  dist=np.array([-0.05, 0.01, 1e-3, -1e-3, 0.0]), width=192, height=120)
CONFIG = PipelineConfig(image_size=(64, 64), solver="ransac")
R_TRUE = np.asarray(jgeo.quat_to_dcm(jnp.asarray([0.8, 0.3, -0.4, 0.2])))
T_TRUE = np.array([0.3, -0.2, 1.5], np.float32)
J_DET = dataclasses.replace(
    jrcnn.RCNN_TINY, roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32))
T_DET = dataclasses.replace(trcnn.RCNN_TINY, roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32))


def batch_key(start):
    return jax.random.fold_in(jax.random.key(0), start)


def gumbel_fn(start, b):
    return t(jax_gumbel(batch_key(start), b, HYP, J))


def smooth_frame(seed):
    """A seeded uint8 BGR frame, noise blurred over ~3 px (a camera image is smooth)."""
    im = cv2.GaussianBlur(np.random.default_rng(seed).integers(0, 256, (*FRAMES_HW, 3)).astype(np.float32),
                          (0, 0), 3.0)
    return np.clip(np.rint((im - im.mean()) / im.std() * 50 + 128), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    frames = np.stack([smooth_frame(70 + i) for i in range(N_FRAMES)])
    jdet = jrcnn.GeneralizedRCNN(config=J_DET)
    det_vars = random_variables(
        lambda: jdet.init({"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 3)), train=False),
        seed=3, overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05,
                           "cls_score": 0.05})
    jhr = JHRNet(config=J_HR_TINY.with_joints(J))
    hr_vars = random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                               seed=4, overrides={"final_layer": 0.1})
    tdet = trcnn.GeneralizedRCNN(T_DET, device="cpu")
    tdet.load_state_dict(flax_to_state_dict(det_vars))
    thr = build_landmark_model("hrnet_tiny", J, device="cpu")
    thr.load_state_dict(flax_to_state_dict(hr_vars))
    names = [f"img{i:06d}.png" for i in range(N_FRAMES)]
    s = dict(frames=frames, names=names, jdet=jdet, jhr=jhr, det_vars=det_vars, hr_vars=hr_vars, tdet=tdet,
             thr=thr, tmp=tmp_path_factory.mktemp("evaluate"))
    # 3-D landmarks that the port's first keypoints fit exactly at (R_TRUE, T_TRUE)
    first = evaluate.run_scene(frames, names, str(s["tmp"] / "probe"), tdet, thr, np.zeros((J, 3)), CAM,
                               batch_size=BATCH, input_size=SIZE, config=CONFIG, gumbel_fn=gumbel_fn)
    kp = first["preds"][0, :, :2].astype(np.float64)
    norm = n(tpnp._norm_pts(t(kp.astype(np.float32)), t(CAM.K.astype(np.float32)), t(CAM.dist.astype(np.float32))))
    z = np.random.default_rng(8).uniform(8, 12, J)
    cam = np.concatenate([norm * z[:, None], z[:, None]], 1)
    s["lm3d"] = ((cam - T_TRUE) @ R_TRUE).astype(np.float32)  # R^T (p_cam - t)
    return s


def jax_scene(s, out_dir):
    """tools/evaluate_pipeline.py:115-211 at this size, in float32."""
    pose_run = jpipe.make_pose_pipeline(
        s["jhr"], s["lm3d"], CAM.K.astype(np.float32), CAM.dist.astype(np.float32),
        jpipe.PipelineConfig(image_size=(64, 64), solver="ransac", warp_dtype="float32"))

    @jax.jit
    def fused(det_vars, lm_vars, letterboxed, frames, scale, key):
        dets = s["jdet"].apply(det_vars, letterboxed, train=False)
        best = jrcnn.select_best_box(dets, (letterboxed.shape[1], letterboxed.shape[2]))
        best = best / scale[:, None]
        boxes_xywh = jnp.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], axis=1)
        return best, pose_run(lm_vars, frames, boxes_xywh, key)

    det_vars, hr_vars = to_jax(s["det_vars"]), to_jax(s["hr_vars"])
    outs = {"boxes": [], "preds": [], "R": [], "t": []}
    for start in range(0, N_FRAMES, BATCH):
        frames, lbs, scales = [], [], []
        for im in s["frames"][start:start + BATCH]:
            im_bgr = im.astype(np.float32)
            lb, sc = j_letterbox(im_bgr, (SIZE, SIZE))
            frames.append(im_bgr[..., ::-1])
            lbs.append(lb)
            scales.append(sc)
        pad = BATCH - len(frames)
        best, out = fused(det_vars, hr_vars, jnp.asarray(np.stack(lbs + [lbs[-1]] * pad)),
                          jnp.asarray(np.stack(frames + [frames[-1]] * pad)),
                          jnp.asarray(np.asarray(scales + [scales[-1]] * pad, np.float32)), batch_key(start))
        k = len(frames)
        outs["boxes"].append(np.asarray(best)[:k])
        outs["preds"].append(np.concatenate([np.asarray(out["keypoints"])[:k],
                                             np.asarray(out["confidence"])[:k, :, None]], -1))
        outs["R"].append(np.asarray(out["R"])[:k])
        outs["t"].append(np.asarray(out["t"])[:k])
    res = {key: np.concatenate(v) for key, v in outs.items()}
    jcoco.save_pred_mat(res["preds"], os.path.join(out_dir, "pred.mat"))
    jcoco.save_coco(jcoco.detections_to_coco(s["names"], res["boxes"], J, FRAMES_HW[1], FRAMES_HW[0]),
                    os.path.join(out_dir, "real_test.json"))
    jcoco.save_opencv_poses(s["names"], res["R"], res["t"], os.path.join(out_dir, "opencv_poses.json"))
    return res


def quarter_step_ties(s, boxes_xyxy):
    """(frames, joints): the port's heatmap peak has its two neighbours on
    some axis within 1e-3 of the peak of each other."""
    xywh = np.concatenate([boxes_xyxy[:, :2], boxes_xyxy[:, 2:] - boxes_xyxy[:, :2]], 1)
    hm = n(make_landmark_stage(s["thr"], CONFIG)(t(np.ascontiguousarray(s["frames"][..., ::-1])), t(xywh))["heatmaps"])
    hm = np.pad(hm.transpose(0, 3, 1, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))  # (B, J, h + 2, w + 2)
    b, j, h, w = hm.shape
    flat = hm[:, :, 1:-1, 1:-1].reshape(b, j, -1).argmax(-1)
    y, x = np.unravel_index(flat, (h - 2, w - 2))
    bi, ji = np.indices((b, j))
    peak = np.abs(hm[bi, ji, y + 1, x + 1])
    dx = np.abs(hm[bi, ji, y + 1, x + 2] - hm[bi, ji, y + 1, x])
    dy = np.abs(hm[bi, ji, y + 2, x + 1] - hm[bi, ji, y, x + 1])
    return (np.minimum(dx, dy) < 1e-3 * peak)


def ransac_per_batch(s, port_preds, jax_preds):
    """Per frame, from each package's own keypoints and its batch's noise
    (the last batch padded by its last frame): whether both packages
    refine from the same hypothesis inliers, at least 3 of them, and the
    pose the port's ``pnp_ransac`` gives that frame called on its own."""
    same, R, T = [], [], []
    K32, d32 = CAM.K.astype(np.float32), CAM.dist.astype(np.float32)
    for start in range(0, N_FRAMES, BATCH):
        k = min(BATCH, N_FRAMES - start)
        rows = lambda a: np.concatenate([a[start:start + k], np.repeat(a[start + k - 1:start + k], BATCH - k, 0)])
        jp, pp = rows(jax_preds), rows(port_preds)
        want = jax_hypotheses(s["lm3d"], jp[..., :2], jp[..., 2], K32, d32, batch_key(start), HYP)["best_inl"][:k]
        got = port_hypotheses(s["lm3d"], pp[..., :2], pp[..., 2], K32, d32, gumbel_fn(start, BATCH))["best_inl"][:k]
        same += list((got == want).all(-1) & (got.sum(-1) >= 3))
        pose = tpnp.pnp_ransac(t(s["lm3d"]), t(pp[..., :2]), t(K32), t(d32), t(pp[..., 2]),
                               gumbel=gumbel_fn(start, BATCH), num_hypotheses=HYP)
        R.append(n(pose["R"])[:k])
        T.append(n(pose["t"])[:k])
    return np.array(same), np.concatenate(R), np.concatenate(T)


def test_run_scene_matches_jax_entry(setup):
    s = setup
    port_dir, jax_dir = s["tmp"] / "port", s["tmp"] / "jax"
    got = evaluate.run_scene(s["frames"], s["names"], str(port_dir), s["tdet"], s["thr"], s["lm3d"], CAM,
                             batch_size=BATCH, input_size=SIZE, config=CONFIG, gumbel_fn=gumbel_fn)
    want = jax_scene(s, str(jax_dir))
    # real_test.json: the same records, boxes within 1e-2 px
    cj, cp = (json.loads((d / "real_test.json").read_text()) for d in (jax_dir, port_dir))
    assert len(cp["images"]) == len(cp["annotations"]) == N_FRAMES
    assert cp["images"] == cj["images"] and cp["categories"] == cj["categories"]
    for a, b in zip(cp["annotations"], cj["annotations"]):
        np.testing.assert_allclose(a.pop("bbox"), b.pop("bbox"), atol=1e-2)
        np.testing.assert_allclose(a.pop("area"), b.pop("area"), rtol=1e-4)
        assert a == b
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-2)
    # the frames' boxes are told apart by more than that bound, so frames swapped, shifted or padded wrongly fail
    apart = np.abs(got["boxes"][:, None] - got["boxes"][None]).max(-1) + np.eye(N_FRAMES) * 1e9
    print(f"\nsmallest box difference between two frames: {apart.min():.4f} px")
    assert apart.min() > 1e-2
    # pred.mat: keypoints 1e-2 px away from the quarter-step's ties, confidences 1e-4
    pp, pj = (scipy.io.loadmat(d / "pred.mat")["preds"] for d in (port_dir, jax_dir))
    assert pp.shape == pj.shape == (N_FRAMES, J, 3) and pp.dtype == pj.dtype == np.float32
    ties = quarter_step_ties(s, got["boxes"])
    print(f"\njoints at a quarter-step tie: {int(ties.sum())} of {ties.size}")
    assert ties.sum() <= 3
    np.testing.assert_allclose(pp[~ties][:, :2], pj[~ties][:, :2], atol=1e-2)
    np.testing.assert_allclose(pp[..., 2], pj[..., 2], atol=1e-4)
    # opencv_poses.json: finite everywhere, 1e-4 where the pose is determined alike
    qp, qj = (json.loads((d / "opencv_poses.json").read_text()) for d in (port_dir, jax_dir))
    assert [q["image_name"] for q in qp] == [q["image_name"] for q in qj] == s["names"]
    Rp, Rj = (np.array([q["rotation_matrix"] for q in qs]) for qs in (qp, qj))
    Tp, Tj = (np.array([q["T"] for q in qs])[..., 0] for qs in (qp, qj))
    assert np.isfinite(Rp).all() and np.isfinite(Tp).all()
    held, R_own, T_own = ransac_per_batch(s, pp, pj)
    # every frame's pose is RANSAC on its own keypoints with its own batch's noise row
    np.testing.assert_allclose(Rp, R_own, atol=1e-6)
    np.testing.assert_allclose(Tp, T_own, rtol=1e-6, atol=1e-6)
    print(f"\nframes whose poses are held to 1e-4: {int(held.sum())} of {N_FRAMES}")
    assert held.sum() >= HELD
    np.testing.assert_allclose(Rp[held], Rj[held], atol=1e-4)
    np.testing.assert_allclose(Tp[held], Tj[held], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Rp[0], R_TRUE, atol=1e-3)  # the frame the landmarks fit


def _write_scene(s, root, hr_vars=None):
    scene = root / "scenes" / "scene_a"
    scene.mkdir(parents=True)
    for name, im in zip(s["names"], s["frames"]):
        assert cv2.imwrite(str(scene / name), im)
    (root / "landmarks.csv").write_text("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in s["lm3d"].tolist()))
    (root / "calibration.json").write_text(json.dumps(
        {"intrinsics": {"camera_matrix": CAM.K.tolist(), "distortion_coefficients": CAM.dist.tolist()}}))
    for name, tree in (("det", s["det_vars"]), ("hrnet", s["hr_vars"] if hr_vars is None else hr_vars)):
        flat = {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        np.savez(root / f"{name}.npz", **flat)


def cms_variables():
    """A numpy-seeded tree of ``hrnet_tiny_cms``: the CMS heads give 64x64 heatmaps of a 64x64 crop."""
    jhr = JHRNet(config=dataclasses.replace(J_HR_TINY.with_joints(J), head="cms"))
    return random_variables(lambda: jhr.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                            seed=4, overrides={"head": 0.1})


@pytest.mark.parametrize("landmark_model", ["hrnet_tiny", "hrnet_tiny_cms"])
def test_main_writes_the_artifacts_of_run_scene(setup, tmp_path, landmark_model):
    """main() on a scene of PNGs from .npz weights equals run_scene on the
    same frames with models built from the same trees in bf16; with the
    classic head and with the CMS heads."""
    s = setup
    hr_vars = s["hr_vars"] if landmark_model == "hrnet_tiny" else cms_variables()
    _write_scene(s, tmp_path, hr_vars)
    args = ["--scenes-dir", str(tmp_path / "scenes"), "--landmarks-file", str(tmp_path / "landmarks.csv"),
            "--calibration-file", str(tmp_path / "calibration.json"),
            "--detector-checkpoint", str(tmp_path / "det.npz"), "--landmark-checkpoint", str(tmp_path / "hrnet.npz"),
            "--output-dir", str(tmp_path / "out"), "--tiny", "--batch-size", str(BATCH),
            "--input-size", str(SIZE), "--device", "cpu", "MODEL.NAME", landmark_model, "MODEL.IMAGE_SIZE", "[64, 64]"]
    evaluate.main(args)
    det = trcnn.GeneralizedRCNN(trcnn.RCNN_TINY, dtype=torch.bfloat16, device="cpu")
    det.load_state_dict(flax_to_state_dict({"params": s["det_vars"]["params"]}))
    hr = build_landmark_model(landmark_model, J, device="cpu", dtype=torch.bfloat16)
    hr.load_state_dict(flax_to_state_dict(hr_vars))
    cam = CameraModel.from_calibration_json(str(tmp_path / "calibration.json"))
    evaluate.run_scene(s["frames"], s["names"], str(tmp_path / "direct"), det, hr, np.array(s["lm3d"], np.float64),
                       cam, batch_size=BATCH, input_size=SIZE, config=CONFIG)
    out = tmp_path / "out" / "scene_a"
    for f in ("pred.mat", "real_test.json", "opencv_poses.json"):
        assert (out / f).exists()
    np.testing.assert_array_equal(scipy.io.loadmat(out / "pred.mat")["preds"],
                                  scipy.io.loadmat(tmp_path / "direct" / "pred.mat")["preds"])
    for f in ("real_test.json", "opencv_poses.json"):
        assert (out / f).read_text() == (tmp_path / "direct" / f).read_text()
    assert scipy.io.loadmat(out / "pred.mat")["preds"].shape == (N_FRAMES, J, 3)


def test_main_refuses_staged_and_orbax(setup, tmp_path):
    """An orbax checkpoint directory is refused, naming the .npz format: by
    the fused entry, and by the staged one, whose detector stage (a
    separate process) fails and stops the run with its output."""
    s = setup
    _write_scene(s, tmp_path)
    base = ["--scenes-dir", str(tmp_path / "scenes"), "--landmarks-file", str(tmp_path / "landmarks.csv"),
            "--calibration-file", str(tmp_path / "calibration.json"), "--landmark-checkpoint",
            str(tmp_path / "hrnet.npz"), "--output-dir", str(tmp_path / "out"), "--tiny", "--device", "cpu"]
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match=r"\.npz"):
        evaluate.main(base + ["--detector-checkpoint", str(tmp_path / "orbax_ckpt")])
    with pytest.raises(RuntimeError, match=r"stage failed(.|\n)*export_boxes(.|\n)*\.npz"):
        evaluate.main(base + ["--detector-checkpoint", str(tmp_path / "orbax_ckpt"), "--staged"])


def test_help_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['evaluate', '--help']\n"
            "try:\n"
            "    runpy.run_module('spacecraft_pose_estimation_tpu_torch.evaluate', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pandas', 'yaml', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--detector-checkpoint" in proc.stdout and "--device" in proc.stdout
