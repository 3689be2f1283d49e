"""The port's copies of the JAX package's numpy-only modules, and its letterbox.

``config`` (presets, ``apply_overrides``), ``data/camera``, the
``data/coco_io`` subset the evaluation entry writes (files compared as
loaded arrays and parsed JSON), ``load_landmarks_csv`` against the JAX
package's reader, and ``serving.letterbox_linear`` against the
JAX entry's cv2 letterbox (``data/detection_dataset.letterbox``) within
1e-2 grey, in float32.
"""

import dataclasses
import json

import numpy as np
import pytest
import scipy.io
import torch

from spacecraft_pose_estimation_tpu import config as JC
from spacecraft_pose_estimation_tpu.data import coco_io as jcoco
from spacecraft_pose_estimation_tpu.data.camera import CameraModel as JCamera
from spacecraft_pose_estimation_tpu.data.detection_dataset import letterbox as j_letterbox
from spacecraft_pose_estimation_tpu_torch import config as TC
from spacecraft_pose_estimation_tpu_torch.data import coco_io as tcoco
from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel as TCamera
from spacecraft_pose_estimation_tpu_torch.serving import letterbox_linear

from torch_port_util import n, t


def test_presets_equal_jax():
    assert TC.list_presets() == JC.list_presets()
    for name in JC.list_presets():
        assert dataclasses.asdict(TC.get_preset(name)) == dataclasses.asdict(JC.get_preset(name)), name
    with pytest.raises(KeyError, match="unknown preset"):
        TC.get_preset("nope")


@pytest.mark.parametrize("opts", [
    ["TRAIN.LR", "0.01", "MODEL.NAME", "hrnet_tiny"],
    ["MODEL.IMAGE_SIZE", "[256, 192]", "TEST.FLIP_TEST", "true", "TRAIN.END_EPOCH", "3"],
    ["DATASET.DATASET", "lightbox", "TRAIN.LR_STEP", "[5, 7, 9]", "MODEL.SIGMA", "3"],
])
def test_apply_overrides_equal_jax(opts):
    for preset in ("events", "lightbox_cms"):
        got = TC.apply_overrides(TC.get_preset(preset), opts)
        want = JC.apply_overrides(JC.get_preset(preset), opts)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_apply_overrides_errors_equal_jax():
    for mod in (TC, JC):
        with pytest.raises(KeyError, match="unknown config key"):
            mod.apply_overrides(mod.get_preset("events"), ["NOPE.X", "1"])
        with pytest.raises(ValueError, match="KEY VALUE"):
            mod.apply_overrides(mod.get_preset("events"), ["TRAIN.LR"])


def test_camera_loaders_equal_jax(tmp_path):
    calib = tmp_path / "calibration.json"
    calib.write_text(json.dumps({"intrinsics": {"camera_matrix": [[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]],
                                                "distortion_coefficients": [[-0.22, 0.18, 5e-4, -3e-4, -0.02, 0.0]]}}))
    speed = tmp_path / "camera.json"
    speed.write_text(json.dumps({"cameraMatrix": [[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]],
                                 "distCoeffs": [-0.22, 0.18, 5e-4, -3e-4, -0.02], "Nu": 1920, "Nv": 1200,
                                 "ppx": 5.86e-6}))
    pairs = [(cls.from_calibration_json(str(calib), 1920, 1200), cls.from_speedplus_json(str(speed)),
              cls.pinhole(300.0, 301.0, 96.0, 60.0, 192, 120)) for cls in (TCamera, JCamera)]
    pairs = list(zip(*pairs))
    for got, want in pairs:
        np.testing.assert_array_equal(got.K, want.K)
        np.testing.assert_array_equal(got.dist, want.dist)
        assert (got.width, got.height, got.pixel_pitch) == (want.width, want.height, want.pixel_pitch)
        assert got.K.dtype == want.K.dtype and got.dist.shape == want.dist.shape == (5,)


def test_coco_io_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    names = ["img000012.png", "img000013.png", "frame_b.jpg"]
    xy = rng.uniform(0, 1000, (3, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 500, (3, 2))], 1).astype(np.float32)
    preds = rng.normal(500, 200, (3, 11, 3)).astype(np.float32)
    Rs, ts = rng.normal(size=(3, 3, 3)).astype(np.float32), rng.normal(size=(3, 3)).astype(np.float32)
    assert tcoco.frame_image_ids(names) == jcoco.frame_image_ids(names) == [12, 13, 2]
    assert tcoco.category_dict(11) == jcoco.category_dict(11)
    assert tcoco.image_record("a.png", 4, 3, 7) == jcoco.image_record("a.png", 4, 3, 7)
    kp = rng.normal(size=(11, 3))
    assert tcoco.keypoint_annotation(kp, [1, 2, 3, 4], 5, 6) == jcoco.keypoint_annotation(kp, [1, 2, 3, 4], 5, 6)
    assert tcoco.build_coco_dict([], [], 11) == jcoco.build_coco_dict([], [], 11)
    for mod, d in ((tcoco, tmp_path / "port"), (jcoco, tmp_path / "jax")):
        mod.save_pred_mat(preds, str(d / "pred.mat"))
        mod.save_coco(mod.detections_to_coco(names, boxes, 11, 1920, 1200), str(d / "real_test.json"))
        mod.save_opencv_poses(names, Rs, ts, str(d / "opencv_poses.json"))
    a, b = (scipy.io.loadmat(tmp_path / side / "pred.mat")["preds"] for side in ("port", "jax"))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    for f in ("real_test.json", "opencv_poses.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) == json.loads((tmp_path / "jax" / f).read_text())
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("text", [
    "x,y,z\n0.1,0.2,0.3\n-1.5,2.25,3e-2\n4,5,6\n",
    "name,z,x,w,y\np1,1.0,2.0,9,3.0\np2,-4.5,0.125,9,7.75\n",  # other columns, another order
])
def test_load_landmarks_csv_equal_pandas(tmp_path, text):
    path = tmp_path / "landmarks.csv"
    path.write_text(text)
    got, want = tcoco.load_landmarks_csv(str(path)), jcoco.load_landmarks_csv(str(path))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,size", [((1200, 1920), 768), ((333, 517), 128), ((517, 333), 200)])
def test_letterbox_linear_equals_cv2(hw, size):
    frame = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3)).astype(np.uint8)
    want, want_scale = j_letterbox(frame.astype(np.float32), (size, size))
    got, scale = letterbox_linear(t(frame)[None], size)
    assert scale == want_scale and got.dtype == torch.float32 and got.shape == (1, size, size, 3)
    np.testing.assert_allclose(n(got[0]), want, atol=1e-2)
