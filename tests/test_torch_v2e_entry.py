"""The port's event commands against the JAX package's tools.

``tools.v2e`` (``--device cpu``) against ``tools/v2e.py`` under
``SPE_PLATFORM=cpu`` on the same frames: the ``clean`` preset with
``--sigma_thres 0`` (no random draw reaches the events), once with SloMo x2
from a ``--slomo_model`` file the test writes in the official layout, once
without SloMo with a crop, a time window, COUNT frames and every event
output. Bars: the events as a multiset of (x, y, p, t in whole
microseconds), at most EVENT_SHARE of them unmatched (the emulator's
log-rounding allowance, ``tests/test_torch_events_emulator.py``; read
here: 0), the CSV and AEDAT2 event words identical when the events are,
and the event frames equal on at least 1 - EVENT_SHARE of their pixels.
``e2v``, ``aedat_to_csv`` and ``convert_aedats`` against their JAX tools:
identical files. ``evaluate_event_pipeline --tiny --device cpu`` on two
AEDAT2 recordings: its frames are the JAX ``convert_aedats.py``'s, and its
artifacts are ``evaluate.main``'s on those frames.
"""

import collections
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import scipy.io
import torch

from spacecraft_pose_estimation_tpu_torch.convert import flatten_variables, module_to_flax
from spacecraft_pose_estimation_tpu_torch.events import aedat4 as taedat4
from spacecraft_pose_estimation_tpu_torch.events import io as tio
from spacecraft_pose_estimation_tpu_torch.events import slomo as tslomo
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from torch_port_util import few_threads  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_SHARE = 1e-3
COMMANDS = ("v2e", "e2v", "aedat_to_csv", "convert_aedats", "evaluate_event_pipeline")


def run_jax_tool(tool: str, args: list, cwd) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", SPE_PLATFORM="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", f"{tool}.py"), *map(str, args)],
                       capture_output=True, text=True, env=env, cwd=cwd, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def port_tool(tool: str):
    import importlib

    return importlib.import_module(f"spacecraft_pose_estimation_tpu_torch.tools.{tool}")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """6 PNG frames of 64x48: a bright blob moving over a smooth texture;
    and a SuperSloMo checkpoint in the official layout."""
    d = tmp_path_factory.mktemp("v2e")
    rng = np.random.default_rng(0)
    (d / "frames").mkdir()
    ys, xs = np.mgrid[0:48, 0:64]
    tex = cv2.GaussianBlur(rng.uniform(0, 255, (48, 64)).astype(np.float32), (0, 0), 2)
    for i in range(6):
        blob = 160 * np.exp(-((xs - 10 - 7 * i) ** 2 + (ys - 24) ** 2) / 60.0)
        assert cv2.imwrite(str(d / "frames" / f"{i:03d}.png"), np.clip(0.5 * tex + blob + 20, 0, 255).astype(np.uint8))
    ref = tslomo.SuperSloMo(1, device="cpu")
    g = np.random.default_rng(1)
    ckpt = {key: {k: torch.from_numpy(g.normal(0, 1 / np.sqrt(v[0].numel()) if v.dim() == 4 else 0.02,
                                               tuple(v.shape)).astype(np.float32))
                  for k, v in sub.state_dict().items()}
            for key, sub in (("state_dictFC", ref.flow_comp), ("state_dictAT", ref.arb_interp))}
    torch.save(ckpt, d / "slomo.ckpt")
    return d


def event_keys(ev: np.ndarray) -> collections.Counter:
    return collections.Counter(zip(ev[:, 1].astype(int), ev[:, 2].astype(int), ev[:, 3].astype(int),
                                   np.rint(ev[:, 0] * 1e6).astype(np.int64)))


def assert_events_match(got: np.ndarray, want: np.ndarray):
    missing = sum((event_keys(want) - event_keys(got)).values()) + sum((event_keys(got) - event_keys(want)).values())
    assert len(want) > 100 and missing <= EVENT_SHARE * len(want), (len(got), len(want), missing)


def assert_frames_match(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names
    diff = sum(int((cv2.imread(os.path.join(dir_a, f)) != cv2.imread(os.path.join(dir_b, f))).sum()) for f in names)
    total = sum(cv2.imread(os.path.join(dir_a, f)).size for f in names)
    assert diff <= EVENT_SHARE * total, (diff, total)


@pytest.mark.parametrize("case", ["slomo", "count_window_outputs"])
def test_v2e_equals_the_jax_tool(clip, tmp_path, case):
    args = ["-i", clip / "frames", "--dvs_params", "clean", "--sigma_thres", "0", "--input_frame_rate", "30",
            "--skip_video_output", "--no_preview", "--dvs_numpy", "ev.npy", "--dvs_text", "ev.csv"]
    if case == "slomo":
        args += ["--slomo_upsample", "2", "--slomo_model", clip / "slomo.ckpt", "--dvs_exposure", "duration", "0.01"]
    else:
        args += ["--crop", "2", "3", "1", "2", "--start_time", "0.03", "--stop_time", "0.2", "--dvs_exposure", "count",
                 "150", "--dvs_aedat2", "ev.aedat", "--dvs_h5", "ev.h5", "--dvs_frame_chunk", "2",
                 "--dvs_vid_full_scale", "3"]
    run_jax_tool("v2e", args + ["-o", tmp_path / "jax"], tmp_path)
    res = port_tool("v2e").main([str(a) for a in args] + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    want = np.load(tmp_path / "jax" / "ev.npy")
    got = np.load(tmp_path / "port" / "ev.npy")
    np.testing.assert_array_equal(got, res.events)
    assert_events_match(got, want)
    if got.shape == want.shape and (got[:, 1:] == want[:, 1:]).all():
        assert (tmp_path / "port" / "ev.csv").read_text() == (tmp_path / "jax" / "ev.csv").read_text()
        if case != "slomo":
            assert (tmp_path / "port" / "ev.aedat").read_bytes()[-8 * len(got):] == \
                (tmp_path / "jax" / "ev.aedat").read_bytes()[-8 * len(got):]
            np.testing.assert_array_equal(tio.read_events_h5(str(tmp_path / "port" / "ev.h5")),
                                          tio.read_events_h5(str(tmp_path / "jax" / "ev.h5")))
    assert_frames_match(tmp_path / "port" / "event-frames", tmp_path / "jax" / "event-frames")
    assert res.event_frames_u8.shape[0] == len(os.listdir(tmp_path / "port" / "event-frames"))
    if case == "slomo":
        assert res.num_frames == 10 and res.upsample == 2


def test_v2e_unique_folder_and_synthetic_input(tmp_path):
    """A second run into the same folder goes to ``-1``; the synthetic
    input plugin takes a ``module:Class``."""
    v2e = port_tool("v2e")
    args = ["--synthetic_input", "spacecraft_pose_estimation_tpu_torch.events.synthetic_input:MovingBar",
            "--output_width", "40", "--output_height", "30", "--no_frames", "--device", "cpu",
            "-o", str(tmp_path / "o")]
    first = v2e.main(args)
    second = v2e.main(args)
    assert first.num_events > 0 and second.output_folder.endswith("o-1")
    np.testing.assert_array_equal(first.events, second.events)


def test_v2e_auto_timestamp_resolution_takes_the_largest_flow(clip, tmp_path):
    """--auto_timestamp_resolution: one factor for the stream, from the
    largest |flow| over every source pair (the JAX tool's rule)."""
    ckpt = torch.load(clip / "slomo.ckpt")
    model = tslomo.load_checkpoint(tslomo.SuperSloMo(1, device="cpu"), ckpt)
    frames = np.stack([cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) for p in sorted((clip / "frames").iterdir())])
    x = torch.from_numpy(np.pad(frames, ((0, 0), (0, 16), (0, 0)), mode="edge").astype(np.float32) / 255.0)[..., None]
    with torch.inference_mode():
        flow = max(float(model.flow(x[i:i + 1], x[i + 1:i + 2]).abs().max()) for i in range(len(x) - 1))
    res = port_tool("v2e").main(["-i", str(clip / "frames"), "--auto_timestamp_resolution", "--slomo_model",
                                 str(clip / "slomo.ckpt"), "--batch_size", "2", "--no_frames", "--device", "cpu",
                                 "-o", str(tmp_path / "o")])
    assert res.upsample == tslomo.auto_upsampling_factor(flow) >= 2
    assert res.num_frames == (len(frames) - 1) * res.upsample


def test_v2e_refuses_a_slomo_checkpoint_for_rgb_frames(clip, tmp_path):
    """v2e interpolates luma: a checkpoint made for 3-channel frames is
    refused before any frame is interpolated, as the JAX tool cannot run
    one either."""
    rgb = tslomo.SuperSloMo(3, device="cpu")
    ckpt = {"state_dictFC": rgb.flow_comp.state_dict(), "state_dictAT": rgb.arb_interp.state_dict()}
    assert tslomo.checkpoint_channels(ckpt) == 3
    torch.save(ckpt, tmp_path / "rgb.ckpt")
    with pytest.raises(ValueError, match="3-channel"):
        port_tool("v2e").main(["-i", str(clip / "frames"), "--slomo_upsample", "2", "--slomo_model",
                               str(tmp_path / "rgb.ckpt"), "--no_frames", "--device", "cpu",
                               "-o", str(tmp_path / "o")])


def test_e2v_and_aedat_to_csv_equal_the_jax_tools(tmp_path):
    rng = np.random.default_rng(2)
    num = 4000
    ev = np.stack([np.sort(rng.integers(0, 300_000, num)) / 1e6, rng.integers(0, 40, num), rng.integers(0, 30, num),
                   rng.choice([-1.0, 1.0], num)], axis=1)
    tio.write_events_csv(ev, str(tmp_path / "ev.csv"))
    args = ["-i", tmp_path / "ev.csv", "--width", "40", "--height", "30", "--exposure", "0.02", "--keep-polarity"]
    run_jax_tool("e2v", args + ["-o", tmp_path / "je2v"], tmp_path)
    times = port_tool("e2v").main([str(a) for a in args] + ["-o", str(tmp_path / "pe2v"), "--device", "cpu"])
    assert len(times) == 15
    names = sorted(os.listdir(tmp_path / "je2v"))
    assert names == sorted(os.listdir(tmp_path / "pe2v"))
    for f in names:
        assert (tmp_path / "je2v" / f).read_bytes() == (tmp_path / "pe2v" / f).read_bytes(), f
    taedat4.write_aedat4(str(tmp_path / "rec.aedat4"), ev, compression=taedat4.COMPRESSION_LZ4, packet_size=1000)
    run_jax_tool("aedat_to_csv", ["--events_file", tmp_path / "rec.aedat4", "--output_file", tmp_path / "j.csv",
                                  "--chunk", "1500"], tmp_path)
    assert port_tool("aedat_to_csv").main(["--events_file", str(tmp_path / "rec.aedat4"), "--output_file",
                                           str(tmp_path / "p.csv"), "--chunk", "1500"]) == num
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()


def recordings(root, names=("scene_a", "scene_b"), formats=(".aedat", ".aedat")):
    """Seeded 346x260 DAVIS streams, one per scene, ~0.12 s each, and a
    calibration with distortion."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for k, (name, fmt) in enumerate(zip(names, formats)):
        num = 6000
        ev = np.stack([np.sort(rng.integers(0, 120_000, num)) / 1e6, rng.integers(0, 346, num),
                       rng.integers(0, 260, num), rng.choice([-1.0, 1.0], num)], axis=1)
        ev[:, 1] = np.where(rng.random(num) < 0.6, rng.integers(120 + 20 * k, 220, num), ev[:, 1])
        if fmt == ".csv":
            tio.write_events_csv(ev, str(root / f"{name}.csv"))
        elif fmt == ".aedat4":
            taedat4.write_aedat4(str(root / f"{name}.aedat4"), ev, compression=taedat4.COMPRESSION_LZ4)
        else:
            w = tio.AEDat2Writer(str(root / f"{name}{fmt}"), 346, 260)
            w.append(ev)
            w.close()
    calib = {"intrinsics": {"camera_matrix": [[320.0, 0, 173.0], [0, 321.0, 130.0], [0, 0, 1]],
                            "distortion_coefficients": [-0.2, 0.08, 1e-3, -2e-3, 0.0]}}
    (root.parent / "calibration.json").write_text(json.dumps(calib))
    return root.parent / "calibration.json"


def test_convert_aedats_equals_the_jax_tool(tmp_path):
    """AEDAT2, AEDAT4 and CSV recordings: the same undistorted frames, byte for byte."""
    calib = recordings(tmp_path / "recs", ("a", "b", "c"), (".aedat", ".aedat4", ".csv"))
    args = ["--recordings-dir", tmp_path / "recs", "--calibration-file", calib, "--exposure", "0.01"]
    run_jax_tool("convert_aedats", args + ["--output-dir", tmp_path / "jax"], tmp_path)
    scenes = port_tool("convert_aedats").main([str(a) for a in args] + ["--output-dir", str(tmp_path / "port"),
                                                                          "--device", "cpu"])
    assert sorted(scenes) == ["a", "b", "c"]
    for scene in scenes:
        names = sorted(os.listdir(tmp_path / "jax" / scene))
        assert names == sorted(os.listdir(tmp_path / "port" / scene)) and len(names) == 13
        for f in names:
            assert (tmp_path / "jax" / scene / f).read_bytes() == (tmp_path / "port" / scene / f).read_bytes(), f


def test_evaluate_event_pipeline_tiny_on_two_aedat2_scenes(tmp_path):
    """The whole command on the CPU with the tiny detector and HRNet: its
    frames equal the JAX convert_aedats.py's, and its artifacts equal
    evaluate.main's on those frames."""
    calib = recordings(tmp_path / "recs")
    gen = torch.Generator().manual_seed(0)
    det = trcnn.GeneralizedRCNN(trcnn.RCNN_TINY, device="cpu", generator=gen)
    hr = build_landmark_model("hrnet_tiny", 11, device="cpu", generator=torch.Generator().manual_seed(1))
    np.savez(tmp_path / "det.npz", **flatten_variables(module_to_flax(det)))
    np.savez(tmp_path / "hr.npz", **flatten_variables(module_to_flax(hr)))
    lm = np.random.default_rng(4).normal(0, 0.5, (11, 3))
    (tmp_path / "landmarks.csv").write_text("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in lm.tolist()))
    common = ["--calibration-file", str(calib), "--landmarks-file", str(tmp_path / "landmarks.csv"),
              "--detector-checkpoint", str(tmp_path / "det.npz"), "--landmark-checkpoint", str(tmp_path / "hr.npz")]
    opts = ["MODEL.NAME", "hrnet_tiny", "MODEL.IMAGE_SIZE", "[64, 64]"]
    scenes = port_tool("evaluate_event_pipeline").main(
        ["--recordings-dir", str(tmp_path / "recs"), "--output-dir", str(tmp_path / "out"), "--tiny",
         "--input-size", "64", "--batch-size", "4", "--device", "cpu", *common, *opts])
    assert sorted(scenes) == ["scene_a", "scene_b"] and all(len(v) == 12 for v in scenes.values())
    run_jax_tool("convert_aedats", ["--recordings-dir", tmp_path / "recs", "--calibration-file", calib,
                                    "--output-dir", tmp_path / "jax_frames"], tmp_path)
    for scene in scenes:
        for f in sorted(os.listdir(tmp_path / "jax_frames" / scene)):
            assert (tmp_path / "jax_frames" / scene / f).read_bytes() == \
                (tmp_path / "out" / "event-frames" / scene / f).read_bytes(), f
    from spacecraft_pose_estimation_tpu_torch import evaluate

    evaluate.main(["--scenes-dir", str(tmp_path / "jax_frames"), "--output-dir", str(tmp_path / "direct"), "--tiny",
                   "--input-size", "64", "--batch-size", "4", "--device", "cpu", *common, *opts])
    for scene in scenes:
        out, direct = tmp_path / "out" / "results" / scene, tmp_path / "direct" / scene
        preds = scipy.io.loadmat(out / "pred.mat")["preds"]
        assert preds.shape == (12, 11, 3) and np.isfinite(preds).all()
        np.testing.assert_array_equal(preds, scipy.io.loadmat(direct / "pred.mat")["preds"])
        for f in ("real_test.json", "opencv_poses.json"):
            assert (out / f).read_text() == (direct / f).read_text()


@pytest.mark.parametrize("tool", COMMANDS)
def test_event_command_help_runs_without_jax(tool):
    code = ("import runpy, sys\n"
            f"sys.argv = ['{tool}', '--help']\n"
            "try:\n"
            f"    runpy.run_module('spacecraft_pose_estimation_tpu_torch.tools.{tool}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'spacecraft_pose_estimation_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert tool == "aedat_to_csv" or "--device" in proc.stdout
