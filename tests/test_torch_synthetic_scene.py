"""Port parity of ``tools/make_synthetic_scene``: the port's own copy against the JAX package's tool.

``render`` at 160x96 over 6 frames (seed 3) writes byte-equal frames,
``scene.json`` and ``calibration.json``, and a ``landmarks.csv`` equal in
bytes and read back equal; ``gt`` on a folder of event-frame stems writes
byte-equal ``pose_<stem>.json`` and ``camera_intrinsics_<stem>.txt``. The
JAX tool runs in this process with a patched ``sys.argv``. Also: the craft's
12 landmarks (8 body corners, 2 on each panel) and ``gt`` refusing a folder
without event frames.
"""

import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from spacecraft_pose_estimation_tpu_torch.data import coco_io
from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene as tscene

ROOT = Path(__file__).resolve().parents[1]


def run_jax_tool(args):
    old = sys.argv
    sys.argv = ["make_synthetic_scene"] + [str(a) for a in args]
    try:
        runpy.run_path(str(ROOT / "tools" / "make_synthetic_scene.py"), run_name="__main__")
    finally:
        sys.argv = old


def tree(folder: Path) -> dict[str, bytes]:
    return {str(p.relative_to(folder)): p.read_bytes() for p in sorted(folder.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    args = ["--num-frames", "6", "--width", "160", "--height", "96", "--seed", "3"]
    run_jax_tool(["render", "--output-dir", root / "jax"] + args)
    tscene.main(["render", "--output-dir", str(root / "port")] + args)
    return root


def test_render_writes_the_same_files(scenes):
    got, want = tree(scenes / "port"), tree(scenes / "jax")
    assert sorted(got) == sorted(want) == sorted(
        ["calibration.json", "landmarks.csv", "scene.json"] + [f"frames/{i:05d}.png" for i in range(6)])
    for name in want:
        assert got[name] == want[name], name
    lm_port = coco_io.load_landmarks_csv(str(scenes / "port" / "landmarks.csv"))
    np.testing.assert_array_equal(lm_port, coco_io.load_landmarks_csv(str(scenes / "jax" / "landmarks.csv")))
    np.testing.assert_array_equal(lm_port, tscene.craft_geometry()[0])
    # the craft is in view and moves: every frame has lit pixels, and they change
    import cv2

    frames = [cv2.imread(str(scenes / "port" / "frames" / f"{i:05d}.png")) for i in range(6)]
    assert all(f.shape == (96, 160, 3) and f.max() > 0 for f in frames)
    assert any(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))


def test_gt_writes_the_same_poses(scenes, tmp_path):
    ev = tmp_path / "event-frames"
    ev.mkdir()
    for stem in (0, 20, 40, 60, 80, 100, 120, 140, 167):
        (ev / f"{stem}.bmp").write_bytes(b"")
    (ev / "frame_times.txt").write_text("not a frame")
    run_jax_tool(["gt", "--scene-dir", scenes / "jax", "--event-frames-dir", ev, "--gt-dir", tmp_path / "jax_gt"])
    tscene.main(["gt", "--scene-dir", str(scenes / "port"), "--event-frames-dir", str(ev), "--gt-dir",
                 str(tmp_path / "port_gt")])
    got, want = tree(tmp_path / "port_gt"), tree(tmp_path / "jax_gt")
    assert len(want) == 18 and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_craft_geometry_and_pose():
    landmarks, faces = tscene.craft_geometry()
    assert landmarks.shape == (12, 3) and len(faces) == 8
    scene = {"omega": [0.0, 0.01, 0.0], "rvec0": [0.1, 0.2, 0.3], "t0": [0.0, 0.0, 6.0], "t_amp": [0.6, 0.4, 0.8],
             "t_freq": [0.1, 0.2, 0.3], "t_phase": [0.0, 1.0, 2.0]}
    R, t = tscene.pose_at(scene, 2.5)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(t, [0.6 * np.sin(0.25), 0.4 * np.sin(0.5 + 1.0), 6.0 + 0.8 * np.sin(0.75 + 2.0)],
                               atol=1e-12)


def test_gt_refuses_a_folder_without_event_frames(scenes, tmp_path):
    with pytest.raises(SystemExit, match="no event frames"):
        tscene.main(["gt", "--scene-dir", str(scenes / "port"), "--event-frames-dir", str(tmp_path), "--gt-dir",
                     str(tmp_path / "gt")])
    assert not os.path.exists(tmp_path / "gt")
