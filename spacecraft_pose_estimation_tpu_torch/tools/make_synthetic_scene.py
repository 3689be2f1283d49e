"""A labelled synthetic spacecraft scene (port of ``tools/make_synthetic_scene.py``, its own copy).

    python -m spacecraft_pose_estimation_tpu_torch.tools.make_synthetic_scene render \\
        --output-dir S [--num-frames 400 --width 1280 --height 720 --fps 30 --seed 0]
    python -m spacecraft_pose_estimation_tpu_torch.tools.make_synthetic_scene gt \\
        --scene-dir S --event-frames-dir E --gt-dir G

``render`` draws a shaded polyhedral craft (a body box and two solar
panels) on a smooth 6-DoF trajectory through a pinhole camera with numpy
and OpenCV, and writes what the DVS training pipeline reads:

  frames/          the source video frames (``tools.v2e``'s input)
  scene.json       the trajectory's closed-form parameters (the exact pose
                   at any fractional frame)
  landmarks.csv    the 12 body-frame landmarks (x, y, z)
  calibration.json the intrinsics and zero distortion

``gt`` writes ``pose_<stem>.json`` and ``camera_intrinsics_<stem>.txt`` for
each event frame that ``tools.v2e`` wrote (the COCO conversion looks GT up
by event-frame stem), at the trajectory's pose at that stem's time. Host
code (numpy, OpenCV, pandas): it takes no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np


def craft_geometry():
    """(landmarks (12, 3), faces): the body's 8 corners and the first two
    corners of each panel; faces as (vertices, base grey)."""
    bx, by, bz = 0.5, 0.4, 0.7  # body half-extents
    body = np.array(
        [[sx * bx, sy * by, sz * bz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    )
    # panels: thin quads extending +-x, slightly tilted
    pw, pl = 0.9, 0.55
    panel_r = np.array(
        [[bx + 0.1, -pl, 0.05], [bx + 0.1 + pw, -pl, -0.05],
         [bx + 0.1 + pw, pl, -0.05], [bx + 0.1, pl, 0.05]], np.float64
    )
    panel_l = panel_r * np.array([-1.0, 1.0, 1.0])
    landmarks = np.concatenate([body, panel_r[:2], panel_l[:2]], axis=0)

    faces = [
        (body[[0, 1, 3, 2]], 150),  # -x
        (body[[4, 5, 7, 6]], 170),  # +x
        (body[[0, 1, 5, 4]], 120),  # -y
        (body[[2, 3, 7, 6]], 200),  # +y
        (body[[0, 2, 6, 4]], 100),  # -z
        (body[[1, 3, 7, 5]], 220),  # +z
        (panel_r, 60),
        (panel_l, 60),
    ]
    return landmarks, faces


def pose_at(scene: dict, phase: float):
    """(R, t) at fractional frame ``phase``, in closed form: a constant
    axis-angle rate after ``rvec0``, sinusoids about ``t0``."""
    import cv2

    w = np.asarray(scene["omega"])  # rad/frame axis-angle rate
    R0, _ = cv2.Rodrigues(np.asarray(scene["rvec0"]))
    Rp, _ = cv2.Rodrigues(w * phase)
    R = Rp @ R0
    t0 = np.asarray(scene["t0"])
    amp = np.asarray(scene["t_amp"])
    frq = np.asarray(scene["t_freq"])
    ph0 = np.asarray(scene["t_phase"])
    t = t0 + amp * np.sin(frq * phase + ph0)
    return R, t


def render_frame(scene, phase, W, H, K):
    """(H, W, 3) uint8: the faces far to near (painter's algorithm), each
    Lambert-shaded and drawn with three grid lines, so that motion makes
    events inside the silhouette as well as at its rim."""
    import cv2

    _, faces = craft_geometry()
    R, t = pose_at(scene, phase)
    img = np.zeros((H, W, 3), np.uint8)
    light = np.array([0.3, -0.5, -0.8])
    light /= np.linalg.norm(light)

    order = []
    for verts, gray in faces:
        cam = verts @ R.T + t
        order.append((cam[:, 2].mean(), verts, gray, cam))
    order.sort(key=lambda x: -x[0])
    for _, verts, gray, cam in order:
        n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
        n = R @ (n / (np.linalg.norm(n) + 1e-12))
        shade = 0.35 + 0.65 * abs(float(n @ light))
        uv = cam @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        poly = uv.astype(np.int32)
        g = int(np.clip(gray * shade, 0, 255))
        cv2.fillConvexPoly(img, poly, (g, g, g))
        for a in np.linspace(0.2, 0.8, 3):
            p0 = (uv[0] * (1 - a) + uv[3] * a).astype(np.int32)
            p1 = (uv[1] * (1 - a) + uv[2] * a).astype(np.int32)
            cv2.line(img, tuple(p0), tuple(p1), (int(g * 0.6),) * 3, 2)
    return img


def cmd_render(args) -> None:
    import cv2
    import pandas as pd

    rng = np.random.default_rng(args.seed)
    os.makedirs(os.path.join(args.output_dir, "frames"), exist_ok=True)
    W, H = args.width, args.height
    f = 0.9 * H
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    scene = {
        "num_frames": args.num_frames,
        "fps": args.fps,
        "width": W,
        "height": H,
        "K": K.tolist(),
        "rvec0": (rng.normal(size=3) * 0.8).tolist(),
        # a tumble of 0.8 deg a frame: dense events, and a 1.5x-padded box
        # holds over 16 frames
        "omega": (axis * np.deg2rad(0.8)).tolist(),
        "t0": [0.0, 0.0, float(rng.uniform(5.5, 6.5))],
        "t_amp": [0.6, 0.4, 0.8],
        "t_freq": [2 * np.pi / args.num_frames * 2,
                   2 * np.pi / args.num_frames * 3,
                   2 * np.pi / args.num_frames],
        "t_phase": rng.uniform(0, 2 * np.pi, 3).tolist(),
    }
    with open(os.path.join(args.output_dir, "scene.json"), "w") as fjson:
        json.dump(scene, fjson, indent=1)

    landmarks, _ = craft_geometry()
    pd.DataFrame(landmarks, columns=["x", "y", "z"]).to_csv(
        os.path.join(args.output_dir, "landmarks.csv"), index=False
    )
    with open(os.path.join(args.output_dir, "calibration.json"), "w") as fjson:
        json.dump(
            {"intrinsics": {"camera_matrix": K.tolist(),
                            "distortion_coefficients": [0, 0, 0, 0, 0]}},
            fjson,
        )

    for i in range(args.num_frames):
        img = render_frame(scene, float(i), W, H, K)
        cv2.imwrite(os.path.join(args.output_dir, "frames", f"{i:05d}.png"), img)
    print(f"rendered {args.num_frames} frames -> {args.output_dir}/frames")


def cmd_gt(args) -> None:
    with open(os.path.join(args.scene_dir, "scene.json")) as f:
        scene = json.load(f)
    K = np.asarray(scene["K"])
    stems = sorted(
        int(os.path.splitext(p)[0])
        for p in os.listdir(args.event_frames_dir)
        if p.endswith((".bmp", ".png"))
    )
    if not stems:
        raise SystemExit(f"no event frames in {args.event_frames_dir}")
    os.makedirs(args.gt_dir, exist_ok=True)
    # a stem is a frame's time on v2e's clock; the last stem is the last
    # source frame, and stems map to source phases linearly
    max_stem = max(stems[-1], 1)
    last_phase = scene["num_frames"] - 1
    for s in stems:
        phase = s / max_stem * last_phase
        R, t = pose_at(scene, phase)
        np.savetxt(os.path.join(args.gt_dir, f"camera_intrinsics_{s}.txt"), K)
        with open(os.path.join(args.gt_dir, f"pose_{s}.json"), "w") as f:
            json.dump({"rotation": R.tolist(), "translation": t.tolist()}, f)
    print(f"wrote GT for {len(stems)} event frames -> {args.gt_dir}")


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("--output-dir", required=True)
    r.add_argument("--num-frames", type=int, default=400)
    r.add_argument("--width", type=int, default=1280)
    r.add_argument("--height", type=int, default=720)
    r.add_argument("--fps", type=float, default=30.0)
    r.add_argument("--seed", type=int, default=0)
    r.set_defaults(fn=cmd_render)
    g = sub.add_parser("gt")
    g.add_argument("--scene-dir", required=True)
    g.add_argument("--event-frames-dir", required=True)
    g.add_argument("--gt-dir", required=True)
    g.set_defaults(fn=cmd_gt)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
