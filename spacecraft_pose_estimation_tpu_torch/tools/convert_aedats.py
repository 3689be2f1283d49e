"""Event recordings -> undistorted event frames per scene
(v2e/convert_aedats.py + aedat_to_csv.py's command).

Port of ``tools/convert_aedats.py``: each AEDAT-2.0, AEDAT-4 or events-CSV
recording in ``--recordings-dir`` becomes a scene folder with its
``events.csv`` and one ``{t_ms}.bmp`` a duration-exposure window,
undistorted with the calibration's intrinsics (``data/camera.CameraModel``,
``cv2.undistort``). The windows are summed on ``--device`` (cuda unless
given ``cpu``; float64, equal to the JAX tool's numpy sums); the readers,
the undistortion and the image files run on the host.

    python -m spacecraft_pose_estimation_tpu_torch.tools.convert_aedats --recordings-dir RECS \\
        --output-dir FRAMES --calibration-file calibration.json [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np
import torch

from ..data.camera import CameraModel
from ..device import resolve_device
from ..events import io as ev_io

RECORDING_EXTENSIONS = (".aedat", ".aedat2", ".aedat4", ".csv")


def load_events(path: str, width: int, height: int) -> np.ndarray:
    """A recording -> (N, 4) float64 [t s, x, y, p +-1]."""
    if path.endswith((".aedat", ".aedat2")):
        return ev_io.read_aedat2(path, width, height)
    if path.endswith(".csv"):
        return ev_io.read_events_csv(path, force_pos_polarity=False)
    if path.endswith(".aedat4"):
        from ..events.aedat4 import read_aedat4

        ev = read_aedat4(path).astype(np.float64)  # [t_us, x, y, p 0/1]
        ev[:, 0] /= 1e6
        ev[:, 3] = 2 * ev[:, 3] - 1
        return ev
    raise SystemExit(f"unsupported recording format: {path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Event recordings -> undistorted event frames per scene")
    ap.add_argument("--recordings-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--calibration-file", required=True)
    ap.add_argument("--width", type=int, default=346)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--exposure", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Sequence[str] | None = None) -> dict[str, list]:
    """The command; returns {scene: [(t_end seconds, path of its frame), ...]}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    import cv2

    cam = CameraModel.from_calibration_json(args.calibration_file)
    recs = sorted(f for f in os.listdir(args.recordings_dir) if f.endswith(RECORDING_EXTENSIONS))
    scenes = {}
    for rec in recs:
        scene = os.path.splitext(rec)[0]
        out = os.path.join(args.output_dir, scene)
        os.makedirs(out, exist_ok=True)
        events = load_events(os.path.join(args.recordings_dir, rec), args.width, args.height)
        ev_io.write_events_csv(events, os.path.join(out, "events.csv"))
        scenes[scene] = []
        if len(events) == 0:
            continue
        for img01, t_end in ev_io.accumulate_exposure_frames(events, args.width, args.height, args.exposure,
                                                             device=device):
            img = cv2.undistort((img01 * 255).to(torch.uint8).cpu().numpy(), cam.K, cam.dist)
            path = os.path.join(out, f"{t_end * 1e3:.0f}.bmp")
            cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
            scenes[scene].append((t_end, path))
        print(f"{scene}: {len(events)} events -> {len(scenes[scene])} frames")
    return scenes


if __name__ == "__main__":
    main()
