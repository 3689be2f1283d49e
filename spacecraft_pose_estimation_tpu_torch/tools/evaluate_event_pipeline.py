"""Event-camera pipeline evaluation (evaluate_event_pipeline.sh:97-116).

Port of ``tools/evaluate_event_pipeline.py``: converts the recordings to
undistorted event frames (``tools.convert_aedats``), then runs the
evaluation entry (``evaluate.main``: detector -> landmarks -> PnP per
scene) on them. Both run as functions in this one process, on
``--device`` (cuda unless given ``cpu``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.evaluate_event_pipeline --recordings-dir RECS \\
        --calibration-file calibration.json --landmarks-file landmarks.csv --detector-checkpoint det.npz \\
        --landmark-checkpoint hrnet.npz --output-dir OUT [--tiny] [--device cpu] [KEY VALUE ...]

Checkpoints are the ``.npz`` files ``evaluate.py`` reads.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

from .. import evaluate
from ..device import resolve_device
from . import convert_aedats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Event recordings -> frames -> the evaluation entry")
    ap.add_argument("--recordings-dir", required=True)
    ap.add_argument("--calibration-file", required=True)
    ap.add_argument("--landmarks-file", required=True)
    ap.add_argument("--detector-checkpoint", required=True)
    ap.add_argument("--landmark-checkpoint", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--width", type=int, default=346)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--exposure", type=float, default=0.01)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--input-size", type=int, default=768)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE overrides forwarded to the evaluator")
    return ap


def main(argv: Sequence[str] | None = None) -> dict[str, list]:
    """The command; returns convert_aedats' frames per scene ({scene: [(t_end, path), ...]})."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    frames_dir = os.path.join(args.output_dir, "event-frames")
    scenes = convert_aedats.main([
        "--recordings-dir", args.recordings_dir, "--output-dir", frames_dir,
        "--calibration-file", args.calibration_file, "--width", str(args.width), "--height", str(args.height),
        "--exposure", str(args.exposure), "--device", args.device,
    ])
    evaluate.main([
        "--scenes-dir", frames_dir, "--landmarks-file", args.landmarks_file,
        "--calibration-file", args.calibration_file, "--detector-checkpoint", args.detector_checkpoint,
        "--landmark-checkpoint", args.landmark_checkpoint, "--output-dir", os.path.join(args.output_dir, "results"),
        "--input-size", str(args.input_size), "--batch-size", str(args.batch_size), "--device", args.device,
    ] + (["--tiny"] if args.tiny else []) + list(args.opts))
    return scenes


if __name__ == "__main__":
    main()
