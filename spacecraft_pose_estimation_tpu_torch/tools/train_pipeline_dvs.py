"""The DVS training pipeline, ``train_pipeline_hubble_dvx.sh`` (port of ``tools/train_pipeline_dvs.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.train_pipeline_dvs --frames-dir FRAMES \\
        --gt-dir GT --landmarks-file landmarks.csv --work-dir WORK [--exposures 0.005 0.01 0.02 0.04] \\
        [--device cpu] [--tiny] [KEY VALUE ...]

The stages, in the JAX driver's order and with its flags:

1. ``tools.v2e`` once an exposure (``clean`` DVS parameters, a duration
   exposure, no SloMo) into ``WORK/events_<exposure>/event-frames``;
2. ``tools.split_images`` of each sweep's frames (seed 0) into
   ``event-frames_split/{train,validation,test}``;
3. ``tools.convert_to_coco blender`` of each split into
   ``event-frames_dicts/synthetic_<split>.json`` (the GT is looked up by
   event-frame stem in ``--gt-dir``);
4. ``tools.train_detector`` with no preset (the X101-32x8d FPN of
   ``config_4`` at ``--detector-input-size``) on the first sweep's training
   split, into ``WORK/detector``;
5. ``tools.train_landmarks --preset events`` on the first sweep (its
   validation split validated each epoch), into ``WORK/landmarks``; the
   ``KEY VALUE`` overrides go to this stage.

``--tiny`` trains ``RCNN_TINY`` and ``hrnet_tiny`` in float32. Unlike the
JAX driver, each stage is called in this process through its ``main``;
none starts a Python of its own. ``--device`` goes to every stage that
takes one. It runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Sequence

from ..device import resolve_device
from . import convert_to_coco, split_images, train_detector, train_landmarks, v2e


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames-dir", required=True, help="source video frames")
    ap.add_argument("--gt-dir", required=True, help="blender GT (poses and intrinsics by event-frame stem)")
    ap.add_argument("--landmarks-file", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--exposures", nargs="*", type=float, default=[0.005, 0.01, 0.02, 0.04],
                    help="v2e exposure sweep (the reference runs 4)")
    ap.add_argument("--image-width", type=int, default=1280)
    ap.add_argument("--image-height", type=int, default=720)
    ap.add_argument("--detector-iters", type=int, default=6000)
    ap.add_argument("--detector-input-size", type=int, default=768)
    ap.add_argument("--detector-batch-size", type=int, default=8)
    ap.add_argument("--landmark-epochs", type=int, default=40)
    ap.add_argument("--tiny", action="store_true", help="tiny models (tests)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE overrides forwarded to the landmark trainer")
    return ap


def main(argv: Sequence[str] | None = None) -> SimpleNamespace:
    """The command; also a function: returns the stages' folders and
    seconds (``seconds[stage]``, the v2e, split and conversion stages summed
    over the sweep)."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    dev = ["--device", args.device]
    os.makedirs(args.work_dir, exist_ok=True)
    seconds: dict[str, float] = {}

    def run(stage: str, tool, cmd: list[str]):
        print("+", tool.__name__.rsplit(".", 1)[-1], " ".join(cmd), flush=True)
        t0 = time.perf_counter()
        out = tool.main(cmd)
        seconds[stage] = seconds.get(stage, 0.0) + time.perf_counter() - t0
        return out

    # 1) v2e sweep: one event-frame set per exposure
    event_dirs = []
    for exp in args.exposures:
        out = os.path.join(args.work_dir, f"events_{exp:g}")
        run("v2e", v2e, ["-i", args.frames_dir, "-o", out, "--dvs_params", "clean",
                         "--dvs_exposure", "duration", str(exp), *dev])
        event_dirs.append(os.path.join(out, "event-frames"))

    # 2) split each sweep's frames
    for d in event_dirs:
        run("split", split_images, ["--input-dir", d, "--output-dir", d + "_split", "--seed", "0"])

    # 3) COCO conversion per sweep (the GT poses are shared across exposures)
    dict_dirs = []
    for d in event_dirs:
        out = d + "_dicts"
        run("convert", convert_to_coco, [
            "blender", "--frames-dir", d + "_split", "--gt-dir", args.gt_dir,
            "--landmarks-file", args.landmarks_file, "--output-dir", out,
            "--image-width", str(args.image_width), "--image-height", str(args.image_height)])
        dict_dirs.append(out)

    # 4) the detector, on the first sweep
    det_out = os.path.join(args.work_dir, "detector")
    det_cmd = ["--train-json", os.path.join(dict_dirs[0], "synthetic_train.json"),
               "--image-dir", event_dirs[0] + "_split/train", "--output", det_out,
               "--max-iter", str(args.detector_iters), "--input-size", str(args.detector_input_size),
               "--batch-size", str(args.detector_batch_size), *dev]
    if args.tiny:
        det_cmd.append("--tiny")
    run("train_detector", train_detector, det_cmd)

    # 5) HRNet, on the first sweep
    lm_out = os.path.join(args.work_dir, "landmarks")
    lm_cmd = ["--preset", "events",
              "--train-json", os.path.join(dict_dirs[0], "synthetic_train.json"),
              "--val-json", os.path.join(dict_dirs[0], "synthetic_validation.json"),
              "--image-dir", event_dirs[0] + "_split/train",
              "--val-image-dir", event_dirs[0] + "_split/validation",
              "--output", lm_out, *dev,
              "TRAIN.END_EPOCH", str(args.landmark_epochs), *args.opts]
    if args.tiny:
        lm_cmd += ["MODEL.NAME", "hrnet_tiny", "MODEL.COMPUTE_DTYPE", "float32"]
    run("train_landmarks", train_landmarks, lm_cmd)

    print("pipeline training complete:", args.work_dir)
    return SimpleNamespace(event_dirs=event_dirs, dict_dirs=dict_dirs, detector_dir=det_out,
                           landmarks_dir=lm_out, seconds=seconds)


if __name__ == "__main__":
    main()
