"""Ground-truth poses -> COCO keypoints json, both of the reference's converters in one command (port of ``tools/convert_to_coco.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.convert_to_coco blender --frames-dir SPLIT \\
        --gt-dir GT --landmarks-file landmarks.csv --output-dir OUT [--image-width 1280 --image-height 720]
    python -m spacecraft_pose_estimation_tpu_torch.tools.convert_to_coco speedplus --dataset-dir D \\
        --landmarks-mat pts.mat --camera-json camera.json --output-dir OUT [--dataset-type synthetic --split train]

``blender`` (``events_to_coco_dicts.py``): for each split folder of
``--frames-dir``, each frame's GT by its stem, ``pose_<stem>.json``
{"rotation": 3x3, "translation": 3} and ``camera_intrinsics_<stem>.txt``,
projected into ``OUT/<prefix>_<split>.json`` (images and annotations
shuffled with seed 0). ``speedplus`` (``speedplus_to_coco_dicts.py``): the
SPEED+ split json's quaternions and translations with ``camera.json`` and
the landmarks ``.mat`` (in pixels, scaled by the pixel pitch), projected
with distortion at 1920x1200 with the reference's 1900-px visibility test
and every keypoint marked visible; image ids from ``imgNNN`` names.

The landmarks CSV is read with pandas, as the JAX tool reads it. The
quaternion -> DCM runs in float32, as the JAX tool's does (JAX without
x64); the projection in float64. Host code: it takes no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np
import torch

from ..data import coco_io
from ..data.camera import CameraModel
from ..ops.geometry import quat_to_dcm


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    b = sub.add_parser("blender")
    b.add_argument("--frames-dir", required=True)
    b.add_argument("--gt-dir", required=True)
    b.add_argument("--landmarks-file", required=True)
    b.add_argument("--output-prefix", default="synthetic")
    b.add_argument("--output-dir", required=True)
    b.add_argument("--image-width", type=int, default=1280)
    b.add_argument("--image-height", type=int, default=720)
    b.add_argument("--splits", nargs="*", default=["train", "test", "validation"])

    s = sub.add_parser("speedplus")
    s.add_argument("--dataset-dir", required=True)
    s.add_argument("--landmarks-mat", required=True)
    s.add_argument("--camera-json", required=True)
    s.add_argument("--dataset-type", default="synthetic")
    s.add_argument("--split", default="train")
    s.add_argument("--output-dir", required=True)
    return ap


def blender(args) -> dict[str, str]:
    landmarks = coco_io.load_landmarks_csv(args.landmarks_file)
    written = {}
    for split in args.splits:
        split_dir = os.path.join(args.frames_dir, split)
        names, Rs, ts, ids = [], [], [], []
        K = None
        for fname in sorted(os.listdir(split_dir)):
            frame_id = int(fname.split(".")[0])
            K = np.loadtxt(os.path.join(args.gt_dir, f"camera_intrinsics_{frame_id}.txt"))
            with open(os.path.join(args.gt_dir, f"pose_{frame_id}.json")) as f:
                pose = json.load(f)
            names.append(fname)
            Rs.append(np.asarray(pose["rotation"]))
            ts.append(np.asarray(pose["translation"]))
            ids.append(frame_id)
        coco = coco_io.poses_to_coco(names, np.stack(Rs), np.stack(ts), landmarks, K, args.image_width,
                                     args.image_height, image_ids=ids, shuffle_seed=0)
        out = os.path.join(args.output_dir, f"{args.output_prefix}_{split}.json")
        coco_io.save_coco(coco, out)
        print(f"wrote {out} ({len(names)} frames)")
        written[split] = out
    return written


def speedplus(args) -> dict[str, str]:
    import scipy.io

    cam = CameraModel.from_speedplus_json(args.camera_json)
    pts = np.array(scipy.io.loadmat(args.landmarks_mat)["pts"]) * cam.pixel_pitch
    with open(os.path.join(args.dataset_dir, args.dataset_type, args.split + ".json")) as f:
        poses = json.load(f)
    tkey = "r_Vo2To_vbs_true" if "r_Vo2To_vbs_true" in poses[0] else "translation"
    qkey = "q_vbs2tango_true" if "q_vbs2tango_true" in poses[0] else "rotation"
    names, Rs, ts, ids = [], [], [], []
    for p in poses:
        q = torch.tensor(p[qkey], dtype=torch.float32)
        # the reference projects with [quat2dcm(q)^T | t] (speed_plus_utils/utils.py:119-121)
        Rs.append(quat_to_dcm(q).numpy().T)
        names.append(p["filename"])
        ts.append(np.asarray(p[tkey], np.float64))
        ids.append(int(p["filename"].split(".")[0][3:].lstrip("0") or "0"))
    coco = coco_io.poses_to_coco(
        names, np.stack(Rs), np.stack(ts), pts, cam.K, width=1920, height=1200, image_ids=ids, dist=cam.dist,
        visibility_width=1900,  # the reference's test (speedplus_to_coco_dicts.py:137)...
        force_visible=True,  # ...whose two branches both append vis=2 (:15-27)
    )
    out = os.path.join(args.output_dir, f"{args.dataset_type}_{args.split}.json")
    coco_io.save_coco(coco, out)
    print(f"wrote {out} ({len(names)} frames)")
    return {args.split: out}


def main(argv: Sequence[str] | None = None) -> dict[str, str]:
    """The command; also a function: returns each split's json path."""
    args = build_parser().parse_args(argv)
    return blender(args) if args.mode == "blender" else speedplus(args)


if __name__ == "__main__":
    main()
