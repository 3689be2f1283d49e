"""The evaluation entry: scenes of frames in, the reference's three artifacts out.

Port of ``tools/evaluate_pipeline.py``. The fused mode, per batch of
frames: BGR letterbox -> detector -> best box -> RGB crop -> heatmap
model -> decode -> RANSAC PnP; per scene it writes ``real_test.json``
(the best boxes), ``pred.mat`` (keypoints and confidences) and
``opencv_poses.json`` (R, T), as the JAX entry does. ``--staged`` runs
the three stage commands of ``tools/`` as separate processes on the same
file contract (``export_boxes``, ``test_landmarks``, ``export_poses``).

    python -m spacecraft_pose_estimation_tpu_torch.evaluate \\
        --scenes-dir DIR --landmarks-file landmarks.csv --calibration-file calibration.json \\
        --detector-checkpoint det.npz --landmark-checkpoint hrnet.npz --output-dir OUT [--device cpu] [--staged]

Checkpoints are ``.npz`` files of the Flax variable trees with
``/``-joined keys (``params/backbone/stem/conv/kernel``,
``batch_stats/...``); the README shows how to write them with JAX.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
from typing import Callable, Sequence

import numpy as np
import torch

from . import config as C
from .convert import flax_to_state_dict
from .data import coco_io
from .data.camera import CameraModel
from .device import resolve_device
from .models import build_landmark_model
from .models.rcnn import FASTER_RCNN_X101_SERVING, FASTER_RCNN_X101_SPACECRAFT, RCNN_TINY, GeneralizedRCNN, \
    select_best_box
from .pipeline import PipelineConfig, make_pose_pipeline
from .serving import letterbox_linear

Tensor = torch.Tensor
FRAME_EXTENSIONS = (".png", ".jpg", ".bmp")


def run_scene(frames_bgr_uint8, names: Sequence[str], out_dir: str, detector, landmark_model,
              landmarks: np.ndarray, cam: CameraModel, *, batch_size: int = 8, input_size: int = 768,
              config: PipelineConfig | None = None,
              gumbel_fn: Callable[[int, int], Tensor] | None = None,
              generator: torch.Generator | None = None) -> dict[str, np.ndarray]:
    """One scene through the fused pipeline; writes its three artifacts to ``out_dir``.

    ``frames_bgr_uint8`` is (N, H, W, 3) uint8 BGR frames: anything whose
    slices give an array or a tensor (a tensor, an array, a lazy reader
    such as :class:`SceneFrames`). ``config`` defaults to RANSAC at
    512x512. The last batch is padded by repeating its last frame. RANSAC's noise for the batch
    that starts at frame ``start`` is ``gumbel_fn(start, batch_size)``
    when given, else drawn from ``generator`` (seed 0 when None) on the
    detector's device.

    Returns {boxes (N, 4) XYXY, preds (N, J, 3) [x, y, conf], R (N, 3, 3),
    t (N, 3)} as numpy.
    """
    config = config if config is not None else PipelineConfig(solver="ransac")
    device = next(detector.parameters()).device
    if gumbel_fn is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pose_run = make_pose_pipeline(landmark_model, landmarks.astype(np.float32), cam.K.astype(np.float32),
                                  cam.dist.astype(np.float32), config)
    outs: dict[str, list] = {"boxes": [], "preds": [], "R": [], "t": []}
    for start in range(0, len(names), batch_size):
        chunk = torch.as_tensor(frames_bgr_uint8[start:start + batch_size]).to(device)
        k = chunk.shape[0]
        frames = torch.cat([chunk, chunk[-1:].expand(batch_size - k, *chunk.shape[1:])])
        with torch.inference_mode():
            # the detector sees BGR letterboxes, the landmark crop RGB frames
            lb, scale = letterbox_linear(frames, input_size)
            best = select_best_box(detector(lb), (input_size, input_size)) / scale
            xywh = torch.stack([best[:, 0], best[:, 1], best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]], dim=1)
            gumbel = gumbel_fn(start, batch_size) if gumbel_fn is not None else None
            out = pose_run(frames.flip(-1), xywh, gumbel=gumbel, generator=generator)
        outs["boxes"].append(best[:k].cpu().numpy())
        outs["preds"].append(torch.cat([out["keypoints"][:k], out["confidence"][:k, :, None]], -1).cpu().numpy())
        outs["R"].append(out["R"][:k].cpu().numpy())
        outs["t"].append(out["t"][:k].cpu().numpy())
    res = {key: np.concatenate(v) for key, v in outs.items()}
    height, width = int(frames.shape[1]), int(frames.shape[2])
    coco_io.save_pred_mat(res["preds"], os.path.join(out_dir, "pred.mat"))
    coco = coco_io.detections_to_coco(names, res["boxes"], landmarks.shape[0], width, height)
    coco_io.save_coco(coco, os.path.join(out_dir, "real_test.json"))
    coco_io.save_opencv_poses(names, res["R"], res["t"], os.path.join(out_dir, "opencv_poses.json"))
    return res


def orbax_directory_error(path: str) -> ValueError:
    """The error for a checkpoint path that is a JAX orbax directory."""
    return ValueError(
        f"{path} is a directory (an orbax checkpoint?); the port reads a .npz of the Flax variables "
        "with '/'-joined keys, e.g. np.savez(path, **flax.traverse_util.flatten_dict(variables, sep='/'))"
    )


def load_npz_variables(path: str) -> dict:
    """A ``.npz`` of ``/``-joined Flax variable keys -> the nested tree."""
    if os.path.isdir(path):
        raise orbax_directory_error(path)
    tree: dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return tree


class SceneFrames:
    """A scene's frame files, read as BGR uint8 with cv2 one slice at a time."""

    def __init__(self, cv2, scene_dir: str, files: Sequence[str]):
        self.cv2, self.scene_dir, self.files = cv2, scene_dir, list(files)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: slice) -> np.ndarray:
        frames = []
        for f in self.files[index]:
            im = self.cv2.imread(os.path.join(self.scene_dir, f), self.cv2.IMREAD_COLOR)
            if im is None:
                raise ValueError(f"cv2 cannot read the frame {os.path.join(self.scene_dir, f)}")
            frames.append(im)
        return np.stack(frames)


def require_cv2():
    """OpenCV, which reading frames from files needs."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("reading frames from files needs OpenCV (cv2), which is not installed") from e
    return cv2


def load_detector(path: str, tiny: bool, serving: bool, dtype, device) -> GeneralizedRCNN:
    """The entry's detector (``RCNN_TINY``, or X101-32x8d in its serving or
    evaluation preset) with the ``params`` of a ``.npz`` checkpoint."""
    cfg = RCNN_TINY if tiny else (FASTER_RCNN_X101_SERVING if serving else FASTER_RCNN_X101_SPACECRAFT)
    detector = GeneralizedRCNN(cfg, dtype=dtype, device=device)
    detector.load_state_dict(flax_to_state_dict({"params": load_npz_variables(path)["params"]}))
    return detector


def load_landmark_model(path: str, name: str, num_joints: int, dtype, device):
    """``build_landmark_model(name)`` with the variables of a ``.npz`` checkpoint."""
    model = build_landmark_model(name, num_joints, device=device, dtype=dtype)
    model.load_state_dict(flax_to_state_dict(load_npz_variables(path)))
    return model


def scene_list(args) -> list[str]:
    return args.scenes or sorted(
        d for d in os.listdir(args.scenes_dir) if os.path.isdir(os.path.join(args.scenes_dir, d))
    )


def run_staged(args, logger) -> None:
    """The three stages per scene, each a separate process of the port's
    stage commands on the reference's file contract (the JAX
    ``evaluate_pipeline.run_staged``): detector -> real_test.json,
    landmarks -> pred.mat, PnP -> opencv_poses.json. Each stage gets
    ``--device``; ``--serving`` does not reach the detector stage, as in
    the JAX entry."""
    cv2 = require_cv2()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))

    def run(tool: str, cmd: list[str]) -> None:
        cmd = [sys.executable, "-m", f"{__package__}.tools.{tool}", *cmd, "--device", args.device]
        logger.info("staged: %s", " ".join(cmd))
        r = subprocess.run(cmd, capture_output=True, text=True, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"stage failed: {cmd}\nstdout:{r.stdout[-3000:]}\nstderr:{r.stderr[-3000:]}")

    num_landmarks = coco_io.load_landmarks_csv(args.landmarks_file).shape[0]
    for scene in scene_list(args):
        scene_dir = os.path.join(args.scenes_dir, scene)
        out_dir = os.path.join(args.output_dir, scene)
        os.makedirs(out_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(scene_dir) if f.lower().endswith(FRAME_EXTENSIONS))
        if not files:
            logger.warning("scene %s: no frames, skipping", scene)
            continue
        h, w = cv2.imread(os.path.join(scene_dir, files[0])).shape[:2]
        run("export_boxes", ["--image-dir", scene_dir, "--checkpoint", args.detector_checkpoint,
                             "--output-dir", out_dir, "--image-width", str(w), "--image-height", str(h),
                             "--input-size", str(args.input_size), "--landmarks-count", str(num_landmarks),
                             "--batch-size", str(args.batch_size), "--no-debug-images"]
            + (["--tiny"] if args.tiny else []))
        run("test_landmarks", ["--preset", args.preset, "--test-json", os.path.join(out_dir, "real_test.json"),
                               "--image-dir", scene_dir, "--checkpoint", args.landmark_checkpoint,
                               "--output", out_dir, "--pred-name", "pred", *args.opts])
        run("export_poses", ["--frames-dir", scene_dir,
                             "--detection-annotations", os.path.join(out_dir, "real_test.json"),
                             "--pose-annotations", os.path.join(out_dir, "pred.mat"),
                             "--landmarks-file", args.landmarks_file, "--calibration-file", args.calibration_file,
                             "--output-dir", out_dir, "--no-render"])
        logger.info("scene %s done (staged) -> %s", scene, out_dir)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes-dir", required=True, help="dir with per-scene frame folders")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--landmarks-file", required=True)
    ap.add_argument("--calibration-file", required=True)
    ap.add_argument("--detector-checkpoint", required=True, help=".npz of the detector's Flax variables")
    ap.add_argument("--landmark-checkpoint", required=True, help=".npz of the landmark model's Flax variables")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--preset", default="events")
    ap.add_argument("--tiny", action="store_true", help="the tiny detector (RCNN_TINY)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--input-size", type=int, default=768)
    ap.add_argument("--serving", action="store_true",
                    help="the serving detector preset (512/256 proposals; the same weights and topology)")
    ap.add_argument("--staged", action="store_true",
                    help="the three stages (tools/export_boxes, test_landmarks, export_poses) as separate "
                         "processes on the file contract")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("evaluate")
    if args.staged:
        resolve_device(args.device)
        return run_staged(args, logger)
    device = resolve_device(args.device)
    cv2 = require_cv2()

    cfg = C.apply_overrides(C.get_preset(args.preset), args.opts)
    cam = CameraModel.from_calibration_json(args.calibration_file)
    landmarks = coco_io.load_landmarks_csv(args.landmarks_file)
    detector = load_detector(args.detector_checkpoint, args.tiny, args.serving, torch.bfloat16, device)
    landmark_model = load_landmark_model(args.landmark_checkpoint, cfg.model.name, landmarks.shape[0],
                                         torch.bfloat16, device)
    config = PipelineConfig(image_size=tuple(cfg.model.image_size), solver="ransac")

    for scene in scene_list(args):
        scene_dir = os.path.join(args.scenes_dir, scene)
        out_dir = os.path.join(args.output_dir, scene)
        os.makedirs(out_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(scene_dir) if f.lower().endswith(FRAME_EXTENSIONS))
        if not files:
            logger.warning("scene %s: no frames, skipping", scene)
            continue
        logger.info("scene %s: %d frames", scene, len(files))
        run_scene(SceneFrames(cv2, scene_dir, files), files, out_dir, detector, landmark_model, landmarks, cam,
                  batch_size=args.batch_size, input_size=args.input_size, config=config)
        logger.info("scene %s done -> %s", scene, out_dir)


if __name__ == "__main__":
    main()
