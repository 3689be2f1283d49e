#!/usr/bin/env python3
"""Train the port's detector and landmark model on event frames on one CUDA card, then score them.

    python3 chip_dvs_run.py [--detector-iters N]

from the repository root, on a machine with a CUDA card. It

1. renders the synthetic scene and writes its GT (``chip_smoke.dvs_scene``:
   ``tools.make_synthetic_scene render`` at its defaults, 400 frames of
   1280x720, then ``gt`` on the event frames of a ``tools.v2e`` probe at
   the pipeline's settings) into a temporary folder;
2. runs ``tools.train_pipeline_dvs`` at its defaults but one exposure,
   0.02 s: v2e, the split, the COCO conversion, the no-preset detector
   (X101-32x8d FPN at 768, batch 8, SGD; 6000 steps unless
   ``--detector-iters`` cuts them) and the ``events`` preset (HRNet-W32,
   512 -> 128, 40 epochs), its validation split validated after each epoch;
3. runs the evaluation entry (``evaluate.main``) on the test split with the
   two final checkpoints;
4. scores them: the detector's box AP and AP50 on the test split at one
   detection an image (``data/coco_eval``, as the trainer's evaluation
   hook); the keypoint error in pixels of ``pred.mat`` against the test
   split's COCO keypoints (those inside the frame), also a landmark; the
   rotation error in degrees and the relative translation error of
   ``opencv_poses.json`` against the scene's GT poses, the share of
   rotation errors over 150 degrees, and the rotation error and the body
   corners' keypoint error again with the body's 180-degree turns taken as
   the same pose (``TURNS``); the keypoint
   OKS AP (sigma 0.05 a landmark) and mean OKS of the landmark trainer's
   last validation (``pred_val.mat``); the detector's loss at its first and
   last logged iterations (``metrics.json``); each stage's seconds.

It writes into ``dvs_run/``: ``result.json``, ``log.txt`` and
the scoring's inputs (``pred.mat``, ``opencv_poses.json``,
``synthetic_test.json``, ``gt_test.json`` with the test frames' GT poses,
the scene's ``scene.json``, ``calibration.json`` and ``landmarks.csv``)
with ``per_frame.json`` (each test frame's keypoint error a landmark and
rotation error a turn), and prints the result as its last line. It needs a
CUDA card and exits 1 without one.

    python3 chip_dvs_run.py --rescore [DIR]

needs no card: it reads the saved inputs in ``DIR`` (``dvs_run`` by
default) again (``rescore``) and writes ``DIR/rescore.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from chip_smoke import card_line, dvs_scene

OUT = "dvs_run"
EXPOSURE = 0.02  # the first of the pipeline's four exposures; the only one trained on
# the craft's body, a box of half-extents (0.5, 0.4, 0.7) with a panel off each x face, looks
# nearly the same after a 180-degree turn about any of its axes; its 8 corners map onto each other
TURNS = {"none": np.eye(3), "x": np.diag([1.0, -1.0, -1.0]), "y": np.diag([-1.0, 1.0, -1.0]),
         "z": np.diag([-1.0, -1.0, 1.0])}
BODY = 8  # craft_geometry: the landmarks' first 8 are the body's corners
RANSAC_PX = 15.0  # ops/pnp.pnp_ransac's inlier threshold


def final_npz(run_dir: str) -> str:
    ckpt = os.path.join(run_dir, "checkpoints")
    step = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    return os.path.join(ckpt, str(step), "model.npz")


def logged_losses(run_dir: str) -> list[tuple[int, float]]:
    """(iteration, loss_total) of each line of the detector's metrics.json."""
    out = []
    with open(os.path.join(run_dir, "metrics.json")) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                if "loss_total" in rec:
                    out.append((int(rec.get("iteration", len(out))), float(rec["loss_total"])))
    return out


def angle_deg(R: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def turn_perms(landmarks: np.ndarray) -> dict[str, np.ndarray]:
    """For each turn S, the body corner ``perm[i]`` that S carries corner i onto."""
    body = landmarks[:BODY]
    return {k: np.argmin(np.linalg.norm((body @ S.T)[:, None] - body[None], axis=2), axis=1)
            for k, S in TURNS.items()}


def keypoint_errors(coco: dict, preds: np.ndarray, files: list[str], landmarks: np.ndarray):
    """Pixel distances of ``preds`` (N, J, 3) in ``files`` order to the COCO
    keypoints of those files, over the keypoints inside the frame (vis 2)
    and over all; the median a landmark; and the body corners' median error
    a frame with the GT corners permuted by each turn (a model that mistakes
    the body for its turn scores low under that turn). Returns (summary,
    the (N, J) distances with NaN off the frame, the (N, turns) body medians)."""
    by_name = {im["file_name"]: im["id"] for im in coco["images"]}
    gt = {a["image_id"]: np.asarray(a["keypoints"], np.float64).reshape(-1, 3) for a in coco["annotations"]}
    perms = turn_perms(landmarks)
    dist, vis, body = [], [], []
    for f, p in zip(files, preds, strict=True):
        g = gt[by_name[f]]
        dist.append(np.linalg.norm(p[:, :2] - g[:, :2], axis=1))
        vis.append(g[:, 2] == 2.0)
        body.append([np.median(np.linalg.norm(p[:BODY, :2] - g[perm, :2], axis=1)) for perm in perms.values()])
    full, body = np.asarray(dist), np.asarray(body)
    dist = np.where(vis, full, np.nan)
    best = body.argmin(axis=1)
    summary = {"kp_err_mean_px": float(np.nanmean(dist)), "kp_err_median_px": float(np.nanmedian(dist)),
               "kp_err_mean_px_all": float(full.mean()), "kp_err_median_px_all": float(np.median(full)),
               "kp_err_median_px_by_landmark": [float(np.nanmedian(c)) if np.isfinite(c).any() else None
                                                for c in dist.T],
               "body_kp_err_median_px": float(np.median(body[:, 0])),
               "body_kp_err_median_px_best_turn": float(np.median(body.min(axis=1))),
               "body_kp_best_turn_counts": {k: int((best == i).sum()) for i, k in enumerate(TURNS)},
               "keypoints_scored": int(np.isfinite(dist).sum()), "keypoints_all": int(dist.size)}
    return summary, dist, body


def pose_errors(poses: list[dict], gt_dir: str):
    """Rotation error (degrees) and relative translation error of each pose
    against ``gt_dir/pose_<stem>.json``; the rotation error also against the
    GT turned by each of ``TURNS`` (R_gt S: the same picture of the body).
    Returns (summary, the GT poses by image name, the (N, turns) errors)."""
    rot, trans, gts = [], [], {}
    for p in poses:
        stem = int(os.path.splitext(p["image_name"])[0])
        with open(os.path.join(gt_dir, f"pose_{stem}.json")) as f:
            g = json.load(f)
        gts[p["image_name"]] = g
        R, Rg = np.asarray(p["rotation_matrix"]), np.asarray(g["rotation"])
        t, tg = np.asarray(p["T"]).reshape(3), np.asarray(g["translation"])
        rot.append([angle_deg(R @ (Rg @ S).T) for S in TURNS.values()])
        trans.append(float(np.linalg.norm(t - tg) / np.linalg.norm(tg)))
    rot = np.asarray(rot)
    best = rot.argmin(axis=1)
    summary = {"rot_err_median_deg": float(np.median(rot[:, 0])), "rot_err_mean_deg": float(np.nanmean(rot[:, 0])),
               "rot_err_over_150_share": float(np.mean(rot[:, 0] > 150.0)),
               "rot_err_median_deg_any_turn": float(np.median(rot.min(axis=1))),
               "rot_best_turn_counts": {k: int((best == i).sum()) for i, k in enumerate(TURNS)},
               "trans_rel_err_median": float(np.median(trans)), "poses_scored": len(poses)}
    return summary, gts, rot


def validation_oks(coco_io, coco_eval, val_json: str, pred_val: str) -> dict[str, float]:
    """OKS of the trainer's last ``pred_val.mat`` (one row an annotation, in
    the json's order) against the validation json: the keypoint AP at
    sigma 0.05 a landmark, and the mean OKS of each prediction with its GT."""
    coco = coco_io.load_coco(val_json)
    preds = coco_io.load_pred_mat(pred_val)
    dets, gts, oks = [], [], []
    for ann, p in zip(coco["annotations"], preds, strict=True):
        g = np.asarray(ann["keypoints"], np.float64).reshape(1, -1, 3)
        box = np.asarray(ann["bbox"], np.float64).reshape(1, 4)
        dets.append({"keypoints": p[None], "scores": np.array([p[:, 2].mean()])})
        gts.append({"keypoints": g, "boxes": box})
        sig = np.full(g.shape[1], 0.05)
        oks.append(float(coco_eval.compute_oks(p[None], g, box[:, 2] * box[:, 3], box, sig)[0, 0]))
    res = coco_eval.evaluate_keypoints(dets, gts)
    return {"val_oks_ap": res["AP"], "val_oks_ap50": res["AP50"], "val_oks_mean": float(np.mean(oks)),
            "val_instances": len(oks)}


def rescore(out_dir: str) -> dict:
    """A look at a finished run's saved inputs, on the CPU: each landmark's
    median heatmap peak (``pred.mat``'s third column) and the GT landmark
    its prediction lies nearest most often; then the test poses solved
    again by the port's RANSAC PnP (``export_poses.solve_poses``, 256
    hypotheses, seed 0, the CPU) from all landmarks, from the landmarks
    whose median error is under the RANSAC threshold (the learned ones, a
    choice that reads the GT), from those alone on the frames where each
    of them is within it; and from the GT's projections with 0, 1 and 3 px
    of seeded noise, the learned landmarks and all of them. Writes
    ``rescore.json`` into ``out_dir`` and returns it."""
    from spacecraft_pose_estimation_tpu_torch.data import coco_io
    from spacecraft_pose_estimation_tpu_torch.data.camera import CameraModel
    from spacecraft_pose_estimation_tpu_torch.tools.export_poses import solve_poses

    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    lm = coco_io.load_landmarks_csv(path("landmarks.csv"))
    cam = CameraModel.from_calibration_json(path("calibration.json"))
    with open(path("gt_test.json")) as f:
        gts = json.load(f)
    with open(path("per_frame.json")) as f:
        frames = json.load(f)
    files = [r["file"] for r in frames]
    preds = coco_io.load_pred_mat(path("pred.mat"))
    err = np.array([[np.nan if v is None else v for v in r["kp_err_px"]] for r in frames])
    Rg = np.stack([np.asarray(gts[f]["rotation"]) for f in files])
    tg = np.stack([np.asarray(gts[f]["translation"]) for f in files])
    proj = np.stack([coco_io.project_landmarks(lm, R, t, cam.K) for R, t in zip(Rg, tg)])
    nearest = np.linalg.norm(preds[:, :, None, :2] - proj[:, None], axis=3).argmin(axis=2)
    learned = [j for j in range(lm.shape[0]) if np.nanmedian(err[:, j]) < RANSAC_PX]
    clean = (err[:, learned] < RANSAC_PX).all(axis=1)

    def solved(kp, rows, cols) -> dict:
        R, t = solve_poses(kp[rows][:, cols], lm[cols], cam, hypotheses=256, device="cpu")
        rot = np.array([angle_deg(r @ g.T) for r, g in zip(R, Rg[rows])])
        trans = np.linalg.norm(t - tg[rows], axis=1) / np.linalg.norm(tg[rows], axis=1)
        return {"frames": int(rows.sum()), "rot_err_median_deg": float(np.median(rot)),
                "rot_err_under_10_share": float(np.mean(rot < 10.0)),
                "rot_err_over_150_share": float(np.mean(rot > 150.0)), "trans_rel_err_median": float(np.median(trans))}

    every, everyone = np.ones(len(files), bool), list(range(lm.shape[0]))
    result = {"peak_median_by_landmark": np.median(preds[:, :, 2], axis=0).tolist(),
              "nearest_gt_landmark_by_landmark": [np.bincount(c, minlength=lm.shape[0]).tolist() for c in nearest.T],
              "learned_landmarks": learned, "frames_learned_within_threshold": int(clean.sum()),
              "solved_all": solved(preds, every, everyone),
              "solved_learned": solved(preds, every, learned),
              "solved_learned_clean_frames": solved(preds, clean, learned)}
    for sigma in (0.0, 1.0, 3.0):  # the GT's projections with seeded noise of sigma px on each axis
        noisy = proj + sigma * np.random.default_rng(0).normal(size=proj.shape)
        noisy = np.concatenate([noisy, np.ones(proj.shape[:2] + (1,))], axis=2)
        result[f"solved_gt_{sigma:g}px_learned"] = solved(noisy, every, learned)
        result[f"solved_gt_{sigma:g}px_all"] = solved(noisy, every, everyone)
    with open(path("rescore.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--detector-iters", type=int, default=None, help="cut the detector's 6000 steps")
    ap.add_argument("--rescore", nargs="?", const=OUT, metavar="DIR",
                    help=f"only look again at a run's saved inputs in DIR ({OUT} by default), on the CPU")
    args = ap.parse_args(argv)
    if args.rescore:
        print(json.dumps(rescore(args.rescore)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_dvs_run: no CUDA device is available", file=sys.stderr)
        return 1
    from types import SimpleNamespace

    from spacecraft_pose_estimation_tpu_torch import evaluate
    from spacecraft_pose_estimation_tpu_torch.data import coco_eval, coco_io
    from spacecraft_pose_estimation_tpu_torch.data.detection_dataset import DetectionExamples
    from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene, train_detector, train_pipeline_dvs, v2e

    os.makedirs(OUT, exist_ok=True)
    log_f = open(os.path.join(OUT, "log.txt"), "w")

    def log(msg: str) -> None:
        print(msg, flush=True)
        log_f.write(msg + "\n")
        log_f.flush()

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}; args {vars(args)}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        log(f"disk free under {root}: {shutil.disk_usage(root).free / 1e9:.1f} GB")
        paths, seconds, _ = dvs_scene(SimpleNamespace(make_synthetic_scene=make_synthetic_scene, v2e=v2e), root,
                                      EXPOSURE)
        iters = [] if args.detector_iters is None else ["--detector-iters", str(args.detector_iters)]
        out = train_pipeline_dvs.main([
            "--frames-dir", paths["frames"], "--gt-dir", paths["gt"], "--landmarks-file", paths["landmarks"],
            "--work-dir", os.path.join(root, "work"), "--exposures", str(EXPOSURE)] + iters)
        seconds.update(out.seconds)
        split_dir = out.event_dirs[0] + "_split"
        dicts = out.dict_dirs[0]
        splits = {s: len(os.listdir(os.path.join(split_dir, s))) for s in ("train", "validation", "test")}
        det_npz, lm_npz = final_npz(out.detector_dir), final_npz(out.landmarks_dir)
        losses = logged_losses(out.detector_dir)
        log(f"pipeline done: splits {json.dumps(splits)}; checkpoints {det_npz}, {lm_npz}; detector loss_total "
            f"logged {losses}")

        t0 = time.perf_counter()
        eval_out = os.path.join(root, "eval")
        evaluate.main(["--scenes-dir", split_dir, "--scenes", "test", "--landmarks-file", paths["landmarks"],
                       "--calibration-file", paths["calibration"], "--detector-checkpoint", det_npz,
                       "--landmark-checkpoint", lm_npz, "--output-dir", eval_out])
        seconds["evaluate"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dev = torch.device("cuda")
        test_json = os.path.join(dicts, "synthetic_test.json")
        detector = evaluate.load_detector(det_npz, False, False, torch.bfloat16, dev)
        box = train_detector.evaluate(detector, DetectionExamples(test_json, os.path.join(split_dir, "test")), 8,
                                      768, dev)
        del detector
        files = sorted(f for f in os.listdir(os.path.join(split_dir, "test")) if f.endswith(".bmp"))
        preds = coco_io.load_pred_mat(os.path.join(eval_out, "test", "pred.mat"))
        with open(os.path.join(eval_out, "test", "opencv_poses.json")) as f:
            poses = json.load(f)
        landmarks = coco_io.load_landmarks_csv(paths["landmarks"])
        kp, kp_dist, kp_body = keypoint_errors(coco_io.load_coco(test_json), preds, files, landmarks)
        pose, gt_poses, rot = pose_errors(poses, paths["gt"])
        result = {"card": card, "args": vars(args), "splits": splits,
                  "box_ap": box["AP"], "box_ap50": box["AP50"], "box_ar": box["AR"], **kp, **pose,
                  **validation_oks(coco_io, coco_eval, os.path.join(dicts, "synthetic_validation.json"),
                                   os.path.join(out.landmarks_dir, "pred_val.mat")),
                  "det_loss_first": losses[0] if losses else None, "det_loss_last": losses[-1] if losses else None,
                  "det_losses_logged": len(losses)}
        seconds["score"] = time.perf_counter() - t0

        # the scoring's inputs and its per-frame readings, for a look on any machine
        for src in (os.path.join(eval_out, "test", "pred.mat"), os.path.join(eval_out, "test", "opencv_poses.json"),
                    test_json, os.path.join(paths["scene"], "scene.json"), paths["calibration"], paths["landmarks"]):
            shutil.copy(src, OUT)
        with open(os.path.join(OUT, "gt_test.json"), "w") as f:
            json.dump(gt_poses, f)
        rot_by_name = {p["image_name"]: r for p, r in zip(poses, rot)}
        with open(os.path.join(OUT, "per_frame.json"), "w") as f:
            json.dump([{"file": name, "kp_err_px": [None if not np.isfinite(v) else float(v) for v in d],
                        "body_kp_err_median_px": dict(zip(TURNS, b.tolist())),
                        "rot_err_deg": dict(zip(TURNS, rot_by_name[name].tolist())) if name in rot_by_name else None}
                       for name, d, b in zip(files, kp_dist, kp_body)], f)
    seconds["all"] = time.perf_counter() - t_all
    result["seconds"] = {k: round(v, 3) for k, v in seconds.items()}
    with open(os.path.join(OUT, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
