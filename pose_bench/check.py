"""The comparison that decides ``correct``.

Once the window has closed, a sample of the clips it served (drawn from
the seed) is judged against the plain reference, stage by stage, each
stage from the served answer of the stage before it (the reference reads
the program's outputs only to judge them):

- ``det_odds``: per keyframe, the served box is matched to the nearest of
  the reference's candidates (each level's best anchors by objectness,
  four times as many as go to NMS, decoded and scored by the reference's
  box head, and the reference's own best box); the served detection's
  score (its log-odds, kept from the timed path's detector call) less the
  reference's score of that candidate. A score the timed path got wrong
  reads high.
- ``det_rank``: the served detector's own proposals (kept from the timed
  path's call) scored by the reference's box head: the best of those
  scores less the score of the proposal whose decoded box is the served
  one (where the program found nothing, the best less the score
  threshold). A box served for one that ranks higher among the same
  proposals (a second detection served for the first, a background
  proposal) reads high, whatever score came with it; a near-tie decided
  the other way reads little. It judges the box head's choice, not the
  proposals: those are the program's (``det_box`` and ``det_odds`` hold
  the served box to the reference's own candidates).
- ``det_box``: the distance (largest coordinate difference) from the
  served box to that candidate, over the letterbox's side.
- ``held_box``: the most any frame's held xywh box differs, in pixels,
  from its keyframe's served box.
- ``kp_gap``: per frame and landmark, the reference's heatmap (on the
  served box) at the cell of the served keypoint, below its maximum, over
  the heatmap's spread (maximum less median); a cell off the map reads at
  least 1.
- ``conf_err``: the served confidence less the reference heatmap's
  maximum, over the same spread.
- ``rot_deg``, ``t_rel``: the reference's solve on the served keypoints
  and confidences against the served pose: the rotation between the two,
  in degrees, and the translation's difference over the reference's norm.

Each number is the worst over the sampled frames. ``det_odds``,
``det_rank``, ``kp_gap`` and ``conf_err`` are also read as a clip's mean
over its keyframes or landmarks (``<name>_mean``, the worst clip's): a
near-tie decided the other way moves a worst reading by the tie's whole
gap and a mean by a share of it, so a mean tells a precision step from
rounding where the worst does not. A configuration compares the numbers
it gives limits to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import detector as det_ops
from .reference import exact_float32
from .reference import pose as pose_ops

NUMBERS = ("det_odds", "det_rank", "det_box", "held_box", "kp_gap", "conf_err", "rot_deg", "t_rel",
           "det_odds_mean", "det_rank_mean", "kp_gap_mean", "conf_err_mean")


def xywh(boxes):
    return torch.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], 1)


def detector_numbers(ref, keyframes, det_boxes, det_odds, det_props, block: int = 4) -> dict[str, float]:
    err, rank, dist = [], [], []
    floor = float(det_ops.log_odds(torch.tensor(ref.cfg["detector"]["roi"]["score_thresh"])))
    for lo in range(0, keyframes.shape[0], block):
        r, scale = ref.detect(keyframes[lo:lo + block], det_props[lo:lo + block])
        served = det_boxes[lo:lo + block].to(torch.float32) * scale
        boxes = torch.cat([r["cand_boxes"], r["best"][:, None]], 1)
        odds = torch.cat([r["cand_odds"], r["best_odds"][:, None]], 1)
        valid = torch.cat([r["cand_valid"], torch.ones_like(r["cand_valid"][:, :1])], 1)
        d = torch.where(valid, (boxes - served[:, None]).abs().amax(-1), torch.full_like(odds, math.inf))
        j = torch.argmin(d, 1)
        dist.append(torch.gather(d, 1, j[:, None])[:, 0] / ref.cfg["det_size"])
        mine = det_odds[lo:lo + block].to(torch.float32)
        theirs = torch.gather(odds, 1, j[:, None])[:, 0]
        # a keyframe where the program found nothing is judged by its box alone (the whole frame)
        err.append(torch.where(torch.isnan(mine), torch.zeros_like(mine), (mine - theirs).abs()))
        so = r["served_odds"]
        k = torch.argmin(torch.where(torch.isfinite(so), (r["served_boxes"] - served[:, None]).abs().amax(-1),
                                     torch.full_like(so, math.inf)), 1)
        top = so.amax(1)
        chosen = torch.where(torch.isnan(mine), torch.full_like(top, floor), torch.gather(so, 1, k[:, None])[:, 0])
        rank.append(torch.clamp(top - chosen, min=0.0))
    err, rank = torch.cat(err), torch.cat(rank)
    return {"det_odds": float(err.max()), "det_rank": float(rank.max()), "det_box": float(torch.cat(dist).max()),
            "det_odds_mean": float(err.mean()), "det_rank_mean": float(rank.mean())}


def landmark_numbers(ref, frames, boxes, keypoints, confidence) -> dict[str, float]:
    maps, center, scale = ref.heatmaps(frames, boxes)
    n, h, w, j = maps.shape
    a, off = pose_ops.heatmap_to_frame(center, scale, (w, h))
    cell = torch.round((keypoints.to(torch.float32) - off[:, None]) / a[:, None]).long()
    inside = (cell[..., 0] >= 0) & (cell[..., 0] < w) & (cell[..., 1] >= 0) & (cell[..., 1] < h)
    flat = maps.permute(0, 3, 1, 2).reshape(n, j, h * w)
    top = flat.amax(-1)
    spread = torch.clamp(top - flat.median(-1).values, min=1e-12)
    idx = cell[..., 1].clamp(0, h - 1) * w + cell[..., 0].clamp(0, w - 1)
    at = torch.gather(flat, -1, idx[..., None])[..., 0]
    gap = (top - at) / spread
    gap = torch.where(inside, gap, torch.clamp(gap, min=1.0))
    # a landmark whose heatmap has no positive value is served at the map's origin on both sides
    gap = torch.where((confidence <= 0) & (top <= 0), torch.zeros_like(gap), gap)
    conf = (confidence.to(torch.float32) - top).abs() / spread
    return {"kp_gap": float(gap.max()), "conf_err": float(conf.max()), "kp_gap_mean": float(gap.mean()),
            "conf_err_mean": float(conf.mean())}


def pose_numbers(ref, keypoints, confidence, R, t) -> dict[str, float]:
    Rr, tr = ref.solve(keypoints.to(torch.float32), confidence.to(torch.float32))
    # the angle between two rotations from their Frobenius distance, 2 sqrt(2) sin(angle / 2),
    # which stays exact for small angles where the trace's arccos does not
    fro = (R.double() - Rr.double()).flatten(1).norm(dim=-1)
    deg = torch.rad2deg(2 * torch.arcsin(torch.clamp(fro / (2 * math.sqrt(2)), max=1.0)))
    trel = (t.double() - tr.double()).norm(dim=-1) / torch.clamp(tr.double().norm(dim=-1), min=1e-9)
    bad = ~(torch.isfinite(deg) & torch.isfinite(trel))
    return {"rot_deg": float(torch.where(bad, 180.0, deg).max()), "t_rel": float(torch.where(bad, 1e9, trel).max())}


def clip_numbers(ref, frames, out, det_every: int) -> dict[str, float]:
    """Every number for one served clip ``out`` on its ``frames``."""
    with torch.no_grad(), exact_float32():
        det_boxes = out["det_boxes"].to(torch.float32)
        held = xywh(det_boxes).repeat_interleave(det_every, dim=0)[: frames.shape[0]]
        nums = detector_numbers(ref, frames[::det_every], det_boxes, out["det_odds"], out["det_props"])
        nums["held_box"] = float((out["boxes"].to(torch.float32) - held).abs().max())
        nums.update(landmark_numbers(ref, frames, out["boxes"], out["keypoints"], out["confidence"]))
        nums.update(pose_numbers(ref, out["keypoints"], out["confidence"], out["R"], out["t"]))
    return nums


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def sample(n_clips: int, k: int, seed: int) -> list[int]:
    """Which of the window's clips are judged, drawn from the seed."""
    rng = np.random.default_rng([seed & (2**63 - 1), 0xC1EC])
    return sorted(rng.choice(n_clips, size=min(k, n_clips), replace=False).tolist())


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each number the configuration gives a limit beside its limit; correct
    where none is above it. A number without a limit is not compared."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
