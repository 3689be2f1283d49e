"""The comparison has to fail what it guards against: the control (the
reference one precision step below the configuration's, in the program's
place) and the faults a served clip can have, each planted under a run
that otherwise goes as on the card (the harness's look for a card
skipped, the plain kernel versions on the CPU, a tiny int8 cell)."""

from __future__ import annotations

import math
import time

import pytest
import torch

from pose_bench import calibrate, harness
from pose_bench.tests import tiny

pytest.importorskip("spacecraft_pose_estimation_tpu_torch")

# the tiny int8 cell's limits: above what sound runs read on it (det_odds <= 0.118, det_box <= 5.2e-5, every other
# number 0 on seeds 1-4 and 2**31 + 17), below what the control reads there (det_odds >= 6.9, det_rank >= 3.43,
# det_box >= 3.1e-3, kp_gap >= 1.23, conf_err >= 0.72, rot_deg >= 94, t_rel >= 1.46) and what serving the second
# detection reads on seed 2**31 + 17 (det_rank 1.36)
LIMITS = {"det_odds": 1.0, "det_rank": 0.5, "det_box": 1e-3, "held_box": 0.0, "kp_gap": 0.5, "conf_err": 0.3,
          "rot_deg": 1.0, "t_rel": 1e-2}


class Faulty:
    """The program's server with one fault planted in its answers."""

    def __init__(self, server, fault: str):
        self.server, self.fault, self.last = server, fault, None

    def __getattr__(self, name):
        return getattr(self.server, name)

    def __call__(self, frames):
        out = dict(self.server(frames))
        n = frames.shape[0]
        if self.fault == "stale":  # the state left unchanged: the clip before's answers served again
            out, self.last = (self.last or out), out
        elif self.fault == "half_the_clip":  # half the frames left out, the other half's answers served for them
            for k in ("R", "t", "keypoints", "confidence", "boxes"):
                out[k] = torch.cat([out[k][: n // 2], out[k][: n - n // 2]])
        elif self.fault == "pose":  # one frame's rotation turned by 5 degrees
            c, s = math.cos(math.radians(5)), math.sin(math.radians(5))
            turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            out["R"] = out["R"].clone()
            out["R"][n - 1] = turn @ out["R"][n - 1]
        elif self.fault == "keypoint":  # one landmark moved by a fifth of its crop
            out["keypoints"] = out["keypoints"].clone()
            out["keypoints"][0, 0] += out["boxes"][0, 2:] * 1.5 / 5
        elif self.fault == "box":  # one keyframe's box moved by half its width after the held boxes were made
            out["det_boxes"] = out["det_boxes"].clone()
            w = out["det_boxes"][-1, 2] - out["det_boxes"][-1, 0]
            out["det_boxes"][-1, 0::2] += w / 2
        return out


def serve_second_detection(server) -> None:
    """Plant, where the detector's answer is made, a fault that serves each
    keyframe's second detection for its first (with that detection's own
    score): the first is dropped and the rest move up one place."""
    detections = server.detections

    def second(lb):
        dets = dict(detections(lb))
        n = dets["valid"].shape[1]
        for k, v in dets.items():
            if torch.is_tensor(v) and v.dim() >= 2 and v.shape[1] == n:
                dets[k] = torch.roll(v, -1, dims=1)
        dets["valid"] = dets["valid"].clone()
        dets["valid"][:, -1] = False
        return dets

    server.detections = second
    harness.keep_detector_scores(server)  # the kept score is the served detection's


def run_tiny(tmp_path, seed, fault=None):
    root = tiny.make_root(tmp_path, limits=LIMITS)

    def build(cell):
        server = harness.build_program(cell)
        if fault == "second_detection":
            serve_second_detection(server)
            return server
        return Faulty(server, fault) if fault else server

    return harness.run(root, "tiny_int8.track", seed, 0.5, False, time.perf_counter(), device="cpu",
                       build_server=build)


def test_a_sound_run_is_correct(tmp_path):
    result = run_tiny(tmp_path, 2**31 + 17)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault, number", [("stale", "kp_gap"), ("half_the_clip", "kp_gap"), ("pose", "rot_deg"),
                                           ("keypoint", "kp_gap"), ("box", "held_box"),
                                           ("second_detection", "det_rank")])
def test_a_planted_fault_is_not_correct(tmp_path, fault, number):
    result = run_tiny(tmp_path, 2**31 + 17, fault)
    assert not result["correct"]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(tmp_path, seed):
    root = tiny.make_root(tmp_path, limits=LIMITS)
    line = calibrate.read_seed(harness.Spec(root), "tiny_int8.track", seed, True, device="cpu")
    assert all(line["program"][k] <= LIMITS[k] for k in LIMITS), line["program"]
    assert any(line["control"][k] > LIMITS[k] for k in LIMITS), line["control"]


@pytest.mark.card
def test_a_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run(tiny.BENCH.parent, "r101_int8.track", 2**31 + 5, 5.0, False, time.perf_counter())
    assert result["correct"], result["checks"]
