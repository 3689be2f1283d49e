"""A checkout in miniature for the CPU tests: the benchmark's files copied
into a temporary root beside a ``BENCHMARK.json`` of tiny cells (the
port's ``RCNN_TINY`` and ``HRNET_TINY`` at small frames), so that the
harness runs end to end on the CPU, with the port's plain kernel versions."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CHECKS = ("det_odds", "det_rank", "det_box", "held_box", "kp_gap", "conf_err", "rot_deg", "t_rel")


def tiny_config(form: str) -> dict:
    from spacecraft_pose_estimation_tpu_torch import serving
    from spacecraft_pose_estimation_tpu_torch.models import hrnet, rcnn

    def js(x):
        return json.loads(json.dumps(dataclasses.asdict(x)))

    pipeline = js(serving.SERVING_PIPELINE)
    pipeline.update(image_size=[64, 64], crop_window=[96, 96])
    return {
        "name": f"tiny_{form}", "form": form,
        "program": {"detector": "RCNN_TINY", "landmarks": "HRNET_TINY", "fold": 0},
        "precision": {"trunk": form, "heads": "bfloat16", "landmarks": form, "solve": "float32"},
        "peak_ops_per_s": 1.0e12, "det_size": 64, "frame_hw": [72, 96],
        "detector": js(rcnn.RCNN_TINY), "landmarks": js(hrnet.HRNET_TINY.with_joints(11)), "pipeline": pipeline,
        "camera": {"K": [[120.0, 0.0, 48.0], [0.0, 120.0, 36.0], [0.0, 0.0, 1.0]], "dist": [0.0] * 5},
        "landmarks_3d_m": 0.5,
        "limits": {k: 1e30 for k in CHECKS},
    }


TRAFFIC = {"clip_frames": 4, "det_every": 2, "pool_clips": 2, "warmup_clips": 1, "check_clips": 2,
           "span_clips": 2, "profile_clips": 1}


def make_root(tmp: Path, forms=("int8",), limits: dict | None = None) -> Path:
    """A root with pose_bench/ and a BENCHMARK.json of one tiny cell per form."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "pose_bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for form in forms:
        cfg = tiny_config(form)
        if limits:
            cfg["limits"].update(limits)
        (root / "pose_bench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "source": "tiny", "file": f"pose_bench/configs/{cfg['name']}.json",
                                "reduced": [], "why": "tiny"})
        spec["workloads"].append({"name": f"tiny_{form}.track", "config": cfg["name"], "traffic": "tiny_track",
                                  "chips": 1, "why": "tiny"})
    for m in spec["per_layer"] + spec["end_to_end"]:
        m.pop("workloads", None)
    (root / "pose_bench" / "traffic" / "tiny_track.json").write_text(json.dumps(TRAFFIC))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
