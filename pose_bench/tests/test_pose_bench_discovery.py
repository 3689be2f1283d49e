"""A configuration, a traffic mix, a cell and per-layer metrics added as
new files and new BENCHMARK.json entries only are found and run, a
kernel's roofline among them: its own tally of the program's calls, its
kernel's seconds read from the profile by name."""

from __future__ import annotations

import contextlib
import json
import time

import pytest

from pose_bench import harness
from pose_bench.tests import tiny

pytest.importorskip("spacecraft_pose_estimation_tpu_torch")

NEW_METRIC = '''"""frames_per_clip: a per-layer metric that a later change adds as a file of its own."""


def read(ctx):
    return float(ctx["traffic"]["clip_frames"])
'''

NEW_ROOFLINE = '''"""crop_roofline_pct: a kernel's share of its roofline that a later change adds as a file of its own."""

import contextlib


@contextlib.contextmanager
def tally(port, ctx):
    ctx["crop_bytes"] = 0
    yield
    ctx["crop_bytes"] += 2.0e9 * ctx["traffic"]["span_clips"]


def read(ctx):
    seconds = sum(s for name, s in ctx["profile"]["kernel_s"].items() if "crop_bilinear" in name)
    return 100.0 * ctx["crop_bytes"] / ctx["traffic"]["span_clips"] / 4.0e12 / seconds
'''


def fake_stretches(cell, start, port, ctx, metrics):
    """What the traced stretches hand the readers, without a card: each
    metric's tally opened around the stretch as on the card, and a profile
    of one clip in which the crop kernel ran for 1 ms."""
    with contextlib.ExitStack() as tallies:
        for module in metrics:
            if hasattr(module, "tally"):
                tallies.enter_context(module.tally(port, ctx))
    return {"spans": [{"detect": 2.0, "pose": 5.0, "landmarks": 3.0}], "profile_clips": 1,
            "profile": {"window_s": 1.0, "busy_s": 0.5, "launches": 10,
                        "kernel_s": {"void crop_bilinear_kernel<8>(...)": 1e-3},
                        "device_ops": [["k", 0.5]], "idle_gaps": [["idle host", 0.5]]}}


def test_new_files_add_a_cell_a_mix_and_a_metric(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration (a copy under a new name), a new mix and a new metric: files only
    cfg = json.loads((root / "pose_bench" / "configs" / "tiny_int8.json").read_text())
    cfg["name"] = "tiny_int8_b"
    (root / "pose_bench" / "configs" / "tiny_int8_b.json").write_text(json.dumps(cfg))
    mix = dict(tiny.TRAFFIC, clip_frames=6, det_every=3)
    (root / "pose_bench" / "traffic" / "tiny_six.json").write_text(json.dumps(mix))
    (root / "pose_bench" / "metrics" / "frames_per_clip.py").write_text(NEW_METRIC)
    (root / "pose_bench" / "metrics" / "crop_roofline_pct.py").write_text(NEW_ROOFLINE)
    spec["configs"].append({"name": "tiny_int8_b", "source": "tiny", "file": "pose_bench/configs/tiny_int8_b.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": "tiny_b.six", "config": "tiny_int8_b", "traffic": "tiny_six", "chips": 1,
                              "why": "tiny"})
    spec["per_layer"].append({"name": "frames_per_clip", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "server", "moves": "frames_per_s",
                              "workloads": ["tiny_b.six"]})
    spec["per_layer"].append({"name": "crop_roofline_pct", "unit": "%", "better": "higher", "source": "device_trace",
                              "layer": "kernels", "moves": "frames_per_s", "workloads": ["tiny_b.six"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    e2e = harness.run(root, "tiny_b.six", 77, 1.0, False, time.perf_counter(), device="cpu")
    assert set(e2e["metrics"]) == {"frames_per_s", "clip_ms_p95", "setup_s"}
    assert e2e["attempted"] % 6 == 0 and e2e["correct"]

    monkeypatch.setattr(harness, "traced_stretches", fake_stretches)
    monkeypatch.setattr(harness, "clip_flops", lambda cfg, clip, every: 1e9)
    traced = harness.run(root, "tiny_b.six", 78, 1.0, True, time.perf_counter(), device="cpu")
    assert traced["metrics"]["frames_per_clip"] == {"value": 6.0, "unit": "frames"}
    assert traced["metrics"]["crop_roofline_pct"]["value"] == pytest.approx(50.0)
    assert traced["metrics"]["solve_ms"]["value"] == 2.0
    assert "k5a_roofline_pct" not in traced["metrics"]  # nothing to read: left out, never 0
    assert list(traced)[-1] == "checks"


def test_end_to_end_metric_that_lists_cells_is_left_out_of_others(tmp_path, monkeypatch):
    """An end-to-end metric with a ``workloads`` list is reported in those
    cells only; the per-layer ``clip_ms_p95.fps`` reads the window's tail
    in a cell that lists it, and equals the end-to-end reading there."""
    root = tiny.make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    p95 = next(m for m in spec["end_to_end"] if m["name"] == "clip_ms_p95")
    p95["workloads"] = ["some_other.cell"]
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] in ("clip_ms_p95.fps", "solve_ms.fps")]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    e2e = harness.run(root, "tiny_int8.track", 79, 1.0, False, time.perf_counter(), device="cpu")
    assert set(e2e["metrics"]) == {"frames_per_s", "setup_s"}

    monkeypatch.setattr(harness, "traced_stretches", fake_stretches)
    monkeypatch.setattr(harness, "clip_flops", lambda cfg, clip, every: 1e9)
    monkeypatch.setattr(harness.trace, "percentile", lambda values, q: 0.25 if q == 95 else 0.125)
    traced = harness.run(root, "tiny_int8.track", 80, 1.0, True, time.perf_counter(), device="cpu")
    assert traced["metrics"] == {"clip_ms_p95.fps": {"value": 250.0, "unit": "ms"},
                                 "solve_ms.fps": {"value": 2.0, "unit": "ms"}}
