"""The benchmark's harness: one cell, one seed, one run.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration (``configs/<config>.json``: the served form, the port's
presets it runs, every size the reference needs, the comparison's limits)
and traffic mix (``traffic/<mix>.json``: clip length, keyframe step, frame
pool, the stretches a traced run adds); each per-layer metric is a reader
of its own (``metrics/<name>.py``, a ``read(ctx)`` that returns a number or
None, and optionally a ``tally(port, ctx)`` context manager that is open
around the spans stretch, for what it counts from the program's calls).
A later cell, mix or metric is new files and new entries only.

A run: set-up (the port's kernels built or loaded, weights drawn on the
card from the seed, the int8 calibration, the frame pool, a warm-up of the
clip's shapes), then the closed-loop window of ``--seconds`` through
``PoseServer.__call__``; with ``--trace 1`` a stretch of clips under CUDA
event spans and a stretch under ``torch.profiler``; then the program is
freed and a sample of the window's clips is judged against the plain
reference (``check.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, scene, trace
from .counts.flops import clip_flops
from .reference import Reference, exact_float32
from .reference import detector as ref_det
from .reference import pose as ref_pose
from .reference.nets import Detector, HRNet
from .reference.quant import calibrate_norms

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spacecraft_pose_estimation_tpu")
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1.979e15
RESIDUAL_GAIN = 0.125  # the scale of the norm that ends each residual branch (quant.calibrate_norms)
CALIB_FRAMES = 4  # frames the seeded norms, the detector's probes and the int8 trunk are calibrated on


# ---------------------------------------------------------------- the spec

class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "pose_bench" / "traffic" / f"{name}.json").read_text())

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it (one
        without a list is every cell's, as every cell reports every
        end-to-end metric)."""
        return [m for m in self.data["per_layer"] if workload in m.get("workloads", [workload])]

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics this cell reports: those that list it, or
        every cell's where a metric lists none."""
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def metric(self, name: str):
        """The module of ``metrics/<name>.py``."""
        path = self.root / "pose_bench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"pose_bench_metric_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def sub_seed(seed: int, k: int) -> int:
    """An independent 63-bit seed for purpose ``k`` of run seed ``seed``."""
    return int(np.random.SeedSequence([seed & (2**64 - 1), k]).generate_state(2, np.uint64)[0] >> 1)


# ------------------------------------------------------------ the set-up

def make_weights(net: torch.nn.Module, seed: int, device) -> None:
    """Every weight of ``net`` drawn on ``device`` from ``seed`` in one call:
    conv and linear weights N(0, 1 / fan_in), the box classifier N(0, 0.01)
    and regressor N(0, 0.001) and the heatmap head N(0, 0.001) (the
    program's own initialisation), the RPN's anchor deltas N(0, 0.001) (so
    that proposals are anchors nudged, as a trained RPN's are); biases 0;
    norms the identity."""
    weights = [(n, p) for n, p in net.named_parameters() if n.endswith("weight") and p.dim() in (2, 4)]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(p.numel() for _, p in weights), generator=gen, device=device)
    special = {"roi_heads.predictor.cls_score.weight": 0.01, "roi_heads.predictor.bbox_pred.weight": 0.001,
               "final_layer.weight": 0.001, "rpn_head.deltas.weight": 0.001}
    off = 0
    with torch.no_grad():
        for name, p in weights:
            std = special.get(name, p[0].numel() ** -0.5)
            p.copy_(draw[off:off + p.numel()].view_as(p) * std)
            off += p.numel()


def port_modules():
    from spacecraft_pose_estimation_tpu_torch import pipeline, serving  # noqa: F401
    from spacecraft_pose_estimation_tpu_torch.models import backbone_int8, hrnet, hrnet_int8, rcnn
    from spacecraft_pose_estimation_tpu_torch.ops import int8_conv
    return dict(serving=serving, pipeline=pipeline, rcnn=rcnn, hrnet=hrnet, hrnet_int8=hrnet_int8,
                backbone_int8=backbone_int8, int8_conv=int8_conv)


def jsonable(x):
    return json.loads(json.dumps(x, default=list))


def check_preset(preset, stated: dict, what: str) -> None:
    """The port's preset must hold every number the configuration states."""
    have = jsonable(dataclasses.asdict(preset))

    def walk(a, b, path):
        if isinstance(b, dict):
            for k, v in b.items():
                walk(a.get(k) if isinstance(a, dict) else None, v, f"{path}.{k}")
        elif a != b:
            raise ValueError(f"{what}: the port's preset has {path} = {a!r}, the configuration states {b!r}")

    walk(have, stated, what)


@dataclasses.dataclass
class Cell:
    """What a run holds between its phases."""

    name: str
    cfg: dict
    traffic: dict
    device: torch.device
    seed: int
    det: Detector = None
    hrnet: HRNet = None
    calib: dict = None
    lm3d: torch.Tensor = None
    pool: torch.Tensor = None
    targets: torch.Tensor = None
    server: object = None


def phase(name: str, since: float) -> float:
    """Log a set-up phase's seconds on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"set-up {name}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def set_up(cell: Cell, build_server=None) -> None:
    """Weights, calibration inputs and the frame pool from the seed; the
    server built as the configuration states. ``build_server`` replaces the
    program's server (the CPU tests use it to plant a fault)."""
    cfg, tr, dev, seed = cell.cfg, cell.traffic, cell.device, cell.seed
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 1))
    hw = cfg["frame_hw"]
    iw, ih = cfg["pipeline"]["image_size"]
    calib_targets = scene.target_boxes(CALIB_FRAMES, 1, hw, gen, dev)
    calib_frames = scene.render(calib_targets, hw, gen, dev)
    calib_lb, scale = ref_det.letterbox(calib_frames, cfg["det_size"])
    cell.calib = {"images": calib_lb,
                  "crops": torch.randint(0, 256, (4, ih, iw, 3), device=dev, generator=gen).to(torch.float32)}
    cell.lm3d = torch.randn(cfg["landmarks"]["num_joints"], 3, device=dev, generator=gen) * cfg["landmarks_3d_m"]
    cell.targets = scene.target_boxes(tr["pool_clips"], tr["clip_frames"], hw, gen, dev)
    cell.pool = scene.render(cell.targets, hw, gen, dev)
    t = phase("frames", t)
    det, hrnet = Detector(cfg["detector"]).to(dev), HRNet(cfg["landmarks"]).to(dev)
    make_weights(det, sub_seed(seed, 2), dev)
    make_weights(hrnet, sub_seed(seed, 3), dev)
    with exact_float32():
        calibrate_norms(det.backbone, det.normalize(calib_lb).permute(0, 3, 1, 2), det.backbone, RESIDUAL_GAIN)
        calibrate_norms(hrnet, ref_pose.normalize(cell.calib["crops"]), hrnet, RESIDUAL_GAIN)
        scene.calibrate_detector(det, calib_lb, calib_targets * scale)
        scene.calibrate_heatmaps(hrnet, calib_frames, calib_targets, cfg["pipeline"])
    t = phase("weights and their calibration", t)
    cell.det, cell.hrnet = det, hrnet
    cell.server = (build_server or build_program)(cell)
    phase("server", t)


def build_program(cell: Cell):
    """The port's ``PoseServer`` on the benchmark's weights."""
    m = port_modules()
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    prog = cfg["program"]
    det_cfg = getattr(m["rcnn"], prog["detector"])
    hr_cfg = getattr(m["hrnet"], prog["landmarks"]).with_joints(cfg["landmarks"]["num_joints"])
    check_preset(det_cfg, cfg["detector"], "detector")
    check_preset(hr_cfg, cfg["landmarks"], "landmarks")
    pl_cfg = m["pipeline"].PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in cfg["pipeline"].items()})
    detector = m["rcnn"].GeneralizedRCNN(det_cfg, dtype=torch.bfloat16, device=dev)
    detector.load_state_dict(cell.det.state_dict(), strict=True)
    landmarks = m["hrnet"].HRNet(hr_cfg, dtype=torch.bfloat16, device=dev)
    landmarks.load_state_dict(cell.hrnet.state_dict(), strict=True)
    cam = cfg["camera"]
    K, dist = torch.tensor(cam["K"]), torch.tensor(cam["dist"])
    kw = dict(det_every=tr["det_every"], det_size=cfg["det_size"])
    if cfg["form"] == "int8":
        bq = m["backbone_int8"].quantize_backbone(det_cfg.backbone, detector, detector.normalize(cell.calib["images"]))
        hq = m["hrnet_int8"].quantize_hrnet(landmarks, m["pipeline"].normalize_crops(cell.calib["crops"]))
        server = m["serving"].build_int8_server(detector, landmarks, cell.lm3d, K, dist, pl_cfg, backbone_q=bq,
                                                hrnet_q=hq, fold=prog.get("fold", 0), **kw)
    else:
        server = m["serving"].PoseServer(detector, landmarks, cell.lm3d, K, dist, pl_cfg, **kw)
    keep_detector_scores(server)
    return server


def keep_detector_scores(server) -> None:
    """Wrap ``server.detections`` so that each call keeps the detector's
    answer beside its box: the log-odds of each keyframe's top detection (the
    served box), or NaN where the detector found nothing (a few small
    launches a detector call in the window); and keep the proposals its box
    head scored (a forward pre-hook on the ROI heads: no launch)."""
    orig = server.detections

    def proposals(module, args):
        server.served_proposals = args[1]

    server.detector.roi_heads.register_forward_pre_hook(proposals)

    def detections(lb):
        dets = orig(lb)
        p = dets["scores"][:, 0]
        server.served_odds = torch.where(dets["valid"][:, 0], ref_det.log_odds(p), torch.full_like(p, math.nan))
        return dets

    server.detections = detections


# ------------------------------------------------------------- the window

def clip_frames(cell: Cell, i: int) -> torch.Tensor:
    """Clip i: the pool's slot i mod slots, so no clip repeats the one before it."""
    n = cell.traffic["clip_frames"]
    slot = i % cell.traffic["pool_clips"]
    return cell.pool[slot * n:(slot + 1) * n]


def serve(cell: Cell, start: int, count: int | None = None, seconds: float | None = None, each=None) -> dict:
    """Closed loop, one stream: a clip is sent once the last clip's R and t
    are on the host. Runs ``count`` clips, or clips until ``seconds`` have
    passed (the clip in flight then finishes). Returns every clip's outputs,
    latency and end time."""
    outs, lat, ends, failed = [], [], [], 0
    t_start = time.perf_counter()
    i = start
    while (count is None or i - start < count) and (seconds is None or time.perf_counter() - t_start < seconds):
        frames = clip_frames(cell, i)
        if each is not None:
            each()
        t0 = time.perf_counter()
        try:
            out = dict(cell.server(frames), det_odds=cell.server.served_odds,
                       det_props=cell.server.served_proposals)
            R, t = out["R"].to("cpu"), out["t"].to("cpu")
            failed += int((~(torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1))).sum())
        except RuntimeError as err:  # a clip that raised: all its frames failed
            print(f"clip {i} raised: {err}", file=sys.stderr)
            out, failed = None, failed + frames.shape[0]
        t1 = time.perf_counter()
        outs.append((i, out))
        lat.append(t1 - t0)
        ends.append(t1)
        i += 1
    return {"outs": outs, "lat": lat, "start": t_start, "end": ends[-1] if ends else t_start, "failed": failed,
            "frames": len(outs) * cell.traffic["clip_frames"]}


def traced_stretches(cell: Cell, start: int, port: dict, ctx: dict, metrics) -> dict:
    """The spans stretch (CUDA events, with each metric's ``tally`` open)
    and the profiled stretch."""
    tr = cell.traffic
    spans = trace.Spans(cell.server)
    with contextlib.ExitStack() as tallies:
        for module in metrics:
            if hasattr(module, "tally"):
                tallies.enter_context(module.tally(port, ctx))
        serve(cell, start, count=tr["span_clips"], each=spans.next_clip)
    span_ms = spans.close()
    spans = trace.Spans(cell.server)
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.STRETCH):
            serve(cell, start + tr["span_clips"], count=tr["profile_clips"], each=spans.next_clip)
            torch.cuda.synchronize()
    spans.close()
    summary = trace.reduce_profile(prof)
    del prof
    return {"spans": span_ms, "profile": summary, "profile_clips": tr["profile_clips"]}


# ------------------------------------------------------------------ a run

def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, t_process: float,
        device: str = "cuda", build_server=None) -> dict:
    """One run of one cell; returns the result line's object."""
    spec = Spec(root)
    w = spec.workload(workload)
    cell = Cell(workload, spec.config(w["config"]), spec.traffic(w["traffic"]), torch.device(device), seed)
    cuda = cell.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = cell.traffic
    phase("imports", t_process)
    set_up(cell, build_server)
    # the benchmark's float weights stay off the card while the program serves, and the peak is the program's
    cell.det.cpu(), cell.hrnet.cpu()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.device)
    t = time.perf_counter()
    serve(cell, 0, count=tr["warmup_clips"])
    sync()
    phase("warm-up", t)
    setup_s = time.perf_counter() - t_process
    win = serve(cell, tr["warmup_clips"], seconds=seconds)
    window_s = win["end"] - win["start"]
    n_clips = len(win["outs"])
    e2e = {"frames_per_s": win["frames"] / window_s, "clip_ms_p95": 1e3 * trace.percentile(win["lat"], 95),
           "setup_s": setup_s}
    ctx = {"cfg": cell.cfg, "traffic": tr, "window_s": window_s, "window_clips": n_clips,
           "clip_ms_p50": 1e3 * trace.percentile(win["lat"], 50), "clip_ms_p95": e2e["clip_ms_p95"],
           "hbm_bytes_per_s": HBM_BYTES_PER_S,
           "int8_ops_per_s": INT8_OPS_PER_S}
    metrics = [(m, spec.metric(m["name"])) for m in spec.per_layer(workload)] if traced else []
    if traced:
        ctx.update(traced_stretches(cell, tr["warmup_clips"] + n_clips, port_modules(), ctx,
                                    [module for _, module in metrics]))
        ctx["clip_flops"] = clip_flops(cell.cfg, tr["clip_frames"], tr["det_every"])
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    attempted, failed = win["frames"], win["failed"]
    judged = {i: out for i, out in (win["outs"][k] for k in check.sample(n_clips, tr["check_clips"], seed))}
    # the program is freed before the reference runs
    cell.server = win = None
    if cuda:
        torch.cuda.empty_cache()
    cell.det.to(cell.device), cell.hrnet.to(cell.device)
    numbers = {k: math.inf for k in check.NUMBERS}
    if all(out is not None for out in judged.values()):
        with exact_float32():
            ref = Reference(cell.cfg, cell.det, cell.hrnet, cell.calib, cell.lm3d, tr["det_every"])
        numbers = check.worst([check.clip_numbers(ref, clip_frames(cell, i), out, tr["det_every"])
                               for i, out in judged.items()])
    ok, checks = check.judge(numbers, cell.cfg["limits"])
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced:
        for m, module in metrics:
            value = module.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        prof = ctx["profile"]
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        for m in spec.end_to_end(workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
