#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit. It

1. builds the CUDA kernels of ``spacecraft_pose_estimation_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. checks the tiny detector + HRNet serving path on the card against the
   same path on the CPU (plain PyTorch versions of the kernels), and the
   PnP solver against a known pose;
3. serves full-width clips: R101-FPN (``FASTER_RCNN_R101_SERVING_1OBJ``,
   768 letterbox) and HRNet-W32 (11 joints, 512 crops), bf16 compute over
   float32 weights from a seed, on uint8 1920x1200 frames, with every
   kernel launch counter reset just before and read just after;
4. holds each kernel to its plain version on the inputs the serving run
   gave it, and times both (and one PyTorch library call where one
   computes the same function);
5. times each serving stage on one clip (CUDA events) and runs
   torch.profiler over one more;
6. prints the card, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the result
line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

DET_BATCH, DET_EVERY, CLIPS = 4, 4, 3
FRAME_HW = (1200, 1920)
NUM_JOINTS = 11


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Capture:
    """Record the arguments of every call to ``module.name`` while active."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []
        self.orig = getattr(module, name)

    def __enter__(self):
        def record(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_tiny_against_cpu(torch, m) -> None:
    """The tiny serving path on the card (kernels) vs the CPU (plain), and
    PnP on the card against a known pose."""
    import dataclasses

    import numpy as np

    rcnn, hrnet, pnp, geometry = m.rcnn, m.hrnet, m.pnp, m.geometry
    cfg = m.pipeline.PipelineConfig(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=(112, 112))
    outs = {}
    for device in ("cpu", "cuda"):
        det = rcnn.GeneralizedRCNN(rcnn.RCNN_TINY, device=device, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # keep raw 0-255 pixels from saturating the random logits
            det.backbone.stem.conv.weight.mul_(1e-2)
        hr = hrnet.HRNet(dataclasses.replace(hrnet.HRNET_TINY, num_joints=NUM_JOINTS), device=device,
                         generator=torch.Generator().manual_seed(1))
        rng = np.random.default_rng(0)
        lm3d = rng.normal(size=(NUM_JOINTS, 3)).astype(np.float32)
        K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
        frames = torch.from_numpy(rng.integers(0, 255, (4, 120, 192, 3)).astype(np.uint8)).to(device)
        server = m.serving.PoseServer(det, hr, lm3d, K, np.zeros(5, np.float32), cfg, det_every=2, det_size=64)
        outs[device] = {k: v.cpu() for k, v in server(frames).items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    for key, tol in (("det_boxes", 1e-2), ("keypoints", 1e-2), ("confidence", 1e-3)):
        err = (gpu[key] - cpu[key]).abs().max().item()
        log(f"tiny path, card vs CPU: {key} max_abs_err={err:.3g} (limit {tol})")
        if not err <= tol:
            raise RuntimeError(f"tiny serving path: {key} differs between the card and the CPU by {err}")
    # PnP on a scene with a known pose (random keypoints fit no pose)
    world = torch.randn(11, 3, generator=torch.Generator().manual_seed(2))
    R = geometry.quat_to_dcm(torch.tensor([0.8, 0.3, -0.4, 0.2]))
    t = torch.tensor([0.2, -0.1, 10.0])
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    dist = torch.zeros(5)
    px = geometry.project_points(world, R, t, K, dist)
    Rg, tg = pnp.solve_pnp(world.cuda(), px[None].cuda(), K.cuda(), dist.cuda(), torch.ones(1, 11).cuda(), 5)
    err = max((Rg[0].cpu() - R).abs().max().item(), (tg[0].cpu() - t).abs().max().item() / 10.0)
    log(f"PnP on the card vs the true pose: max_err={err:.3g} (limit 1e-3)")
    if not err <= 1e-3:
        raise RuntimeError(f"PnP on the card misses a known pose by {err}")


def crop_numbers(torch, args):
    """Bytes K1 must move (the frame cells under each crop read once, the
    crops written once) and its FLOPs (12 per output value)."""
    frames, params, out_size = args[:3]
    b, h, w, _ = frames.shape
    ow, oh = out_size
    spans = []
    for n_out, limit, a, c in ((ow, w, 0, 1), (oh, h, 2, 3)):
        lo = torch.floor(params[:, c]).clamp(0, limit - 1)
        hi = (torch.floor(params[:, a] * (n_out - 1) + params[:, c]) + 1).clamp(0, limit - 1)
        spans.append((hi - lo + 1).clamp(min=0))
    nbytes = float((spans[0] * spans[1]).sum()) * 3 + params.numel() * 4 + b * oh * ow * 3 * 4
    return nbytes, 12.0 * b * oh * ow * 3


def pooler_numbers(torch, roi_align, args, kwargs):
    """Bytes K2 must move (the feature cells its taps touch, read once per
    image and level; boxes, indices; the pooled output) and its FLOPs
    (53 per output value at sampling ratio 2)."""
    feats, boxes, batch_idx, p, strides = args[:5]
    s, window = kwargs.get("sampling_ratio", 2), kwargs.get("window", 48)
    c = feats[0].shape[-1]
    r = boxes.shape[0]
    levels = roi_align.assign_levels(boxes, len(feats), int(math.log2(strides[0])))
    cells = 0
    for li, (f, stride) in enumerate(zip(feats, strides)):
        sel = torch.nonzero(levels == li).flatten()
        if sel.numel() == 0:
            continue
        (ky, wy), (kx, wx) = roi_align.level_taps(boxes[sel], f.shape[1], f.shape[2], stride, p, s, window)
        touched = torch.zeros(f.shape[:3], dtype=torch.bool, device=boxes.device)
        for i, roi in enumerate(sel.tolist()):
            ys, xs = ky[i][wy[i] > 0].unique(), kx[i][wx[i] > 0].unique()
            touched[batch_idx[roi].long(), ys[:, None], xs[None, :]] = True
        cells += int(touched.sum())
    nbytes = cells * c * feats[0].element_size() + r * p * p * c * 4 + r * (16 + 4)
    return nbytes, 53.0 * r * p * p * c


def serve(torch, m, dev, det_cfg, hr_cfg, frame_hw, det_size, config, clips_n):
    """Warm up once (recording each kernel's inputs), then serve ``clips_n``
    clips with the launch counters reset just before and read just after.

    Returns the launch counts, the captures and what the stage timing
    needs (server, models, one clip, landmarks, camera).
    """
    detector = m.rcnn.GeneralizedRCNN(det_cfg, dtype=torch.bfloat16, device=dev,
                                      generator=torch.Generator().manual_seed(0))
    landmarks = m.hrnet.HRNet(hr_cfg.with_joints(NUM_JOINTS), dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(1))
    lm3d = torch.randn(NUM_JOINTS, 3, generator=torch.Generator().manual_seed(2))
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    server = m.serving.PoseServer(detector, landmarks, lm3d, K, torch.zeros(5), config,
                                  det_every=DET_EVERY, det_size=det_size)
    clip = DET_BATCH * DET_EVERY
    gd = torch.Generator(device=dev).manual_seed(3)
    clips = [torch.randint(0, 256, (clip, *frame_hw, 3), dtype=torch.uint8, device=dev, generator=gd)
             for _ in range(clips_n + 1)]

    captures = [Capture(m.warp, "crop_bilinear"), Capture(m.roi_align, "roi_align_multilevel"),
                Capture(m.nms, "nms_mask_sorted")]
    with contextlib.ExitStack() as stack:
        for c in captures:
            stack.enter_context(c)
        server(clips[0])  # warm-up, and the kernels' serving inputs
        sync()

    kernels = {"K1": m.warp.KERNEL, "K2": m.roi_align.KERNEL, "K4": m.nms.KERNEL}
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    outs = [server(frames) for frames in clips[1:]]
    sync()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"serving: {clips_n} clips x {clip} frames of {frame_hw[1]}x{frame_hw[0]} in {seconds:.4f} s = "
        f"{clips_n * clip / seconds:.2f} frames/s (det_batch {DET_BATCH}, det_every {DET_EVERY}, "
        f"det_size {det_size}); launches {json.dumps(launches)}")
    for out in outs:
        for key, shape in (("R", (clip, 3, 3)), ("t", (clip, 3)), ("quat", (clip, 4)),
                           ("keypoints", (clip, NUM_JOINTS, 2))):
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                raise RuntimeError(f"served {key}: shape {tuple(out[key].shape)} or non-finite values")
    log(f"poses finite; first t {outs[0]['t'][0].tolist()}, first box {outs[0]['det_boxes'][0].tolist()}")
    run = SimpleNamespace(server=server, landmarks=landmarks, frames=clips[1], config=config,
                          lm3d=lm3d.to(dev), K=K.to(dev), dist=torch.zeros(5, device=dev))
    return launches, captures, run


def stage_times(torch, m, run) -> dict[str, float]:
    """Device time (CUDA events, ms) of each serving stage on one clip."""
    server, frames, config = run.server, run.frames, run.config
    with torch.inference_mode():
        lb, _ = m.serving.letterbox(frames[:: server.det_every], server.det_size)
        _, boxes = server.detect(frames)
        land = m.pipeline.make_landmark_stage(run.landmarks, config)(frames, boxes)
        centers, scales = land["centers"], land["scales"]
        crops = m.warp.crop_and_resize(frames, centers, scales, config.image_size)
        w = m.pnp.adaptive_confidence_mask(land["confidence"], min_count=config.min_keypoints).float()
        stages = {
            "letterbox": lambda: m.serving.letterbox(frames[:: server.det_every], server.det_size),
            "detector: backbone+fpn": lambda: server.detector.pyramid(lb),
            "detector: all": lambda: server.detector(lb),
            "crop (K1)": lambda: m.warp.crop_and_resize(frames, centers, scales, config.image_size),
            "normalize+hrnet": lambda: run.landmarks(m.pipeline.normalize_crops(crops)),
            "decode": lambda: m.heatmap.decode_heatmaps(land["heatmaps"], centers, scales),
            "pnp (epnp+gn)": lambda: m.pnp.solve_pnp(run.lm3d, land["keypoints"], run.K, run.dist, w,
                                                      config.refine_iters),
            "clip: server call": lambda: server(frames),
        }
        times = {name: time_ms(fn, 5) for name, fn in stages.items()}
    log("stage device ms per clip: " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    return times


def profile_clip(torch, run) -> None:
    """torch.profiler over one served clip: device time by kernel and the
    device's busy share of the clip's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.server(run.frames)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    table = prof.key_averages()
    log(table.table(sort_by="self_cuda_time_total", row_limit=15))
    # kernels are counted once, under the host op that launched them
    busy_us = sum(e.self_device_time_total for e in table if e.device_type == DeviceType.CPU)
    log(f"profile: device busy {busy_us:.0f} us of {wall_us:.0f} us wall (profiler on) = {busy_us / wall_us:.4f}")


def kernel_rows(torch, m, dev, captures):
    """(id, name, source, replaces, kernel fn, plain fn, library fn or None,
    tolerance or None for 1e-5 of the output's scale, bytes, FLOPs) per
    kernel, on the inputs the serving run gave it."""
    try:
        import torchvision.ops as tv_ops  # a yardstick only: the port never calls it
    except ImportError:
        tv_ops = None
    rows = []
    crop_args, _ = captures[0].calls[0]
    frames, params, out_size = crop_args
    frames_f = frames.permute(0, 3, 1, 2).float()
    h, w = frames.shape[1:3]
    xs = params[:, 0:1] * torch.arange(out_size[0], device=dev) + params[:, 1:2]
    ys = params[:, 2:3] * torch.arange(out_size[1], device=dev) + params[:, 3:4]
    grid = torch.stack([((2 * xs + 1) / w - 1)[:, None, :].expand(-1, out_size[1], -1),
                        ((2 * ys + 1) / h - 1)[:, :, None].expand(-1, -1, out_size[0])], dim=-1)
    rows.append(("K1", "crop_bilinear", "spacecraft_pose_estimation_tpu_torch/csrc/crop_bilinear.cu",
                 "spacecraft_pose_estimation_tpu/ops/pallas_crop.py:191",
                 lambda: m.warp.crop_bilinear(*crop_args), lambda: m.warp.crop_bilinear_plain(*crop_args),
                 lambda: torch.nn.functional.grid_sample(frames_f, grid, mode="bilinear", padding_mode="zeros",
                                                         align_corners=False),
                 1e-3, *crop_numbers(torch, crop_args)))

    pool_args, pool_kwargs = captures[1].calls[0]
    rows.append(("K2", "roi_align_multilevel", "spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel.cu",
                 "spacecraft_pose_estimation_tpu/ops/pallas_pooler.py:135",
                 lambda: m.roi_align.roi_align_multilevel(*pool_args, **pool_kwargs),
                 lambda: m.roi_align.roi_align_multilevel_plain(*pool_args, **pool_kwargs), None,
                 None, *pooler_numbers(torch, m.roi_align, pool_args, pool_kwargs)))

    for i, (nms_args, _) in enumerate(captures[2].calls[:2]):  # the RPN's, then the box head's
        boxes, valid, thresh = nms_args
        p, n = valid.shape
        kept = float(m.nms.nms_mask_sorted_plain(boxes, valid, thresh).sum())
        lib = None
        if tv_ops is not None:
            idxs = torch.arange(p, device=dev)[:, None].expand(p, n)[valid]
            order = torch.arange(n, 0, -1, device=dev, dtype=torch.float32)[None].expand(p, n)[valid]
            lib = (lambda b=boxes[valid], s=order, i=idxs, th=thresh: tv_ops.batched_nms(b, s, i, th))
        rows.append(("K4", f"nms_mask_sorted ({'rpn' if i == 0 else 'box head'} {p}x{n})",
                     "spacecraft_pose_estimation_tpu_torch/csrc/nms_mask_sorted.cu",
                     "spacecraft_pose_estimation_tpu/ops/pallas_nms.py:67",
                     lambda a=nms_args: m.nms.nms_mask_sorted(*a),
                     lambda a=nms_args: m.nms.nms_mask_sorted_plain(*a),
                     lib, 0.0, p * n * (16 + 1 + 1), kept * n * 15.0))
    return rows


def kernel_report(rows, launches):
    """Hold each kernel to its plain version, then time kernel, plain and
    library call; raises on a disagreement."""
    report = []
    for key, name, source, replaces, run_k, run_p, run_lib, tol, nbytes, flops in rows:
        got, want = run_k(), run_p()
        sync()
        err = (got.float() - want.float()).abs().max().item()
        limit = tol if tol is not None else 1e-5 * max(1.0, want.abs().max().item())
        log(f"{key} {name}: max_abs_err {err:.3g} (limit {limit:.3g}) over {tuple(got.shape)}")
        if not err <= limit:
            raise RuntimeError(f"{key} {name} disagrees with its plain version: {err} > {limit}")
        bound, bound_by = bound_ms(nbytes, flops)
        entry = {
            "name": name, "id": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err, "tolerance": limit,
            "ms": time_ms(run_k, 20), "plain_ms": time_ms(run_p, 3), "bound_ms": bound, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops,
            "library_ms": time_ms(run_lib, 20) if run_lib is not None else None,
        }
        log(f"{key} {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f} ms, bound {bound:.5f} ms "
            f"by {bound_by}, library {entry['library_ms']})")
        report.append(entry)
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from spacecraft_pose_estimation_tpu_torch import _cuda, pipeline, serving
    from spacecraft_pose_estimation_tpu_torch.models import hrnet, rcnn
    from spacecraft_pose_estimation_tpu_torch.ops import geometry, heatmap, nms, pnp, roi_align, warp

    m = SimpleNamespace(rcnn=rcnn, hrnet=hrnet, pnp=pnp, geometry=geometry, pipeline=pipeline,
                        serving=serving, warp=warp, roi_align=roi_align, nms=nms, heatmap=heatmap)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    # full float32 wherever float32 runs (the serving models run bf16)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_s = _cuda.build_all()
    log("build (s): " + json.dumps({k: round(v, 2) for k, v in build_s.items()}))
    check_tiny_against_cpu(torch, m)

    dev = torch.device("cuda")
    launches, captures, run = serve(torch, m, dev, rcnn.FASTER_RCNN_R101_SERVING_1OBJ, hrnet.POSE_HRNET_W32,
                                    FRAME_HW, 768, serving.SERVING_PIPELINE, CLIPS)
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was not launched by the serving run")
    stage_times(torch, m, run)
    profile_clip(torch, run)
    report = kernel_report(kernel_rows(torch, m, dev, captures), launches)

    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
