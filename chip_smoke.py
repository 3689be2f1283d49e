#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit. It

1. builds the CUDA kernels of ``spacecraft_pose_estimation_tpu_torch/csrc``
   (one nvcc per source, in parallel) and reads the SASS of the four int8
   kernels K5a, K5, K6 and K7: integer tensor-core instructions (IGMMA),
   no dp4a;
2. holds K2 to its plain version on seeded boxes that the served
   proposals may not reach (every pyramid level, the image's edges, boxes
   larger than the read window; f32 and bf16 features, 256 and 16
   channels), K3 likewise on maps larger and smaller than its read window
   at spatial scales 0.25, 0.3 and 1/12 (boxes across every edge, larger
   than the window, zero-area, wholly outside the map; a CUDA call with 12
   channels must raise), and K4 exactly on seeded problems of 1, 63, 65
   and 1024 boxes with duplicates, ties, zero-area boxes and no valid box;
   then checks the tiny detector + HRNet serving path on the card against
   the same path on the CPU (plain PyTorch versions of the kernels), in
   the bf16 form and in the int8 form with every fused route on, and the
   PnP solver against a known pose;
3. serves full-width clips of both forms: R101-FPN
   (``FASTER_RCNN_R101_SERVING_1OBJ``, 768 letterbox) and HRNet-W32
   (11 joints, 512 crops) on uint8 1920x1200 frames, weights from seeds.
   The bf16 form runs bf16 compute over float32 weights; the int8 form is
   ``bench.py``'s default, the int8 backbone feeding the detector and the
   int8 HRNet on raw crops, with the fused chains (K5, K6 in 32-row
   strips, K7). Every kernel launch counter is reset just before each
   serving run and read just after, and the served ROIs' pyramid levels
   are logged;
4. holds each kernel to its plain version on the inputs the serving runs
   gave it, and times both (and one PyTorch library call where one
   computes the same function), the kernel and the library call also
   replayed from a CUDA graph of k back-to-back calls, k chosen for about
   1 ms a replay (its device time without the host's launch cost); the fused
   int8 HRNet is held to the per-op one on the served crops;
5. runs K3, the single-level ROIAlign that no serving path calls, on the
   P2 map of one served keyframe and that image's box-head proposals, with
   its launch counter reset just before and read just after (K2's and K3's
   yardstick: ``F.grid_sample`` at the sample points, then
   ``F.avg_pool2d``);
6. times each serving stage on one clip of each form (CUDA events) and
   runs torch.profiler over one more;
7. prints the card, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the result
line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bytes/s, fp32 FLOP/s outside the tensor cores, int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12

DET_BATCH, DET_EVERY, CLIPS = 4, 4, 3
FRAME_HW = (1200, 1920)
NUM_JOINTS = 11
# the int8 form with every fused route of the JAX package switched on
FUSED = dict(fused_blocks=True, layer1_strips=True, fuse_exchange=True)
INT8_IDS = ("K5a", "K5", "K6", "K7")
TENSOR_CORE_SOURCES = ("int8_conv_requant.cu", "basic_block_chain.cu",  # K5a, K5
                       "bottleneck_chain.cu", "up_exchange.cu")  # K6, K7


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


def graph_ms(fn, reps: int = 5) -> tuple[float | None, int]:
    """Device time of one call of ``fn``: k back-to-back calls captured in
    one CUDA graph, its replay time over k. A graph of one call, replayed,
    times the host's cost of a replay as much as a kernel of a few
    microseconds, so k is chosen to give one replay about 1 ms of work
    (1 <= k <= 50), from a first graph of one call. Returns (ms, k);
    (None, 0) when ``fn`` cannot be captured."""
    import torch

    def captured(k: int):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        return graph

    try:
        one = time_ms(captured(1).replay, reps)
        k = max(1, min(50, round(1.0 / one)))
        return (one if k == 1 else time_ms(captured(k).replay, reps) / k), k
    except RuntimeError as e:
        log(f"graph capture failed: {e}")
        return None, 0


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
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

    def bound(self, i: int = 0) -> dict:
        """Call i's arguments by parameter name, defaults filled in."""
        b = inspect.signature(self.orig).bind(*self.calls[i][0], **self.calls[i][1])
        b.apply_defaults()
        return b.arguments


def tiny_models(torch, m, device, dtype):
    """RCNN_TINY and HRNET_TINY from seeds, as both tiny checks build them."""
    import dataclasses

    det = m.rcnn.GeneralizedRCNN(m.rcnn.RCNN_TINY, dtype=dtype, device=device,
                                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # keep raw 0-255 pixels from saturating the random logits
        det.backbone.stem.conv.weight.mul_(1e-2)
    hr = m.hrnet.HRNet(dataclasses.replace(m.hrnet.HRNET_TINY, num_joints=NUM_JOINTS), device=device,
                       generator=torch.Generator().manual_seed(1))
    return det, hr


def check_tiny_against_cpu(torch, m) -> None:
    """The tiny serving path on the card (kernels) vs the CPU (plain), in
    both forms, and PnP on the card against a known pose."""
    import numpy as np

    pnp, geometry = m.pnp, m.geometry
    cfg = m.pipeline.PipelineConfig(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=(112, 112))
    rng = np.random.default_rng(0)
    lm3d = rng.normal(size=(NUM_JOINTS, 3)).astype(np.float32)
    K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
    frames_np = rng.integers(0, 255, (4, 120, 192, 3)).astype(np.uint8)
    # one quantization, on the CPU, serves both devices
    det_cpu, hr_cpu = tiny_models(torch, m, "cpu", torch.float32)
    calib = torch.from_numpy(rng.integers(0, 255, (2, 64, 64, 3)).astype(np.float32))
    qb = m.backbone_int8.quantize_backbone(det_cpu.config.backbone, det_cpu, det_cpu.normalize(calib))
    qh = m.hrnet_int8.quantize_hrnet(hr_cpu, m.pipeline.normalize_crops(calib))
    crops = torch.from_numpy(rng.integers(0, 255, (4, 64, 64, 3)).astype(np.float32))
    for form in ("bf16", "int8"):
        outs = {}
        for device in ("cpu", "cuda"):
            det, hr = tiny_models(torch, m, device, torch.float32)
            if form == "bf16":
                server = m.serving.PoseServer(det, hr, lm3d, K, np.zeros(5, np.float32), cfg, det_every=2,
                                              det_size=64)
            else:
                server = m.serving.build_int8_server(det, hr, lm3d, K, np.zeros(5, np.float32), cfg, det_every=2,
                                                     det_size=64, backbone_q=qb, hrnet_q=qh, **FUSED)
            outs[device] = {k: v.cpu() for k, v in server(torch.from_numpy(frames_np).to(device)).items()}
            with torch.inference_mode():
                x = crops.to(device)
                outs[device]["heatmaps"] = server.landmarks(x if form == "int8" else m.pipeline.normalize_crops(x)).cpu()
        cpu, gpu = outs["cpu"], outs["cuda"]
        # The crops follow the detected boxes, which differ by ~1e-5 px
        # between the card and the CPU; int8 rounding turns that into a
        # whole int8 step somewhere, and on the random tiny net's near-flat
        # heatmaps that moves the argmax. So the int8 form's keypoints are
        # not compared: its heatmaps on the same crops are.
        checks = (("det_boxes", 1e-2), ("keypoints", 1e-2), ("confidence", 1e-3)) if form == "bf16" else \
            (("det_boxes", 1e-2),)
        for key, tol in checks:
            err = (gpu[key] - cpu[key]).abs().max().item()
            log(f"tiny {form} path, card vs CPU: {key} max_abs_err={err:.3g} (limit {tol})")
            if not err <= tol:
                raise RuntimeError(f"tiny {form} serving path: {key} differs between the card and the CPU by {err}")
        a, b = gpu["heatmaps"].flatten().double(), cpu["heatmaps"].flatten().double()
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        log(f"tiny {form} path, card vs CPU: heatmaps on the same crops max_abs_err={(a - b).abs().max().item():.3g} "
            f"of peak {b.abs().max().item():.3g}, {int((a != b).sum())} of {a.numel()} differ, correlation {corr:.6f} "
            f"(limit 0.995); keypoints max_abs_err={(gpu['keypoints'] - cpu['keypoints']).abs().max().item():.3g}")
        if not corr >= 0.995:
            raise RuntimeError(f"tiny {form} serving path: heatmaps correlate {corr} between the card and the CPU")
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


def check_tensor_core_sass(cuda) -> None:
    """K5a, K5, K6 and K7 multiply on the int8 tensor cores: their SASS
    holds IGMMA (wgmma) and no IDP4A."""
    import os

    cuobjdump = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    for source in TENSOR_CORE_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(cuda._target(source))], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        counts = {op: sass.count(op) for op in ("IGMMA", "IMMA", "IDP4A")}
        log(f"SASS of {source}: {json.dumps(counts)}")
        if counts["IGMMA"] + counts["IMMA"] == 0 or counts["IDP4A"]:
            raise RuntimeError(f"{source} does not run on the int8 tensor cores: {counts}")


POOLER_SIZE, POOLER_STRIDES, POOLER_WINDOW = 768, (4, 8, 16, 32), 48  # the served R101-FPN pooler


def coverage_boxes(torch, r: int, size: int, gen):
    """r boxes on a size x size image that reach every level P2..P5 (sides
    8 px to twice the image), cross the image's edges (centres up to 64 px
    outside it) and exceed the read window (aspect ratios up to 8:1)."""
    u = lambda: torch.rand(r, generator=gen, dtype=torch.float64)
    side = torch.exp(math.log(8.0) + u() * math.log(2.0 * size / 8.0))
    aspect = torch.exp((u() - 0.5) * 2.0 * math.log(8.0)).sqrt()
    w, h = side * aspect, side / aspect
    cx, cy = u() * (size + 128) - 64, u() * (size + 128) - 64
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).float()


def check_pooler_coverage(torch, m) -> None:
    """K2 against its plain version on seeded boxes that the served
    proposals may not reach (random weights can put them all on one level):
    every level, the image's edges, boxes larger than the read window; f32
    and bf16 features, 256 and 16 channels; 1e-5 of the output's scale."""
    gen = torch.Generator().manual_seed(4)
    r, n_img = 256, DET_BATCH
    boxes = coverage_boxes(torch, r, POOLER_SIZE, gen).cuda()
    batch_idx = torch.randint(0, n_img, (r,), generator=gen, dtype=torch.int32).cuda()
    levels = m.roi_align.assign_levels(boxes, len(POOLER_STRIDES), int(math.log2(POOLER_STRIDES[0])))
    stride = torch.tensor(POOLER_STRIDES, device=boxes.device, dtype=torch.float32)[levels]
    edge = int(((boxes[:, :2] < 0) | (boxes[:, 2:] > POOLER_SIZE)).any(-1).sum())
    wide = int((((boxes[:, 2] - boxes[:, 0]) / stride > POOLER_WINDOW + 8)
                | ((boxes[:, 3] - boxes[:, 1]) / stride > POOLER_WINDOW)).sum())
    hist = torch.bincount(levels, minlength=len(POOLER_STRIDES)).tolist()
    log(f"K2 coverage boxes: {r} over {n_img} images, per level P2..P5 {hist}, {edge} across the image's edge, "
        f"{wide} larger than the read window")
    if min(hist) == 0 or edge == 0 or wide == 0:
        raise RuntimeError("K2 coverage boxes miss a level, the edge or the window")
    for dtype in (torch.float32, torch.bfloat16):
        for c in (256, 16):
            feats = [torch.randn(n_img, POOLER_SIZE // s, POOLER_SIZE // s, c, generator=gen).to(boxes.device, dtype)
                     for s in POOLER_STRIDES]
            args = (feats, boxes, batch_idx, 7, POOLER_STRIDES)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the window-coverage warning: these boxes exceed it on purpose
                got = m.roi_align.roi_align_multilevel(*args, sampling_ratio=2, window=POOLER_WINDOW)
                want = m.roi_align.roi_align_multilevel_plain(*args, sampling_ratio=2, window=POOLER_WINDOW)
            sync()
            err, share, ok = compare(got, want, None)
            log(f"K2 coverage, {dtype} features, C {c}: max_abs_err {err:.3g} of scale "
                f"{want.abs().max().item():.3g}, share off {share:.3g} (limit 1e-5 of the scale)")
            if not ok:
                raise RuntimeError(f"K2 disagrees with its plain version on the coverage boxes ({dtype}, C {c}): {err}")


SINGLE_MAPS = ((192, 192), (40, 120), (100, 50), (30, 44))  # the served P2; h < 48; w < 56; both
SINGLE_SCALES = (0.25, 0.3, 1.0 / 12)


def single_coverage_boxes(torch, h: int, w: int, scale: float, gen):
    """Boxes in image pixels on an (h, w) map at ``scale``: across each of
    its four edges and all four at once, larger than the (48, 56) read
    window, zero-area, wholly outside the map (the last 4 of 13), then a
    random bulk of 48 (sides log-uniform from 2 px to 1.2x the image,
    centres up to a tenth of it outside)."""
    ih, iw = h / scale, w / scale
    big = (POOLER_WINDOW + 24) / scale
    fixed = torch.tensor([
        [-40, 0.3 * ih, 0.4 * iw, 0.6 * ih], [0.2 * iw, -30, 0.5 * iw, 0.4 * ih],
        [0.7 * iw, 0.2 * ih, iw + 50, 0.5 * ih], [0.3 * iw, 0.8 * ih, 0.6 * iw, ih + 45],
        [-25, -25, iw + 25, ih + 25],
        [0.05 * iw, 0.05 * ih, 0.05 * iw + big, 0.05 * ih + big],
        [0.4 * iw, 0.4 * ih, 0.4 * iw, 0.6 * ih], [0.4 * iw, 0.5 * ih, 0.7 * iw, 0.5 * ih],
        [0.5 * iw, 0.5 * ih, 0.5 * iw, 0.5 * ih],
        [-60 / scale, 0.2 * ih, -3 / scale, 0.6 * ih], [iw + 3 / scale, 0.1 * ih, iw + 40 / scale, 0.9 * ih],
        [0.2 * iw, -50 / scale, 0.7 * iw, -3 / scale], [0.1 * iw, ih + 3 / scale, 0.5 * iw, ih + 30 / scale],
    ], dtype=torch.float64)
    u = lambda: torch.rand(48, generator=gen, dtype=torch.float64)
    bw, bh = 2 * (0.6 * iw) ** u(), 2 * (0.6 * ih) ** u()  # log-uniform, 2 px to 1.2x the image
    cx, cy = (u() * 1.2 - 0.1) * iw, (u() * 1.2 - 0.1) * ih
    bulk = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return torch.cat([fixed, bulk]).float()


def check_single_coverage(torch, m) -> None:
    """K3 against its plain version where the served call does not reach:
    maps of 192x192, shorter than the window (h < 48), narrower than window
    + 8 (w < 56) and smaller on both axes; spatial scales 0.25, 0.3 and
    1/12; boxes across every edge, larger than the window, zero-area,
    wholly outside the map (all-zero output) and a random bulk; f32 and
    bf16 features, 256 and 16 channels; 1e-5 of the output's scale. A CUDA
    call with 12 channels must raise ValueError."""
    gen = torch.Generator().manual_seed(6)
    ra = m.roi_align
    worst = 0.0
    for h, w in SINGLE_MAPS:
        for scale in SINGLE_SCALES:
            boxes = single_coverage_boxes(torch, h, w, scale, gen).cuda()
            cells = boxes * scale - 0.5
            edge = int(((cells[:, 0] < 0) | (cells[:, 1] < 0) | (cells[:, 2] > w - 1) | (cells[:, 3] > h - 1)).sum())
            wide = int(((cells[:, 2] - cells[:, 0] > POOLER_WINDOW + 8) | (cells[:, 3] - cells[:, 1] > POOLER_WINDOW))
                       .sum())
            errs = []
            for dtype in (torch.float32, torch.bfloat16):
                for c in (256, 16):
                    feat = torch.randn(h, w, c, generator=gen).to(boxes.device, dtype)
                    args = (feat, boxes, 7, scale, 2, POOLER_WINDOW)
                    got, want = ra.roi_align_single(*args), ra.roi_align_single_plain(*args)
                    sync()
                    err, share, ok = compare(got, want, None)
                    outside = got[-52:-48].abs().max().item()  # the 4 boxes wholly outside the map
                    errs.append(f"{str(dtype)[6:]} C {c}: {err:.3g} of {want.abs().max().item():.3g}")
                    worst = max(worst, err / max(1.0, want.abs().max().item()))
                    if not ok or outside != 0.0:
                        raise RuntimeError(f"K3 disagrees with its plain version on a {h}x{w} map at scale {scale} "
                                           f"({dtype}, C {c}): max_abs_err {err}, outside boxes {outside}")
            log(f"K3 coverage, {h}x{w} map at scale {scale:.4g}, {boxes.shape[0]} boxes ({edge} across the map's "
                f"edge, {wide} larger than the read window): max_abs_err " + "; ".join(errs) +
                " (limit 1e-5 of the scale)")
    log(f"K3 coverage: worst error {worst:.3g} of the output's scale over {len(SINGLE_MAPS) * len(SINGLE_SCALES) * 4} "
        "cases")
    try:
        ra.roi_align_single(torch.zeros(16, 16, 12, device="cuda"), torch.zeros(1, 4, device="cuda"), 7, 0.25)
    except ValueError as e:
        log(f"K3 with C 12 on the card raises: {e}")
    else:
        raise RuntimeError("K3 with C 12 on the card did not raise")


def nms_edge_problems(torch, n: int, p: int, gen, valid_share: float = 0.8):
    """p score-sorted problems of n boxes: clustered boxes with exact
    duplicates, zero-width and zero-height boxes, tied scores, a share
    ``valid_share`` of them valid; problem 0 has no valid box."""
    u = lambda *shape: torch.rand(*shape, generator=gen)
    centres = u(p, 4, 2) * 200
    pick = torch.randint(0, 4, (p, n), generator=gen)
    c = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) + torch.randn(p, n, 2, generator=gen) * 8
    wh = 5 + u(p, n, 2) * 55
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    scores = torch.floor(u(p, n) * max(n // 4, 1))  # ties: about four boxes per score
    valid = u(p, n) < valid_share
    valid[0] = False
    dst, src = torch.randint(0, n, (n // 4 + 1,), generator=gen), torch.randint(0, n, (n // 4 + 1,), generator=gen)
    boxes[:, dst] = boxes[:, src]
    zero = torch.randint(0, n, (n // 8 + 1,), generator=gen)
    boxes[:, zero[::2], 2] = boxes[:, zero[::2], 0]
    boxes[:, zero[1::2], 3] = boxes[:, zero[1::2], 1]
    order = torch.sort(torch.where(valid, scores, -torch.inf), dim=-1, descending=True, stable=True).indices
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(),
            torch.gather(valid, 1, order).contiguous())


def check_nms_coverage(torch, m) -> None:
    """K4 exact against its plain version at N = 1, 63, 65 and 1024 (edges
    of its 64-bit words and its largest problem, 128 KB of mask in shared
    memory), with duplicates, ties, zero-area boxes and an all-invalid
    problem, at IoU thresholds 0, 0.5 and 0.99."""
    gen = torch.Generator().manual_seed(5)
    for n in (1, 63, 65, 1024):
        boxes, valid = (t.cuda() for t in nms_edge_problems(torch, n, 4, gen))
        for thresh in (0.0, 0.5, 0.99):
            got = m.nms.nms_mask_sorted(boxes, valid, thresh)
            want = m.nms.nms_mask_sorted_plain(boxes, valid, thresh)
            sync()
            off = int((got != want).sum())
            log(f"K4 coverage, 4 problems of {n} at IoU {thresh}: {int(want.sum())} kept of {int(valid.sum())} "
                f"valid, {off} differ (limit 0)")
            if off or got.dtype != torch.bool:
                raise RuntimeError(f"K4 disagrees with its plain version at N {n}, IoU {thresh}: {off} differ")


def touched_cells(torch, taps, h, w) -> int:
    """Cells of an (h, w) map that some box's nonzero taps read."""
    (ky, wy), (kx, wx) = taps
    touched = torch.zeros((h, w), dtype=torch.bool, device=ky.device)
    for i in range(ky.shape[0]):
        ys, xs = ky[i][wy[i] > 0].unique(), kx[i][wx[i] > 0].unique()
        touched[ys[:, None], xs[None, :]] = True
    return int(touched.sum())


def single_numbers(torch, roi_align, feat, boxes, p, scale, s, window):
    """Bytes K3 must move (the cells its taps touch, the boxes, the pooled
    output) and its FLOPs (53 per output value at sampling ratio 2)."""
    h, w, c = feat.shape
    cells = touched_cells(torch, roi_align.single_taps(boxes, h, w, scale, p, s, window), h, w)
    r = boxes.shape[0]
    return cells * c * feat.element_size() + r * p * p * c * 4 + r * 16, 53.0 * r * p * p * c


def pooler_numbers(torch, roi_align, args, kwargs):
    """Bytes K2 must move (the feature cells its taps touch, read once per
    image and level; boxes, indices; the pooled output) and its FLOPs
    (53 per output value at sampling ratio 2); and the bytes of the tap
    loads it issues (every nonzero tap of every sample, C channels each),
    which L1 and L2 serve."""
    feats, boxes, batch_idx, p, strides = args[:5]
    s, window = kwargs.get("sampling_ratio", 2), kwargs.get("window", 48)
    c = feats[0].shape[-1]
    r = boxes.shape[0]
    levels = roi_align.assign_levels(boxes, len(feats), int(math.log2(strides[0])))
    cells = taps_read = 0
    for li, (f, stride) in enumerate(zip(feats, strides)):
        for img in range(f.shape[0]):
            sel = torch.nonzero((levels == li) & (batch_idx == img)).flatten()
            if sel.numel():
                taps = roi_align.level_taps(boxes[sel], f.shape[1], f.shape[2], stride, p, s, window)
                cells += touched_cells(torch, taps, f.shape[1], f.shape[2])
                (_, wy), (_, wx) = taps  # a bin's samples pair its S rows with its S columns
                taps_read += int(((wy != 0).sum((1, 2)) * (wx != 0).sum((1, 2))).sum())
    nbytes = cells * c * feats[0].element_size() + r * p * p * c * 4 + r * (16 + 4)
    return nbytes, 53.0 * r * p * p * c, taps_read * c * feats[0].element_size()


def roi_sample_grid(torch, boxes, scale: float, h: int, w: int, p: int, s: int):
    """``F.grid_sample`` coordinates (n, P*S, P*S, 2) of the ROIAlign sample
    points of boxes (n, 4) on an (h, w) map at ``scale`` (align_corners
    False: pixel x sits at (2x + 1) / w - 1)."""
    dev = boxes.device
    pts = (torch.arange(p, device=dev)[:, None] + (torch.arange(s, device=dev)[None, :] + 0.5) / s).reshape(-1)
    x0, y0, x1, y1 = (boxes * scale - 0.5).unbind(-1)
    sx = x0[:, None] + pts * (x1 - x0)[:, None] / p
    sy = y0[:, None] + pts * (y1 - y0)[:, None] / p
    gx = ((2 * sx + 1) / w - 1)[:, None, :].expand(-1, p * s, -1)
    gy = ((2 * sy + 1) / h - 1)[:, :, None].expand(-1, -1, p * s)
    return torch.stack([gx, gy], -1)


def grid_pool_call(torch, maps_and_grids, s: int):
    """The library yardstick of an ROI pooler: per map, one bilinear
    ``F.grid_sample`` (border padding) of the NCHW f32 map at every box's
    sample points, then ``F.avg_pool2d(S)`` into the bins. A timing
    yardstick only: the port never calls it, and its edge semantics differ
    from ROIAlign's for samples at or below -1, so it is not compared."""
    import torch.nn.functional as F

    return lambda: [F.avg_pool2d(F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=False), s)
                    for x, g in maps_and_grids]


def pooler_library_call(torch, roi_align, args, kwargs):
    """K2's yardstick: per level, the (B, C, H_l, W_l) map and each image's
    boxes of that level as rows of one grid, padded to the level's largest
    per-image count (built once, outside the timed call)."""
    feats, boxes, batch_idx, p, strides = args[:5]
    s = kwargs.get("sampling_ratio", 2)
    levels = roi_align.assign_levels(boxes, len(feats), int(math.log2(strides[0])))
    calls = []
    for li, (f, stride) in enumerate(zip(feats, strides)):
        b, h, w, _ = f.shape
        per_img = [boxes[(levels == li) & (batch_idx == i)] for i in range(b)]
        most = max(len(x) for x in per_img)
        if most == 0:
            continue
        grid = torch.zeros(b, most, p * s, p * s, 2, device=boxes.device)
        for i, bx in enumerate(per_img):
            if len(bx):
                grid[i, :len(bx)] = roi_sample_grid(torch, bx, 1.0 / stride, h, w, p, s)
        calls.append((f.permute(0, 3, 1, 2).float().contiguous(), grid.reshape(b, most * p * s, p * s, 2)))
    return grid_pool_call(torch, calls, s)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_numbers(m, a):
    """K5a call: bytes (x, w, m, b read once, out written once) and int8 ops
    (2 per multiply-add)."""
    x, w = a["x"], a["w"]
    k, ho = w.shape[0], m.int8_conv.out_size(x.shape[1], w.shape[0], a["stride"])
    wo = m.int8_conv.out_size(x.shape[2], k, a["stride"])
    out = x.shape[0] * ho * wo * w.shape[3] * (4 if a["out_f32"] else 1)
    return nbytes(x, w, a["m"], a["b"]) + out, 2.0 * x.shape[0] * ho * wo * w.shape[3] * k * k * w.shape[2]


def chain_numbers(a):
    """K5 call: one read of x and the weights, one write of the output; two
    3x3 convs per block."""
    x = a["x"]
    bsz, h, w, c = x.shape
    return nbytes(x, a["w"], a["m"], a["b"], a["coeffs"]) + x.numel(), 2.0 * bsz * h * w * c * 9 * c * 2 * a["nblocks"]


def bottleneck_numbers(a):
    """K6 call: layer1's convs, block 0 with its projection shortcut."""
    x, n = a["x"], a["nblocks"]
    bsz, h, w, cin0 = x.shape
    cm, cout = a["w2"].shape[-1], a["w3"].shape[-1]
    macs = cin0 * cm + 9 * cm * cm + cm * cout + cin0 * cout + (n - 1) * (cout * cm + 9 * cm * cm + cm * cout)
    weights = nbytes(*(a[k] for k in ("w1", "m1", "b1", "w2", "m2", "b2", "w3", "m3", "b3", "wd", "md", "bd",
                                      "coeffs")))
    return x.numel() + weights + bsz * h * w * cout, 2.0 * bsz * h * w * macs


def exchange_numbers(a):
    """K7 call: every operand read once, the output written once; the 1x1s."""
    yi = a["yi"]
    ups = a["ups"]
    ops = sum(2.0 * u.shape[0] * u.shape[1] * u.shape[2] * u.shape[3] * yi.shape[3] for u, *_ in ups)
    return nbytes(yi, *a["downs"], *(t for up in ups for t in up), a["coeffs"]) + yi.numel(), ops


def single_level_row(torch, m, captures):
    """K3 on the served detector's own inputs: the P2 map of the first
    keyframe of the int8 serving run (bf16 NHWC) and that image's box-head
    proposals, as K2 was handed them; launched once with its counter reset
    just before and read just after."""
    feats, boxes, batch_idx = captures["K2"].calls[0][0][:3]
    feat = feats[0][0]
    boxes0 = boxes[batch_idx == 0].contiguous()
    args = (feat, boxes0, 7, 0.25, 2, 48)  # output_size, spatial_scale (P2's 1 / 4), sampling, window
    m.roi_align.SINGLE.launches = 0
    out = m.roi_align.roi_align_single(*args)
    sync()
    launches = m.roi_align.SINGLE.launches
    log(f"K3 phase: roi_align_single on P2 {tuple(feat.shape)} {feat.dtype}, {boxes0.shape[0]} proposals -> "
        f"{tuple(out.shape)}; launches {launches}")
    if launches == 0 or not torch.isfinite(out).all():
        raise RuntimeError(f"K3 phase: {launches} launches, finite output {bool(torch.isfinite(out).all())}")
    h, w, _ = feat.shape
    grid = roi_sample_grid(torch, boxes0, args[3], h, w, args[2], args[4]).reshape(1, -1, args[2] * args[4], 2)
    lib = grid_pool_call(torch, [(feat.permute(2, 0, 1)[None].float().contiguous(), grid.contiguous())], args[4])
    row = dict(id="K3", name=f"roi_align_single (P2 of one served keyframe, its {boxes0.shape[0]} proposals)",
               source="spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel.cu",
               replaces="spacecraft_pose_estimation_tpu/ops/pallas_pooler.py:262",
               run_k=lambda: m.roi_align.roi_align_single(*args),
               run_p=lambda: m.roi_align.roi_align_single_plain(*args), run_lib=lib, tol=None, peak=FP32_FLOPS,
               numbers=single_numbers(torch, m.roi_align, *args[:3], args[3], args[4], args[5]))
    return row, {"K3": launches}


def int_mm_call(torch, a):
    """torch._int_mm on the im2col of a K5a call (K and N padded to the
    multiples of 8 that it needs): the int32 GEMM of the conv, no epilogue.
    A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    x, w, s = a["x"], a["w"], a["stride"]
    k = w.shape[0]
    if a["groups"] != 1:
        return None
    xp = F.pad(x, (0, 0, k // 2, k // 2, k // 2, k // 2))
    cols = xp.unfold(1, k, s).unfold(2, k, s)  # (B, Ho, Wo, C, k, k)
    A = cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * x.shape[3])
    Bm = w.reshape(k * k * w.shape[2], w.shape[3])
    pk, pn = -A.shape[1] % 8, -Bm.shape[1] % 8
    A = F.pad(A, (0, pk)).contiguous()
    Bm = F.pad(Bm, (0, pn, 0, pk))
    for b in (Bm.contiguous(), Bm.t().contiguous().t()):  # row-major, or the column-major some versions want
        try:
            torch._int_mm(A, b)
        except RuntimeError as e:
            err = e
            continue
        return lambda b=b: torch._int_mm(A, b)
    log(f"torch._int_mm refused A {tuple(A.shape)}, B {tuple(Bm.shape)}: {err}")
    return None


def build_server(torch, m, dev, form, det_cfg, hr_cfg, det_size, config):
    """The bf16 server, or the int8 one quantized from the same float models."""
    detector = m.rcnn.GeneralizedRCNN(det_cfg, dtype=torch.bfloat16, device=dev,
                                      generator=torch.Generator().manual_seed(0))
    landmarks = m.hrnet.HRNet(hr_cfg.with_joints(NUM_JOINTS), dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(1))
    lm3d = torch.randn(NUM_JOINTS, 3, generator=torch.Generator().manual_seed(2))
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    if form == "bf16":
        return m.serving.PoseServer(detector, landmarks, lm3d, K, torch.zeros(5), config,
                                    det_every=DET_EVERY, det_size=det_size), lm3d, K
    t0 = time.perf_counter()
    server = m.serving.build_int8_server(detector, landmarks, lm3d, K, torch.zeros(5), config,
                                         det_every=DET_EVERY, det_size=det_size, **FUSED)
    sync()
    log(f"int8 quantization of R101 + HRNet-W32 (calibration on the card, folding on the host): "
        f"{time.perf_counter() - t0:.2f} s")
    return server, lm3d, K


def serve(torch, m, dev, form, det_cfg, hr_cfg, frame_hw, det_size, config, clips_n, expect):
    """Warm up once (recording each kernel's inputs), then serve ``clips_n``
    clips with the launch counters reset just before and read just after.
    Every kernel in ``expect`` must have launched.

    Returns the launch counts, the captures and what the stage timing
    needs (server, one clip, landmarks, camera).
    """
    server, lm3d, K = build_server(torch, m, dev, form, det_cfg, hr_cfg, det_size, config)
    clip = DET_BATCH * DET_EVERY
    gd = torch.Generator(device=dev).manual_seed(3)
    clips = [torch.randint(0, 256, (clip, *frame_hw, 3), dtype=torch.uint8, device=dev, generator=gd)
             for _ in range(clips_n + 1)]

    captures = {key: Capture(mod, name) for key, (mod, name, _) in m.kernels.items()}
    with contextlib.ExitStack() as stack:
        for c in captures.values():
            stack.enter_context(c)
        server(clips[0])  # warm-up, and the kernels' serving inputs
        sync()
    feats, boxes, _, _, strides = captures["K2"].calls[0][0][:5]
    levels = m.roi_align.assign_levels(boxes, len(feats), int(math.log2(strides[0])))
    log(f"{form}: the served ROIs per pyramid level P2..P5: "
        f"{torch.bincount(levels, minlength=len(feats)).tolist()} of {boxes.shape[0]}")

    for _, _, k in m.kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    outs = [server(frames) for frames in clips[1:]]
    sync()
    seconds = time.perf_counter() - t0
    launches = {key: k.launches for key, (_, _, k) in m.kernels.items()}
    log(f"serving {form}: {clips_n} clips x {clip} frames of {frame_hw[1]}x{frame_hw[0]} in {seconds:.4f} s = "
        f"{clips_n * clip / seconds:.2f} frames/s (det_batch {DET_BATCH}, det_every {DET_EVERY}, "
        f"det_size {det_size}); launches {json.dumps(launches)}")
    for key in expect:
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by the {form} serving run")
    for out in outs:
        for key, shape in (("R", (clip, 3, 3)), ("t", (clip, 3)), ("quat", (clip, 4)),
                           ("keypoints", (clip, NUM_JOINTS, 2))):
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                raise RuntimeError(f"served {form} {key}: shape {tuple(out[key].shape)} or non-finite values")
    log(f"{form} poses finite; first t {outs[0]['t'][0].tolist()}, first box {outs[0]['det_boxes'][0].tolist()}")
    run = SimpleNamespace(form=form, server=server, landmarks=server.landmarks, frames=clips[1], config=config,
                          lm3d=lm3d.to(dev), K=K.to(dev), dist=torch.zeros(5, device=dev))
    return launches, captures, run


def stage_times(torch, m, run) -> dict[str, float]:
    """Device time (CUDA events, ms) of each serving stage on one clip."""
    server, frames, config = run.server, run.frames, run.config
    int8 = run.form == "int8"
    with torch.inference_mode():
        lb, _ = m.serving.letterbox(frames[:: server.det_every], server.det_size)
        _, boxes = server.detect(frames)
        land = m.pipeline.make_landmark_stage(run.landmarks, config)(frames, boxes)
        centers, scales = land["centers"], land["scales"]
        crops = m.warp.crop_and_resize(frames, centers, scales, config.image_size)
        w = m.pnp.adaptive_confidence_mask(land["confidence"], min_count=config.min_keypoints).float()
        x_norm = server.detector.normalize(lb)
        backbone = ("detector: int8 backbone (K5a)", lambda: m.backbone_int8.backbone_int8_apply(
            server.detector.config.backbone, server.backbone_q, x_norm)) if int8 else \
            ("detector: backbone+fpn", lambda: server.detector.pyramid(lb))
        stages = {
            "letterbox": lambda: m.serving.letterbox(frames[:: server.det_every], server.det_size),
            backbone[0]: backbone[1],
            "detector: all": lambda: server.detections(lb),
            "crop (K1)": lambda: m.warp.crop_and_resize(frames, centers, scales, config.image_size),
            ("hrnet int8 on raw crops (K5a, K5, K6, K7)" if int8 else "normalize+hrnet"):
                (lambda: run.landmarks(crops)) if int8 else
                (lambda: run.landmarks(m.pipeline.normalize_crops(crops))),
            "decode": lambda: m.heatmap.decode_heatmaps(land["heatmaps"], centers, scales),
            "pnp (epnp+gn)": lambda: m.pnp.solve_pnp(run.lm3d, land["keypoints"], run.K, run.dist, w,
                                                      config.refine_iters),
            "clip: server call": lambda: server(frames),
        }
        times = {name: time_ms(fn, 5) for name, fn in stages.items()}
    log(f"stage device ms per {run.form} clip: " + json.dumps({k: round(v, 4) for k, v in times.items()}))
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
    # every kernel's own device time: the port's kernels are launched through
    # ctypes, under no torch op, so a sum over host ops would miss them
    busy_us = sum(e.self_device_time_total for e in table if e.device_type == DeviceType.CUDA)
    log(f"profile {run.form}: device busy {busy_us:.0f} us of {wall_us:.0f} us wall (profiler on) = "
        f"{busy_us / wall_us:.4f}")


def check_fused_against_per_op(torch, m, run, captures) -> None:
    """The fused int8 HRNet (K5, K6, K7) against the per-op one (K5a only)
    on the served crops, within the JAX package's bound for the same
    comparison (tests/test_pallas_blocks.py:225)."""
    crops = m.warp.crop_bilinear(*captures["K1"].calls[0][0])
    fused = run.landmarks
    per_op = m.hrnet_int8.HRNetInt8(fused.config, fused.q, fold_normalize=fused.fold_normalize, device=fused.device)
    with torch.inference_mode():
        a, b = fused(crops), per_op(crops)
    sync()
    err = (a - b).abs().max().item()
    ok = torch.allclose(a, b, atol=2e-2, rtol=1e-3)
    log(f"int8 HRNet-W32, fused vs per-op on {crops.shape[0]} served crops: max_abs_err {err:.3g} "
        f"(limit 2e-2 + 1e-3 relative), {int((a != b).sum())} of {a.numel()} differ")
    if not ok:
        raise RuntimeError(f"fused int8 HRNet differs from the per-op walk by {err}")


def float_rows(torch, m, dev, captures):
    """K1, K2 and K4 rows on the inputs of the bf16 serving run's first call."""
    try:
        import torchvision.ops as tv_ops  # a yardstick only: the port never calls it
    except ImportError:
        tv_ops = None
    rows = []
    crop_args, _ = captures["K1"].calls[0]
    frames, params, out_size = crop_args
    frames_f = frames.permute(0, 3, 1, 2).float()
    h, w = frames.shape[1:3]
    xs = params[:, 0:1] * torch.arange(out_size[0], device=dev) + params[:, 1:2]
    ys = params[:, 2:3] * torch.arange(out_size[1], device=dev) + params[:, 3:4]
    grid = torch.stack([((2 * xs + 1) / w - 1)[:, None, :].expand(-1, out_size[1], -1),
                        ((2 * ys + 1) / h - 1)[:, :, None].expand(-1, -1, out_size[0])], dim=-1)
    rows.append(dict(id="K1", name="crop_bilinear", source="spacecraft_pose_estimation_tpu_torch/csrc/crop_bilinear.cu",
                     replaces="spacecraft_pose_estimation_tpu/ops/pallas_crop.py:191",
                     run_k=lambda: m.warp.crop_bilinear(*crop_args),
                     run_p=lambda: m.warp.crop_bilinear_plain(*crop_args),
                     run_lib=lambda: torch.nn.functional.grid_sample(frames_f, grid, mode="bilinear",
                                                                     padding_mode="zeros", align_corners=False),
                     tol=1e-3, peak=FP32_FLOPS, numbers=crop_numbers(torch, crop_args)))

    pool_args, pool_kwargs = captures["K2"].calls[0]
    *pool_totals, tap_bytes = pooler_numbers(torch, m.roi_align, pool_args, pool_kwargs)
    rows.append(dict(id="K2", name="roi_align_multilevel",
                     source="spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel.cu",
                     replaces="spacecraft_pose_estimation_tpu/ops/pallas_pooler.py:135",
                     run_k=lambda: m.roi_align.roi_align_multilevel(*pool_args, **pool_kwargs),
                     run_p=lambda: m.roi_align.roi_align_multilevel_plain(*pool_args, **pool_kwargs),
                     run_lib=pooler_library_call(torch, m.roi_align, pool_args, pool_kwargs), tol=None,
                     peak=FP32_FLOPS, numbers=tuple(pool_totals), extra={"tap_load_bytes": tap_bytes}))

    for i, (nms_args, _) in enumerate(captures["K4"].calls[:2]):  # the RPN's, then the box head's
        boxes, valid, thresh = nms_args
        p, n = valid.shape
        kept = float(m.nms.nms_mask_sorted_plain(boxes, valid, thresh).sum())
        lib = None
        if tv_ops is not None:
            idxs = torch.arange(p, device=dev)[:, None].expand(p, n)[valid]
            order = torch.arange(n, 0, -1, device=dev, dtype=torch.float32)[None].expand(p, n)[valid]
            lib = (lambda b=boxes[valid], s=order, i=idxs, th=thresh: tv_ops.batched_nms(b, s, i, th))
        rows.append(dict(id="K4", name=f"nms_mask_sorted ({'rpn' if i == 0 else 'box head'} {p}x{n})",
                         source="spacecraft_pose_estimation_tpu_torch/csrc/nms_mask_sorted.cu",
                         replaces="spacecraft_pose_estimation_tpu/ops/pallas_nms.py:67",
                         run_k=lambda a=nms_args: m.nms.nms_mask_sorted(*a),
                         run_p=lambda a=nms_args: m.nms.nms_mask_sorted_plain(*a),
                         run_lib=lib, tol=0.0, peak=FP32_FLOPS, numbers=(p * n * (16 + 1 + 1), kept * n * 15.0),
                         extra={"valid": int(valid.sum()), "kept": int(kept)}))
    return rows


def int8_rows(torch, m, captures):
    """K5a, K5, K6 and K7 rows: every call of one served int8 clip, replayed
    (kernel, plain version, library call) on the captured inputs."""
    specs = {
        "K5a": ("int8_conv (every int8 conv site of a clip: R101 backbone, HRNet stem2, transitions, fuse "
                "downs, head)", "int8_conv_requant.cu", "spacecraft_pose_estimation_tpu/models/hrnet_int8.py:394",
                lambda a: conv_numbers(m, a)),
        "K5": ("basic_block_chain (every HRNet branch chain of a clip)", "basic_block_chain.cu",
               "spacecraft_pose_estimation_tpu/ops/pallas_blocks.py:126", chain_numbers),
        "K6": ("bottleneck_chain (layer1 in 32-row strips, the layer1_strips route: K6s)", "bottleneck_chain.cu",
               "spacecraft_pose_estimation_tpu/ops/pallas_blocks.py:360", bottleneck_numbers),
        "K7": ("up_exchange (every fuse-exchange output of a clip)", "up_exchange.cu",
               "spacecraft_pose_estimation_tpu/ops/pallas_blocks.py:502", exchange_numbers),
    }
    plains = {"K5a": m.int8_conv.int8_conv_plain, "K5": m.int8_blocks.basic_block_chain_plain,
              "K6": m.int8_blocks.bottleneck_chain_plain, "K7": m.int8_blocks.up_exchange_plain}
    rows = []
    for key, (name, source, replaces, numbers) in specs.items():
        cap = captures[key]
        calls = [cap.bound(i) for i in range(len(cap.calls))]
        kernel = cap.orig
        drop = ("strip", "wk", "wks")  # the plain versions take the HWIO weights alone
        plain = plains[key]
        run_k = [lambda a=a, f=kernel: f(**a) for a in calls]
        run_p = [lambda a={k: v for k, v in a.items() if k not in drop}, f=plain: f(**a) for a in calls]
        totals = [numbers(a) for a in calls]
        lib = None
        if key == "K5a":
            libs = [int_mm_call(torch, a) for a in calls]
            lib = (lambda fs=libs: [f() for f in fs]) if all(libs) else None
        row = dict(id=key, name=name, source=f"spacecraft_pose_estimation_tpu_torch/csrc/{source}",
                   replaces=replaces, run_k=lambda fs=run_k: [f() for f in fs],
                   run_p=lambda fs=run_p: [f() for f in fs], run_lib=lib, tol="int8", peak=INT8_OPS,
                   numbers=(sum(b for b, _ in totals), sum(o for _, o in totals)), calls=len(calls))
        rows.append(row)
        if key == "K6":  # the same kernel on the fused_blocks route: two strips per image (K6)
            row["extra"] = {"workspace_bytes": workspace_bytes(m, calls)}
            whole = [dict(a, strip=None) for a in calls]
            rows.append(dict(row, name="bottleneck_chain (layer1, two strips per image, the fused_blocks route: K6)",
                             replaces="spacecraft_pose_estimation_tpu/ops/pallas_blocks.py:238",
                             run_k=lambda fs=[lambda a=a, f=kernel: f(**a) for a in whole]: [f() for f in fs],
                             extra={"workspace_bytes": workspace_bytes(m, whole)}))
    return rows


def workspace_bytes(m, calls) -> int:
    """K6's global workspace over ``calls`` (the bands of every strip)."""
    total = 0
    for a in calls:
        bsz, h, w, _ = a["x"].shape
        total += m.int8_blocks.bottleneck_workspace_bytes(bsz, h, w, a["w2"].shape[-1], a["w3"].shape[-1],
                                                          a["nblocks"], a["strip"])
    return total


def compare(got, want, tol) -> tuple[float, float, bool]:
    """(max abs error, share of entries off, within the limit). ``tol``
    "int8": the JAX package's rule for its int8 kernels (every int8 entry
    within 1 and under 2e-3 of them off; f32 outputs exact); a number: that
    absolute error; None: 1e-5 of the output's scale."""
    import torch

    gots, wants = (got, want) if isinstance(got, list) else ([got], [want])
    err, off, total, ok = 0.0, 0, 0, True
    for g, w in zip(gots, wants):
        d = (g.float() - w.float()).abs()
        e = d.max().item() if d.numel() else 0.0
        err, off, total = max(err, e), off + int((d > 0).sum()), total + d.numel()
        if tol == "int8":
            ok &= e <= (1.0 if g.dtype == torch.int8 else 0.0)
        else:
            limit = tol if tol is not None else 1e-5 * max(1.0, w.abs().max().item())
            ok &= e <= limit
    share = off / max(total, 1)
    if tol == "int8":
        ok &= share < 2e-3
    return err, share, bool(ok)


def kernel_report(rows, launches):
    """Hold each kernel to its plain version, then time kernel, plain and
    library call; raises on a disagreement."""
    report = []
    for row in rows:
        key, name = row["id"], row["name"]
        got, want = row["run_k"](), row["run_p"]()
        sync()
        err, share, ok = compare(got, want, row["tol"])
        limit = "int8 rule: |err| <= 1 on under 2e-3 of entries, f32 exact" if row["tol"] == "int8" else row["tol"]
        log(f"{key} {name}: max_abs_err {err:.3g}, share off {share:.3g} ({limit})")
        if not ok:
            raise RuntimeError(f"{key} {name} disagrees with its plain version: {err}, share {share}")
        nb, ops = row["numbers"]
        bound, bound_by = bound_ms(nb, ops, row["peak"])
        entry = {
            "name": name, "id": key, "route": "cuda", "source": row["source"], "replaces": row["replaces"],
            "launches": launches[key], "max_abs_err": err, "share_off": share,
            "ms": time_ms(row["run_k"], 10),
            "plain_ms": time_ms(row["run_p"], 2), "bound_ms": bound,
            "bound_by": bound_by, "bytes": nb, "ops": ops, "peak_ops_per_s": row["peak"],
            "library_ms": time_ms(row["run_lib"], 10) if row["run_lib"] is not None else None,
        }
        entry["device_ms"], entry["k"] = graph_ms(row["run_k"])
        if row["run_lib"] is not None:  # the yardstick's device time, as the kernel's
            entry["library_device_ms"], entry["library_k"] = graph_ms(row["run_lib"])
        entry["bound_share"] = bound / (entry["device_ms"] or entry["ms"])
        if "calls" in row:
            entry["calls_timed"] = row["calls"]
        entry.update(row.get("extra", {}))
        log(f"{key} {name}: {entry['ms']:.4f} ms ({entry['device_ms']} ms replayed from a CUDA graph of "
            f"{entry['k']} calls; plain "
            f"{entry['plain_ms']:.4f} ms, bound {bound:.5f} ms by {bound_by} = {entry['bound_share']:.4f} of the "
            f"device time, library {entry['library_ms']}, replayed {entry.get('library_device_ms')})" +
            "".join(f", {k} {v}" for k, v in row.get("extra", {}).items()))
        report.append(entry)
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from spacecraft_pose_estimation_tpu_torch import _cuda, pipeline, serving
    from spacecraft_pose_estimation_tpu_torch.models import backbone_int8, hrnet, hrnet_int8, rcnn
    from spacecraft_pose_estimation_tpu_torch.ops import (
        geometry, heatmap, int8_blocks, int8_conv, nms, pnp, roi_align, warp,
    )

    m = SimpleNamespace(rcnn=rcnn, hrnet=hrnet, hrnet_int8=hrnet_int8, backbone_int8=backbone_int8, pnp=pnp,
                        geometry=geometry, pipeline=pipeline, serving=serving, warp=warp, roi_align=roi_align,
                        nms=nms, heatmap=heatmap, int8_conv=int8_conv, int8_blocks=int8_blocks)
    # kernel id -> (module, wrapper name, launch counter)
    m.kernels = {
        "K1": (warp, "crop_bilinear", warp.KERNEL), "K2": (roi_align, "roi_align_multilevel", roi_align.KERNEL),
        "K3": (roi_align, "roi_align_single", roi_align.SINGLE),
        "K4": (nms, "nms_mask_sorted", nms.KERNEL), "K5a": (int8_conv, "int8_conv", int8_conv.KERNEL),
        "K5": (int8_blocks, "basic_block_chain", int8_blocks.CHAIN),
        "K6": (int8_blocks, "bottleneck_chain", int8_blocks.BOTTLENECK),
        "K7": (int8_blocks, "up_exchange", int8_blocks.EXCHANGE),
    }
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    # full float32 wherever float32 runs (the serving models run bf16 and int8)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_s = _cuda.build_all()
    log("build (s): " + json.dumps({k: round(v, 2) for k, v in build_s.items()}))
    check_tensor_core_sass(_cuda)
    check_pooler_coverage(torch, m)
    check_single_coverage(torch, m)
    check_nms_coverage(torch, m)
    check_tiny_against_cpu(torch, m)

    dev = torch.device("cuda")
    args = (rcnn.FASTER_RCNN_R101_SERVING_1OBJ, hrnet.POSE_HRNET_W32, FRAME_HW, 768, serving.SERVING_PIPELINE)
    launches, captures, run = serve(torch, m, dev, "bf16", *args, CLIPS, expect=("K1", "K2", "K4"))
    stage_times(torch, m, run)
    profile_clip(torch, run)
    report = kernel_report(float_rows(torch, m, dev, captures), launches)
    del run, captures

    launches, captures, run = serve(torch, m, dev, "int8", *args, CLIPS,
                                    expect=("K1", "K2", "K4") + INT8_IDS)
    check_fused_against_per_op(torch, m, run, captures)
    stage_times(torch, m, run)
    profile_clip(torch, run)
    report += kernel_report(int8_rows(torch, m, captures), launches)
    k3_row, k3_launches = single_level_row(torch, m, captures)
    k3 = kernel_report([k3_row], k3_launches)[0]
    k3["serving_launches"] = launches["K3"]  # no serving path calls it: nor does any in the JAX package
    report.append(k3)

    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
