#!/usr/bin/env python3
"""Drive the PyTorch port's serving, evaluation, training, domain-adaptation and detector-training paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit. It

1. builds the CUDA kernels of ``spacecraft_pose_estimation_tpu_torch/csrc``
   (one nvcc per source, in parallel) and reads the SASS of the four int8
   kernels K5a, K5, K6 and K7: integer tensor-core instructions (IGMMA),
   no dp4a;
2. holds K2 and its backward (``roi_align_multilevel_backward.cu``, in
   both read windows) to their plain versions on seeded boxes that the
   served proposals may not reach (every pyramid level, the image's edges,
   boxes larger than the read window, level boundaries; f32 and bf16
   features, 256 and 16 channels; the backward also on the 800^2
   pyramid, whose every level ends in partial tiles, with a level no box
   reaches and with no box at all, both exactly 0, and two calls equal
   bit for bit), K3 likewise on maps larger and smaller than its read window
   at spatial scales 0.25, 0.3 and 1/12 (boxes across every edge, larger
   than the window, zero-area, wholly outside the map; a CUDA call with 12
   channels must raise), and K4 exactly on seeded problems of 1, 63, 65,
   1024, 1025, 1500, 2000 and 2048 boxes with duplicates, ties, zero-area
   boxes and no valid box (2049 must raise);
   then checks the tiny detector + HRNet serving path on the card against
   the same path on the CPU (plain PyTorch versions of the kernels), in
   the bf16 form and in the int8 form with every fused route on, the
   latter also on a tiny grouped trunk (K5a on merged groups), and the
   PnP solvers against a known pose (RANSAC also with 3 of 11 points 200
   px off, and against the CPU on the same noise);
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
7. serves 2 clips of the X101 serving form (``FASTER_RCNN_X101_SERVING``
   in bf16, GN PnP: ``bench.py``'s ``det_kind="x101"``);
8. runs the fused evaluation entry (``evaluate.run_scene``) on 24 seeded
   1920x1200 BGR frames in batches of 8: X101-32x8d FPN
   (``FASTER_RCNN_X101_SPACECRAFT``, bf16, 768 letterbox), HRNet-W32 at
   512, RANSAC PnP with 256 hypotheses; checks its three artifacts, that
   K1, K2 and K4 launched (counters reset just before, read just after),
   holds K2 and K4 to their plain versions on its inputs, and times its
   stages and frames/s;
9. runs the staged evaluation's three stage functions
   (``tools.export_boxes``, ``tools.test_landmarks``, ``tools.export_poses``
   with RANSAC at 512 hypotheses) in process on the same frames, which
   stay on the card, and weights; checks their artifacts, holds their
   boxes and keypoints to the fused entry's within 1e-3 px, runs the flip
   test on one batch, checks that K1, K2 and K4 launched, and times each
   stage;
10. serves 2 clips of the int8 X101 form (``bench.py``'s
   ``det_kind="x101_int8"``: ``FASTER_RCNN_X101_SERVING`` on the int8
   ResNeXt backbone, K5a on grouped convs merged to whole tiles, and the
   int8 HRNet), holds K5a to its plain version on every grouped conv2 site
   of a keyframe batch and times them against ``torch._int_mm`` on the
   dense block-diagonal weights; the tiny grouped int8 trunk is checked
   against the CPU in step 2;
11. trains: first ``HRNET_TINY`` in float32 on the card against the CPU
   (the training transform on the same draws, then 3 Adam updates on the
   same batch); then ``tools.train_landmarks.train`` with the ``events``
   preset at full width (HRNet-W32, 512 -> 128, batch 24, bf16 activations
   over float32 weights, Adam 1e-3) on 96 seeded 1280x720 uint8 frames on
   the card with 11 projected landmarks, 2 epochs of 4 steps, the device
   cache on and a validation json of 16 frames (K1's counter reset just
   before, read just after; K1 held to its plain version on the last
   validation batch); checks the losses and parameters finite, the final
   ``.npz`` through ``evaluate.load_landmark_model`` (heatmaps 0 apart
   from the trained model's) and that 30 updates on one repeated batch
   lower its loss; prints step ms, images/s, transform, epoch and
   validation times and the peak memory;
12. adapts domains: first ``hrnet_tiny_cms`` and a (1, 1, 1, 1)
   discriminator in float32 on the card against the CPU, phase by phase
   over 3 DA updates; then ``tools.train_landmarks_da.train`` with the
   ``lightbox_cms`` preset at full width (HRNet-W32 CMS heads, 768 ->
   768^2, bf16 generator over float32, float32 ResNet-34 discriminator,
   2 source + 3 target images a step, d_loss_mode 2) on seeded 1920x1200
   frames on the card (8 source, 12 target, 16 target-domain validation),
   2 epochs of 4 steps and validation at the last (K1's counter reset just
   before, read just after; K1 held to its plain version on the 768^2
   validation batch); checks the losses finite, the generator's ``.npz``
   through ``tools.test_landmarks`` (0 apart) and that 10 DA updates on
   one batch lower its hm_loss; prints the step ms, images/s, the
   phases' split by CUDA events, the discriminator's share, a profiled
   step and the peak memory; runs ``sunlamp_cms`` (384^2 heatmaps) for an
   epoch of 2 steps, its step split and profiled too; and runs
   ``evaluate.run_scene`` with the trained CMS
   model on 8 frames (K1, K2 and K4 held to their plain versions);
13. trains the detector: first ``RCNN_TINY`` with ``freeze_at=2`` in
   float32 on the card against the CPU (3 SGD updates on the same batch
   and draws, the frozen tensors' weight decay included); then
   ``tools.train_detector.train`` with ``--preset config_1`` at full width
   (X101-32x8d FPN at 800^2, batch 4, ROI batch 128, flips, SGD 1e-3 with
   warmup 500, bf16 activations over float32 weights) on 32 seeded
   1920x1200 frames with one bright box each, 8 steps (cut from 5000) and
   one evaluation on 8 more (K2's, K2's backward's and K4's counters reset
   just before, read just after; each held to its plain version on a
   step's own inputs, K4 at N = 2000, K2's backward to 2^-7 of its
   gradient's scale, a bar that must reject the gradient doubled, a
   level's lost and each ROI's sent to another image's box, and two of
   its calls equal bit for bit); checks the
   losses and parameters finite, the final ``.npz`` through
   ``evaluate.load_detector`` (0 apart) and that 20 updates on one
   repeated batch lower loss_total;
   prints the step ms, images/s, peak memory, the box AP, the train
   step's own split by CUDA events and a profiled step;
14. prints the card, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the result
line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
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
    """Record the arguments of every call to ``module.name`` while active;
    with ``keep``, only those of the latest call whose positional arguments
    pass it, their tensors detached (a captured activation would keep its
    training step's autograd graph alive)."""

    def __init__(self, module, name: str, keep=None):
        self.module, self.name, self.calls, self.keep = module, name, [], keep
        self.orig = getattr(module, name)

    def __enter__(self):
        def detach(x):
            if isinstance(x, (list, tuple)):
                return type(x)(detach(y) for y in x)
            return x.detach() if hasattr(x, "detach") else x

        def record(*args, **kwargs):
            if self.keep is None:
                self.calls.append((args, kwargs))
            elif self.keep(args):
                self.calls = [(detach(args), kwargs)]
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


# a tiny ResNeXt trunk whose grouped 3x3s K5a runs merged: 8 groups of 8
# channels in res2 (4 to a tile), of 16 in res3 (2 to a tile), 32 and 64 after
TINY_GROUPED = dict(depth=50, stem_channels=8, res2_out_channels=64, groups=8, width_per_group=8,
                    stride_in_1x1=False)


def reset_counts(m) -> None:
    """Zero every launch counter: each kernel's, and K5a's grouped one."""
    for k in m.counters.values():
        k.launches = 0


def read_counts(m) -> dict[str, int]:
    return {key: k.launches for key, k in m.counters.items()}


def tiny_models(torch, m, device, dtype, backbone=None):
    """RCNN_TINY (on ``backbone`` when given) and HRNET_TINY from seeds, as
    the tiny checks build them."""
    import dataclasses

    det_cfg = m.rcnn.RCNN_TINY if backbone is None else dataclasses.replace(m.rcnn.RCNN_TINY, backbone=backbone)
    det = m.rcnn.GeneralizedRCNN(det_cfg, dtype=dtype, device=device, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # keep raw 0-255 pixels from saturating the random logits
        det.backbone.stem.conv.weight.mul_(1e-2)
    hr = m.hrnet.HRNet(dataclasses.replace(m.hrnet.HRNET_TINY, num_joints=NUM_JOINTS), device=device,
                       generator=torch.Generator().manual_seed(1))
    return det, hr


def check_tiny_against_cpu(torch, m) -> None:
    """The tiny serving path on the card (kernels) vs the CPU (plain), in
    both forms and in the int8 form on a grouped trunk, and PnP on the card
    against a known pose."""
    import numpy as np

    pnp, geometry = m.pnp, m.geometry
    cfg = m.pipeline.PipelineConfig(image_size=(64, 64), solver="gn", refine_iters=5, crop_window=(112, 112))
    rng = np.random.default_rng(0)
    lm3d = rng.normal(size=(NUM_JOINTS, 3)).astype(np.float32)
    K = np.array([[300.0, 0, 96.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
    frames_np = rng.integers(0, 255, (4, 120, 192, 3)).astype(np.uint8)
    # one quantization, on the CPU, serves both devices
    grouped = m.resnet_backbone.ResNetConfig(**TINY_GROUPED)
    det_cpu, hr_cpu = tiny_models(torch, m, "cpu", torch.float32)
    calib = torch.from_numpy(rng.integers(0, 255, (2, 64, 64, 3)).astype(np.float32))
    qbs = {"int8": m.backbone_int8.quantize_backbone(det_cpu.config.backbone, det_cpu, det_cpu.normalize(calib))}
    det_x, _ = tiny_models(torch, m, "cpu", torch.float32, grouped)
    qbs["int8 grouped trunk"] = m.backbone_int8.quantize_backbone(grouped, det_x, det_x.normalize(calib))
    qh = m.hrnet_int8.quantize_hrnet(hr_cpu, m.pipeline.normalize_crops(calib))
    crops = torch.from_numpy(rng.integers(0, 255, (4, 64, 64, 3)).astype(np.float32))
    for form in ("bf16", "int8", "int8 grouped trunk"):
        outs = {}
        for device in ("cpu", "cuda"):
            det, hr = tiny_models(torch, m, device, torch.float32, grouped if form.endswith("trunk") else None)
            if form == "bf16":
                server = m.serving.PoseServer(det, hr, lm3d, K, np.zeros(5, np.float32), cfg, det_every=2,
                                              det_size=64)
            else:
                server = m.serving.build_int8_server(det, hr, lm3d, K, np.zeros(5, np.float32), cfg, det_every=2,
                                                     det_size=64, backbone_q=qbs[form], hrnet_q=qh, **FUSED)
            m.int8_conv.GROUPED.launches = 0
            outs[device] = {k: v.cpu() for k, v in server(torch.from_numpy(frames_np).to(device)).items()}
            with torch.inference_mode():
                x = crops.to(device)
                raw = form.startswith("int8")  # the int8 HRNet folds the normalisation into its stem
                outs[device]["heatmaps"] = server.landmarks(x if raw else m.pipeline.normalize_crops(x)).cpu()
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
        if form.endswith("trunk"):
            grouped_launches = m.int8_conv.GROUPED.launches  # the card's run: the CPU's launches nothing
            log(f"tiny {form}: {grouped_launches} K5a launches at a merged group count above 1 (res2-res5 conv2)")
            if grouped_launches != 16:
                raise RuntimeError(f"tiny {form}: {grouped_launches} grouped K5a launches, not the 16 conv2 sites")
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
    check_ransac_gate(torch, m, world, R, t, K, dist, px)


def check_ransac_gate(torch, m, world, R, t, K, dist, px) -> None:
    """RANSAC PnP (256 hypotheses) on the card: the known pose from 11
    points, 3 of them moved 200 px off, within 1e-3 (t over its 10 m
    depth); and the same call on the CPU with the same Gumbel noise within
    1e-4."""
    px = px.clone()
    px[[1, 4, 7]] += torch.tensor([200.0, -200.0])
    gumbel = m.pnp.gumbel_noise((1, 256, 11), torch.Generator().manual_seed(7))
    conf = torch.ones(1, 11)
    outs = {dev: m.pnp.pnp_ransac(world.to(dev), px[None].to(dev), K.to(dev), dist.to(dev), conf.to(dev),
                                  gumbel=gumbel.to(dev), num_hypotheses=256)
            for dev in ("cuda", "cpu")}
    gpu, cpu = ({k: v.cpu() for k, v in o.items()} for o in (outs["cuda"], outs["cpu"]))
    err = max((gpu["R"][0] - R).abs().max().item(), (gpu["t"][0] - t).abs().max().item() / 10.0)
    dev_err = max((gpu["R"] - cpu["R"]).abs().max().item(), (gpu["t"] - cpu["t"]).abs().max().item())
    log(f"RANSAC PnP on the card, 3 of 11 points 200 px off: vs the true pose max_err={err:.3g} (limit 1e-3), "
        f"vs the CPU on the same noise {dev_err:.3g} (limit 1e-4); inliers {gpu['inliers'][0].int().tolist()}")
    if not (err <= 1e-3 and dev_err <= 1e-4 and gpu["inliers"][0].sum().item() == 8):
        raise RuntimeError(f"RANSAC PnP on the card: pose error {err}, card vs CPU {dev_err}, "
                           f"{int(gpu['inliers'][0].sum())} inliers")


def crop_numbers(torch, args):
    """Bytes K1 must move (each frame cell that a crop's bilinear taps
    touch read once, the parameters read once, the crops written once) and
    its FLOPs (12 per output value). A crop whose step is over 1 px taps
    only some of the rows and columns it spans."""
    frames, params, out_size = args[:3]
    b, h, w, _ = frames.shape
    ow, oh = out_size
    counts = []
    for n_out, limit, a, c in ((ow, w, 0, 1), (oh, h, 2, 3)):
        lo = torch.floor(params[:, a:a + 1] * torch.arange(n_out, device=params.device) + params[:, c:c + 1]).long()
        taps = torch.cat([lo, lo + 1], 1)
        hit = torch.zeros(b, limit + 1, dtype=torch.bool, device=params.device)
        hit.scatter_(1, torch.where((taps >= 0) & (taps < limit), taps, limit), True)  # [limit]: taps outside
        counts.append(hit[:, :limit].sum(1).double())
    nbytes = float((counts[0] * counts[1]).sum()) * 3 + params.numel() * 4 + b * oh * ow * 3 * 4
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


# boxes of side 112, 224 and 448 px: sqrt(area) on the P2/P3, P3/P4 and P4/P5 boundaries
LEVEL_BOUNDARY_BOXES = ((100.0, 100.0, 212.0, 212.0), (300.0, 200.0, 524.0, 424.0), (10.0, 20.0, 458.0, 468.0))


def pooler_grad_limit(dtype, scale: float) -> float:
    """K2's backward against the plain autograd gradient, by the gradient's
    own scale (its largest magnitude): the kernel sums each box's share
    separably (the bins' x weights first, then their y weights) and the
    boxes of a cell in index order, the plain version each tap's product
    in autograd's scatter order, so float32 is held to 1e-5 of the scale;
    the bf16 rounding of two float32 sums that differ in the last bits can
    land one bf16 unit apart (at most 2^-7 of the value), so bf16 to 2^-7
    of the scale. A zero gradient raises: no bar on it can tell a wrong
    kernel from the right one."""
    import torch

    if not scale > 0:
        raise RuntimeError(f"K2's backward is checked against a gradient of scale {scale}")
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale


def check_pooler_coverage(torch, m) -> None:
    """K2 and its backward against their plain versions on seeded boxes
    that the served proposals may not reach (random weights can put them
    all on one level): every level, the image's edges, boxes larger than
    the read window, three boxes on level boundaries; f32 and bf16
    features, 256 and 16 channels; the forward to 1e-5 of the output's
    scale, the backward to ``pooler_grad_limit``, and once through
    autograd (``roi_align_multilevel`` under ``backward()``)."""
    gen = torch.Generator().manual_seed(4)
    r, n_img = 256, DET_BATCH
    boxes = coverage_boxes(torch, r, POOLER_SIZE, gen)
    batch_idx = torch.randint(0, n_img, (r,), generator=gen, dtype=torch.int32)
    boxes = torch.cat([boxes, torch.tensor(LEVEL_BOUNDARY_BOXES)]).cuda()
    batch_idx = torch.cat([batch_idx, torch.arange(len(LEVEL_BOUNDARY_BOXES), dtype=torch.int32)]).cuda()
    r = boxes.shape[0]
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
    for impl, dtype, c in itertools.product(m.roi_align.IMPLS, (torch.float32, torch.bfloat16), (256, 16)):
        feats = [torch.randn(n_img, POOLER_SIZE // s, POOLER_SIZE // s, c, generator=gen).to(boxes.device, dtype)
                 for s in POOLER_STRIDES]
        args = (feats, boxes, batch_idx, 7, POOLER_STRIDES)
        kw = dict(sampling_ratio=2, window=POOLER_WINDOW, impl=impl)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the window-coverage warning: these boxes exceed it on purpose
            got = m.roi_align.roi_align_multilevel(*args, **kw)
            want = m.roi_align.roi_align_multilevel_plain(*args, **kw)
        sync()
        err, share, ok = compare(got, want, None)
        log(f"K2 coverage, {impl} window, {dtype} features, C {c}: max_abs_err {err:.3g} of scale "
            f"{want.abs().max().item():.3g}, share off {share:.3g} (limit 1e-5 of the scale)")
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version on the coverage boxes ({impl}, {dtype}, C {c}): "
                               f"{err}")
        grad_out = torch.randn(r, 7, 7, c, generator=gen).cuda()
        shapes = [tuple(f.shape) for f in feats]
        bargs = (grad_out, shapes, dtype, boxes, batch_idx, 7, POOLER_STRIDES, 2, POOLER_WINDOW, 224.0, 4, impl)
        got = m.roi_align.roi_align_multilevel_backward(*bargs)
        want = m.roi_align.roi_align_multilevel_backward_plain(*bargs)
        sync()
        scale = max(w.float().abs().max().item() for w in want)
        limit = pooler_grad_limit(dtype, scale)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        same_dtype = all(g.dtype == dtype for g in got)
        log(f"K2 backward coverage, {impl} window, {dtype} features, C {c}: max_abs_err {err:.3g} of scale {scale:.3g} "
            f"(limit {limit:.3g}); per level P2..P5 nonzero cells "
            f"{[int((g != 0).any(-1).sum()) for g in got]}")
        if err > limit or not same_dtype:
            raise RuntimeError(f"K2's backward disagrees with the plain gradient ({impl}, {dtype}, C {c}): {err}")
        if dtype == torch.bfloat16 and c == 256:  # the same through autograd
            leaves = [f.detach().requires_grad_() for f in feats]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m.roi_align.roi_align_multilevel(leaves, boxes, batch_idx, 7, POOLER_STRIDES, **kw).backward(grad_out)
            auto = max((f.grad.float() - w.float()).abs().max().item() for f, w in zip(leaves, want))
            log(f"K2 backward through autograd ({impl} window, bf16, C 256): max_abs_err {auto:.3g} "
                f"(limit {limit:.3g})")
            if auto > limit:
                raise RuntimeError(f"roi_align_multilevel's autograd gradient disagrees: {auto}")


TILED_SIZE = 800  # config_1's input: P2-P5 of 200, 100, 50 and 25 cells, none a multiple of K2b's 16-cell tiles


def check_pooler_backward_tiles(torch, m) -> None:
    """K2's backward on the cases its tiles find delicate, against the plain
    gradient within ``pooler_grad_limit``: the 800^2 pyramid, where every
    level ends in partial tiles, on coverage boxes that reach every level;
    the same pyramid with no box on P4, whose gradient must be exactly 0;
    R = 0, every level exactly 0; both read windows, f32 and bf16, C 256
    and 16; and two calls on the same inputs equal bit for bit."""
    gen = torch.Generator().manual_seed(5)
    r, n_img = 256, DET_BATCH
    boxes = coverage_boxes(torch, r, TILED_SIZE, gen).cuda()
    batch_idx = torch.randint(0, n_img, (r,), generator=gen, dtype=torch.int32).cuda()
    levels = m.roi_align.assign_levels(boxes, len(POOLER_STRIDES), int(math.log2(POOLER_STRIDES[0])))
    no_p4 = levels != 2
    hist = torch.bincount(levels, minlength=len(POOLER_STRIDES)).tolist()
    cases = {"all levels": (boxes, batch_idx), "no box on P4": (boxes[no_p4], batch_idx[no_p4]),
             "R = 0": (boxes[:0], batch_idx[:0])}
    log(f"K2b tiling boxes: {r} over {n_img} images at {TILED_SIZE}^2 (levels "
        f"{[TILED_SIZE // s for s in POOLER_STRIDES]} cells a side), per level P2..P5 {hist}; "
        f"{int(no_p4.sum())} without P4's")
    if min(hist) == 0:
        raise RuntimeError("K2b tiling boxes miss a level")
    for impl, dtype, c in itertools.product(m.roi_align.IMPLS, (torch.float32, torch.bfloat16), (256, 16)):
        shapes = [(n_img, TILED_SIZE // s, TILED_SIZE // s, c) for s in POOLER_STRIDES]
        grad_all = torch.randn(r, 7, 7, c, generator=gen).cuda()
        for case, (bx, bi) in cases.items():
            grad_out = grad_all[no_p4] if case == "no box on P4" else grad_all[:bx.shape[0]].contiguous()
            bargs = (grad_out, shapes, dtype, bx, bi, 7, POOLER_STRIDES, 2, POOLER_WINDOW, 224.0, 4, impl)
            got = m.roi_align.roi_align_multilevel_backward(*bargs)
            again = m.roi_align.roi_align_multilevel_backward(*bargs)
            # with no box autograd has no graph to differentiate: the answer is zeros
            want = (m.roi_align.roi_align_multilevel_backward_plain(*bargs) if bx.shape[0] else
                    [torch.zeros(sh, dtype=dtype, device=bx.device) for sh in shapes])
            sync()
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            shaped = all(g.dtype == dtype and tuple(g.shape) == sh for g, sh in zip(got, shapes))
            nonzero = [int(torch.count_nonzero(g)) for g in got]
            if case == "all levels":
                scale = max(w.float().abs().max().item() for w in want)
                limit = pooler_grad_limit(dtype, scale)
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                ok = err <= limit
            else:  # the levels no box reaches: exactly 0 in the kernel's gradient and in the plain one
                empty = [2] if case == "no box on P4" else range(len(shapes))
                ok = all(nonzero[i] == 0 and not torch.count_nonzero(want[i]) for i in empty)
                scale = max((w.float().abs().max().item() for w in want), default=0.0)
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                if scale > 0:
                    ok &= err <= pooler_grad_limit(dtype, scale)
                limit = "0 on the empty levels" + (f", {pooler_grad_limit(dtype, scale):.3g}" if scale > 0 else "")
            log(f"K2b tiling, {case}, {impl} window, {dtype} features, C {c}: max_abs_err {err:.3g} (limit "
                f"{limit if isinstance(limit, str) else f'{limit:.3g}'}); nonzero per level P2..P5 {nonzero}; two "
                f"calls equal bit for bit {same}")
            if not (ok and same and shaped):
                raise RuntimeError(f"K2b on {case} ({impl}, {dtype}, C {c}): error {err}, bit-equal {same}, "
                                   f"dtype and shapes {shaped}, nonzero {nonzero}")


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


NMS_COVERAGE_N = (1, 63, 65, 1024, 1025, 1500, 2000, 2048)


def check_nms_coverage(torch, m) -> None:
    """K4 exact against its plain version at N = 1, 63, 65 and 1024 (edges
    of its 64-bit words and its largest problem with 128 KB of mask in
    shared memory), 1025, 1500, 2000 (the RPN's in training) and 2048 (mask
    in the global workspace), with duplicates, ties, zero-area boxes and an
    all-invalid problem, at IoU thresholds 0, 0.5 and 0.99; a problem of
    2049 boxes must raise."""
    gen = torch.Generator().manual_seed(5)
    for n in NMS_COVERAGE_N:
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
    n = m.nms.MAX_BOXES + 1
    try:
        m.nms.nms_mask_sorted(torch.zeros(1, n, 4, device="cuda"), torch.ones(1, n, dtype=torch.bool, device="cuda"),
                              0.5)
    except ValueError as e:
        log(f"K4 at N {n} on the card raises: {e}")
    else:
        raise RuntimeError(f"K4 at N {n} did not raise")


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
                taps = roi_align.level_taps(boxes[sel], f.shape[1], f.shape[2], stride, p, s, window,
                                            kwargs.get("impl", "pallas"))
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
    return grid_pool_call(torch, pooler_library_maps(torch, roi_align, args, kwargs), kwargs.get("sampling_ratio", 2))


def pooler_library_maps(torch, roi_align, args, kwargs):
    """The (map, grid) pairs of ``pooler_library_call``."""
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
    return calls


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


def block_diagonal(torch, w, groups):
    """Compact grouped HWIO weights (k, k, Cin / g, Cout) -> the dense
    (k, k, Cin, Cout) conv that equals them: zeros off the groups."""
    k, _, cin_g, cout = w.shape
    dense = w.new_zeros(k, k, cin_g * groups, cout)
    cout_g = cout // groups
    for g in range(groups):
        dense[:, :, g * cin_g:(g + 1) * cin_g, g * cout_g:(g + 1) * cout_g] = w[..., g * cout_g:(g + 1) * cout_g]
    return dense


def int_mm_call(torch, a):
    """torch._int_mm on the im2col of a K5a call (K and N padded to the
    multiples of 8 that it needs): the int32 GEMM of the conv, no epilogue;
    a grouped conv's weights dense and block-diagonal, one call for the
    whole conv. A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    x, w, s = a["x"], a["w"], a["stride"]
    if a["groups"] != 1:
        w = block_diagonal(torch, w, a["groups"])
    k = w.shape[0]
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
    """The int8 server quantized from the float models, or (any other form)
    the bf16 one."""
    detector = m.rcnn.GeneralizedRCNN(det_cfg, dtype=torch.bfloat16, device=dev,
                                      generator=torch.Generator().manual_seed(0))
    landmarks = m.hrnet.HRNet(hr_cfg.with_joints(NUM_JOINTS), dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(1))
    lm3d = torch.randn(NUM_JOINTS, 3, generator=torch.Generator().manual_seed(2))
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    if not form.endswith("int8"):
        return m.serving.PoseServer(detector, landmarks, lm3d, K, torch.zeros(5), config,
                                    det_every=DET_EVERY, det_size=det_size), lm3d, K
    t0 = time.perf_counter()
    server = m.serving.build_int8_server(detector, landmarks, lm3d, K, torch.zeros(5), config,
                                         det_every=DET_EVERY, det_size=det_size, **FUSED)
    sync()
    log(f"{form}: int8 quantization of the backbone + HRNet-W32 (calibration on the card, folding on the host): "
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

    reset_counts(m)
    t0 = time.perf_counter()
    outs = [server(frames) for frames in clips[1:]]
    sync()
    seconds = time.perf_counter() - t0
    launches = read_counts(m)
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
    int8 = run.form.endswith("int8")
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
    """torch.profiler over one served clip."""
    profile_call(torch, lambda: run.server(run.frames), run.form)


def profile_call(torch, fn, label: str) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel, the
    kernels launched, and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    table = prof.key_averages()
    log(table.table(sort_by="self_cuda_time_total", row_limit=15))
    # every kernel's own device time: the port's kernels are launched through
    # ctypes, under no torch op, so a sum over host ops would miss them
    kernels = [e for e in table if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile {label}: device busy {busy_us:.0f} us of {wall_us:.0f} us wall (profiler on) = "
        f"{busy_us / wall_us:.4f}; {sum(e.count for e in kernels)} kernel launches")


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
    rows = [crop_row(torch, m, dev, captures["K1"].calls[0], "crop_bilinear")]
    rows.append(pooler_row(torch, m, captures["K2"].calls[0], "roi_align_multilevel"))
    return rows + nms_rows(torch, m, dev, captures["K4"].calls[:2], "")


def crop_row(torch, m, dev, call, name):
    """K1's row on one captured call, held to its plain version within 1e-3 grey."""
    crop_args, _ = call
    frames, params, out_size = crop_args
    frames_f = frames.permute(0, 3, 1, 2).float()
    h, w = frames.shape[1:3]
    xs = params[:, 0:1] * torch.arange(out_size[0], device=dev) + params[:, 1:2]
    ys = params[:, 2:3] * torch.arange(out_size[1], device=dev) + params[:, 3:4]
    grid = torch.stack([((2 * xs + 1) / w - 1)[:, None, :].expand(-1, out_size[1], -1),
                        ((2 * ys + 1) / h - 1)[:, :, None].expand(-1, -1, out_size[0])], dim=-1)
    return dict(id="K1", name=name, source="spacecraft_pose_estimation_tpu_torch/csrc/crop_bilinear.cu",
                replaces="spacecraft_pose_estimation_tpu/ops/pallas_crop.py:191",
                run_k=lambda: m.warp.crop_bilinear(*crop_args),
                run_p=lambda: m.warp.crop_bilinear_plain(*crop_args),
                run_lib=lambda: torch.nn.functional.grid_sample(frames_f, grid, mode="bilinear",
                                                                padding_mode="zeros", align_corners=False),
                tol=1e-3, peak=FP32_FLOPS, numbers=crop_numbers(torch, crop_args))


def pooler_row(torch, m, call, name):
    """K2's row on one captured call."""
    pool_args, pool_kwargs = call
    *pool_totals, tap_bytes = pooler_numbers(torch, m.roi_align, pool_args, pool_kwargs)
    return dict(id="K2", name=name, source="spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel.cu",
                replaces="spacecraft_pose_estimation_tpu/ops/pallas_pooler.py:135",
                run_k=lambda: m.roi_align.roi_align_multilevel(*pool_args, **pool_kwargs),
                run_p=lambda: m.roi_align.roi_align_multilevel_plain(*pool_args, **pool_kwargs),
                run_lib=pooler_library_call(torch, m.roi_align, pool_args, pool_kwargs), tol=None,
                peak=FP32_FLOPS, numbers=tuple(pool_totals), extra={"tap_load_bytes": tap_bytes})


def nms_rows(torch, m, dev, calls, label):
    """K4's rows on a detector call's two captured calls: the RPN's, then the box head's."""
    try:
        import torchvision.ops as tv_ops  # a yardstick only: the port never calls it
    except ImportError:
        tv_ops = None
    rows = []
    for i, (nms_args, _) in enumerate(calls):
        boxes, valid, thresh = nms_args
        p, n = valid.shape
        kept = float(m.nms.nms_mask_sorted_plain(boxes, valid, thresh).sum())
        lib = None
        if tv_ops is not None:
            idxs = torch.arange(p, device=dev)[:, None].expand(p, n)[valid]
            order = torch.arange(n, 0, -1, device=dev, dtype=torch.float32)[None].expand(p, n)[valid]
            lib = (lambda b=boxes[valid], s=order, i=idxs, th=thresh: tv_ops.batched_nms(b, s, i, th))
        rows.append(dict(id="K4", name=f"nms_mask_sorted ({label}{'rpn' if i == 0 else 'box head'} {p}x{n})",
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


def x101_conv_rows(torch, m, run):
    """K5a's rows on every site of the int8 X101 backbone in one served
    keyframe batch, captured anew on the clip's letterbox: the grouped 3x3
    (conv2) sites, the kernel on its merged copy and the plain version on
    the compact weights at ``groups=32``; and the dense sites (conv1 at the
    resolution stride-in-3x3 leaves it, conv3, the shortcuts) at X101
    widths. ``torch._int_mm`` on each site's im2col (a grouped site's
    weights dense and block-diagonal) is the yardstick. The bound counts
    the compact work (the merge's zeros are not work)."""
    server = run.server
    with torch.inference_mode(), Capture(m.int8_conv, "int8_conv") as cap:
        lb, _ = m.serving.letterbox(run.frames[:: server.det_every], server.det_size)
        m.backbone_int8.backbone_int8_apply(server.detector.config.backbone, server.backbone_q,
                                            server.detector.normalize(lb))
        sync()
    calls = [cap.bound(i) for i in range(len(cap.calls))]
    grouped = [a for a in calls if a["groups"] > 1]
    dense = [a for a in calls if a["groups"] == 1]
    merged = sorted({(m.int8_conv.kernel_groups(a["x"].shape[-1], a["wk"].shape), a["groups"]) for a in grouped})
    log(f"K5a X101 backbone sites: {len(grouped)} grouped and {len(dense)} dense a keyframe batch of "
        f"{calls[0]['x'].shape[0]}; grouped (kernel groups, compact groups) {merged}; activation bytes read: "
        f"grouped {sum(a['x'].numel() for a in grouped)}, dense {sum(a['x'].numel() for a in dense)}")
    if len(grouped) != 33 or not dense:
        raise RuntimeError(f"x101 int8 backbone: {len(grouped)} grouped and {len(dense)} dense K5a sites")
    return [conv_sites_row(torch, m, grouped, "K5a grouped", f"X101 grouped conv2 sites: {len(grouped)} a "
                           "keyframe batch, groups merged to whole 32-channel tiles"),
            conv_sites_row(torch, m, dense, "K5a dense", f"X101 dense sites: conv1, conv3 and shortcuts, "
                           f"{len(dense)} a keyframe batch")]


def conv_sites_row(torch, m, calls, count, label):
    """A K5a row on ``calls``, its launches read from counter ``count``."""
    kernel, plain = m.int8_conv.int8_conv, m.int8_conv.int8_conv_plain
    run_k = [lambda a=a: kernel(**a) for a in calls]
    run_p = [lambda a={k: v for k, v in a.items() if k != "wk"}: plain(**a) for a in calls]
    libs = [int_mm_call(torch, a) for a in calls]
    totals = [conv_numbers(m, a) for a in calls]
    return dict(id="K5a", count=count, name=f"int8_conv ({label})",
                source="spacecraft_pose_estimation_tpu_torch/csrc/int8_conv_requant.cu",
                replaces="spacecraft_pose_estimation_tpu/models/backbone_int8.py:158",
                run_k=lambda: [f() for f in run_k], run_p=lambda: [f() for f in run_p],
                run_lib=(lambda: [f() for f in libs]) if all(libs) else None, tol="int8", peak=INT8_OPS,
                numbers=(sum(b for b, _ in totals), sum(o for _, o in totals)), calls=len(calls))


def workspace_bytes(m, calls) -> int:
    """K6's global workspace over ``calls`` (the bands of every strip)."""
    total = 0
    for a in calls:
        bsz, h, w, _ = a["x"].shape
        total += m.int8_blocks.bottleneck_workspace_bytes(bsz, h, w, a["w2"].shape[-1], a["w3"].shape[-1],
                                                          a["nblocks"], a["strip"])
    return total


EVAL_FRAMES, EVAL_BATCH, EVAL_SIZE = 24, 8, 768
EVAL_DIST = (-0.22, 0.18, 5e-4, -3e-4, -0.02)


class TimedFrames:
    """A scene's frames on the card, handed out one batch at a time; notes
    the host clock (after a synchronize) when each batch is asked for."""

    def __init__(self, frames):
        self.frames, self.asked = frames, {}

    def __len__(self) -> int:
        return self.frames.shape[0]

    def __getitem__(self, index: slice):
        sync()
        self.asked[index.start] = time.perf_counter()
        return self.frames[index]


def conv_flops(torch, m, modules, run) -> float:
    """Multiply-adds x 2 of every port Conv inside ``modules`` during ``run()``."""
    total = [0.0]

    def hook(mod, inputs, out):
        k = mod.weight.shape[-1]
        total[0] += 2.0 * out.numel() * mod.weight.shape[1] * k * k

    handles = [c.register_forward_hook(hook) for mod in modules for c in mod.modules() if isinstance(c, m.layers.Conv)]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def check_artifacts(torch, out_dir, n_frames) -> None:
    """pred.mat (n, 11, 3) finite; real_test.json n images and annotations;
    opencv_poses.json n finite poses, R orthonormal within 1e-4."""
    import os

    import numpy as np
    import scipy.io

    preds = scipy.io.loadmat(os.path.join(out_dir, "pred.mat"))["preds"]
    with open(os.path.join(out_dir, "real_test.json")) as f:
        coco = json.load(f)
    with open(os.path.join(out_dir, "opencv_poses.json")) as f:
        poses = json.load(f)
    Rs = np.array([p["rotation_matrix"] for p in poses])
    Ts = np.array([p["T"] for p in poses])
    ortho = np.abs(Rs @ Rs.transpose(0, 2, 1) - np.eye(3)).max() if len(poses) else np.inf
    log(f"evaluate artifacts: pred.mat {preds.shape} finite {bool(np.isfinite(preds).all())}; real_test.json "
        f"{len(coco['images'])} images, {len(coco['annotations'])} annotations; opencv_poses.json {len(poses)} poses, "
        f"finite {bool(np.isfinite(Rs).all() and np.isfinite(Ts).all())}, max |R R^T - I| {ortho:.3g} (limit 1e-4)")
    ok = (preds.shape == (n_frames, NUM_JOINTS, 3) and np.isfinite(preds).all()
          and len(coco["images"]) == len(coco["annotations"]) == n_frames and len(poses) == n_frames
          and Rs.shape == (n_frames, 3, 3) and Ts.shape == (n_frames, 3, 1)
          and np.isfinite(Rs).all() and np.isfinite(Ts).all() and ortho <= 1e-4)
    if not ok:
        raise RuntimeError("the evaluation entry's artifacts are wrong (see the line above)")


def evaluate_phase(torch, m, dev, r101):
    """The fused evaluation entry (``evaluate.run_scene``) at full width:
    X101-32x8d FPN (``FASTER_RCNN_X101_SPACECRAFT``) in bf16 at a 768
    letterbox, HRNet-W32 with 11 joints at 512, RANSAC PnP with 256
    hypotheses, on 24 seeded uint8 1920x1200 BGR frames in batches of 8
    (one warm-up, two timed), a pinhole camera with distortion. Checks the
    artifacts and that K1, K2 and K4 launched (counters reset just before,
    read just after); times the stages of one batch. Returns the K1, K2 and
    K4 rows on this phase's inputs and its launch counts."""
    import tempfile

    import numpy as np

    det = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, dtype=torch.bfloat16, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    hr = m.models.build_landmark_model("pose_hrnet", NUM_JOINTS, device=dev, dtype=torch.bfloat16,
                                       generator=torch.Generator().manual_seed(1))
    lm3d = np.random.default_rng(2).normal(0, 0.8, (NUM_JOINTS, 3))
    cam = m.camera.CameraModel(K=np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]]),
                               dist=np.array(EVAL_DIST), width=FRAME_HW[1], height=FRAME_HW[0])
    config = m.pipeline.PipelineConfig(image_size=(512, 512), solver="ransac")
    gd = torch.Generator(device=dev).manual_seed(3)
    frames = TimedFrames(torch.randint(0, 256, (EVAL_FRAMES, *FRAME_HW, 3), dtype=torch.uint8, device=dev,
                                       generator=gd))
    names = [f"img{i:06d}.png" for i in range(EVAL_FRAMES)]
    captures = {key: Capture(*m.kernels[key][:2]) for key in ("K1", "K2", "K4")}
    with tempfile.TemporaryDirectory() as out_dir, contextlib.ExitStack() as stack:
        for c in captures.values():
            stack.enter_context(c)
        reset_counts(m)
        t0 = time.perf_counter()
        res = m.evaluate.run_scene(frames, names, out_dir, det, hr, lm3d, cam, batch_size=EVAL_BATCH,
                                   input_size=EVAL_SIZE, config=config,
                                   generator=torch.Generator(device=dev).manual_seed(4))
        t_end = time.perf_counter()
        launches = read_counts(m)
        check_artifacts(torch, out_dir, EVAL_FRAMES)
    timed = EVAL_FRAMES - EVAL_BATCH
    log(f"evaluate (X101-32x8d bf16 at {EVAL_SIZE}, HRNet-W32 at 512, RANSAC 256): {EVAL_FRAMES} frames of "
        f"{FRAME_HW[1]}x{FRAME_HW[0]} in batches of {EVAL_BATCH}, {t_end - t0:.4f} s in all (warm-up batch "
        f"included); the {timed} frames after the warm-up batch, artifact writes included, in "
        f"{t_end - frames.asked[EVAL_BATCH]:.4f} s = {timed / (t_end - frames.asked[EVAL_BATCH]):.2f} frames/s; "
        f"launches {json.dumps(launches)}; first t {res['t'][0].tolist()}, first box {res['boxes'][0].tolist()}")
    for key in ("K1", "K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by the evaluation entry")
    k4 = captures["K4"].calls
    for name, calls in (("rpn", k4[0::2]), ("box head", k4[1::2])):
        valid = sum(int(c[0][1].sum()) for c in calls)
        total = sum(c[0][1].numel() for c in calls)
        log(f"evaluate K4 {name} problems: {tuple(calls[0][0][1].shape)} a batch, {valid} valid boxes of {total} "
            f"over {len(calls)} batches = {valid / total:.4f}")
    feats, boxes, _, _, strides = captures["K2"].calls[-1][0][:5]
    levels = m.roi_align.assign_levels(boxes, len(feats), int(math.log2(strides[0])))
    log(f"evaluate: K2's ROIs per pyramid level P2..P5 in the last batch: "
        f"{torch.bincount(levels, minlength=len(feats)).tolist()} of {boxes.shape[0]}")
    evaluate_stage_times(torch, m, det, hr, frames.frames[:EVAL_BATCH], config, lm3d, cam, r101)
    crop_params = captures["K1"].calls[-1][0][1]
    log(f"evaluate: K1's last batch, {crop_params.shape[0]} crops; crop origins (x0, y0) "
        f"{crop_params[:, [1, 3]].tolist()} in a {FRAME_HW[1]}x{FRAME_HW[0]} frame, steps "
        f"{crop_params[:, [0, 2]].tolist()}")
    rows = [crop_row(torch, m, dev, captures["K1"].calls[-1],
                     f"crop_bilinear (evaluate: full frame, no window clamp, batch {EVAL_BATCH})")]
    rows.append(pooler_row(torch, m, captures["K2"].calls[-1],
                           f"roi_align_multilevel (evaluate: X101, batch {EVAL_BATCH}, {boxes.shape[0]} ROIs)"))
    rows += nms_rows(torch, m, dev, k4[-2:], "evaluate: X101 ")
    scene = SimpleNamespace(det=det, hr=hr, lm3d=lm3d, cam=cam, frames=frames.frames, names=names, res=res,
                            fused_fps=timed / (t_end - frames.asked[EVAL_BATCH]),
                            k1_params=captures["K1"].calls[-1][0][1])
    return rows, launches, scene


def staged_phase(torch, m, dev, scene) -> None:
    """The staged evaluation's three stage functions in process, on the
    evaluate phase's frames (on the card: its machine has no cv2) and
    weights, their artifacts through a temporary directory as the file
    contract has them: ``export_boxes`` (real_test.json), ``test_landmarks``
    (pred.mat; the events preset, flip test off, batch 8) and
    ``export_poses`` (RANSAC, 512 hypotheses, opencv_poses.json). Boxes and
    keypoints equal the fused entry's within 1e-3 px; every pose finite;
    K1, K2 and K4 launched (counters reset just before, read just after);
    the flip test once on one batch."""
    import os
    import tempfile

    import numpy as np

    n = len(scene.names)
    cfg = m.config.apply_overrides(m.config.get_preset("events"),
                                   ["MODEL.IMAGE_SIZE", "[512, 512]", "TEST.BATCH_SIZE_PER_CHIP", str(EVAL_BATCH)])
    k1 = Capture(*m.kernels["K1"][:2])
    with tempfile.TemporaryDirectory() as out_dir, k1:
        reset_counts(m)
        sync()
        t0 = time.perf_counter()
        boxes, _ = m.export_boxes.export_boxes(scene.frames, scene.names, scene.det, out_dir, NUM_JOINTS,
                                               EVAL_SIZE, EVAL_BATCH)
        sync()
        t1 = time.perf_counter()
        json_path = os.path.join(out_dir, "real_test.json")
        frames = {name: scene.frames[i] for i, name in enumerate(scene.names)}
        examples = m.landmark_dataset.LandmarkExamples(json_path, frames=frames)
        m.test_landmarks.predict_landmarks([scene.hr], examples, cfg, os.path.join(out_dir, "pred.mat"))
        sync()
        t2 = time.perf_counter()
        preds = m.coco_io.load_pred_mat(os.path.join(out_dir, "pred.mat"))
        _, Rs, _ = m.export_poses.export_poses(preds, m.coco_io.load_coco(json_path), scene.lm3d, scene.cam,
                                               out_dir, solver="ransac", hypotheses=512, device=dev,
                                               generator=torch.Generator(device=dev).manual_seed(4))
        sync()
        t3 = time.perf_counter()
        launches = read_counts(m)
        check_artifacts(torch, out_dir, n)
    box_err = float(np.abs(boxes - scene.res["boxes"]).max())
    kp_err = float(np.abs(preds[..., :2] - scene.res["preds"][..., :2]).max())
    conf_err = float(np.abs(preds[..., 2] - scene.res["preds"][..., 2]).max())
    same_crops = torch.equal(k1.calls[-1][0][1], scene.k1_params)
    batches = -(-n // EVAL_BATCH)
    log(f"staged (in process, frames on the card): detector stage {(t1 - t0) * 1e3 / batches:.4f} ms a batch of "
        f"{EVAL_BATCH}, landmark stage {(t2 - t1) * 1e3 / batches:.4f} ms a batch, PnP stage (RANSAC 512) "
        f"{(t3 - t2) * 1e3:.4f} ms for {n} frames; {n} frames in {t3 - t0:.4f} s = {n / (t3 - t0):.2f} frames/s "
        f"(artifact writes included; the fused entry in this call: {scene.fused_fps:.2f} frames/s); "
        f"launches {json.dumps(launches)}")
    log(f"staged vs fused: boxes max_abs_err {box_err:.3g} px, keypoints {kp_err:.3g} px (limits 1e-3), "
        f"confidences {conf_err:.3g} (limit 1e-5); last K1 crop parameters equal the fused entry's: {same_crops}; "
        f"poses finite {bool(np.isfinite(Rs).all())}")
    if not (box_err <= 1e-3 and kp_err <= 1e-3 and conf_err <= 1e-5):
        raise RuntimeError(f"staged evaluation differs from the fused entry: boxes {box_err}, keypoints {kp_err}, "
                           f"confidences {conf_err}")
    for key in ("K1", "K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by the staged evaluation")
    # the flip test on one batch
    examples.records = examples.records[:EVAL_BATCH]
    m.warp.KERNEL.launches = 0
    flipped = m.landmark_loop.validate(scene.hr, examples, EVAL_BATCH, (512, 512), flip_test=True)
    sync()
    k1_launches = m.warp.KERNEL.launches
    moved = float(np.abs(flipped[..., :2] - preds[:EVAL_BATCH, :, :2]).max())
    ref = flip_reference(torch, m, scene.hr, examples, (512, 512))
    flip_err = float(np.abs(flipped[..., :2] - ref.keypoints).max())
    flip_conf_err = float(np.abs(flipped[..., 2] - ref.confidence).max())
    log(f"flip test on one batch of {EVAL_BATCH}: K1 launches {k1_launches}, keypoints finite "
        f"{bool(np.isfinite(flipped).all())}, moved up to {moved:.4g} px from the unflipped ones; against "
        f"(hm + shift(flip(model(flip(x))))) / 2 in plain ops: keypoints {flip_err:.3g} px (limit 1e-3), "
        f"confidences {flip_conf_err:.3g} (limit 1e-5), the validate step's heatmaps {ref.hm_err:.3g} of peak "
        f"{ref.peak:.3g} (limit 1e-5 of it); the wrong flips' heatmaps are off by "
        + json.dumps({k: round(v, 6) for k, v in ref.wrong.items()}))
    if k1_launches == 0 or not np.isfinite(flipped).all() or not (
            flip_err <= 1e-3 and flip_conf_err <= 1e-5 and ref.hm_err <= 1e-5 * ref.peak):
        raise RuntimeError(f"flip test: {k1_launches} K1 launches, finite {bool(np.isfinite(flipped).all())}, "
                           f"keypoints {flip_err} px, confidences {flip_conf_err} and heatmaps {ref.hm_err} off the "
                           "plain construction")
    if not min(ref.wrong.values()) > 1e-5 * ref.peak:
        raise RuntimeError(f"flip test: a wrong flip's heatmaps lie within the limit of the right one's: {ref.wrong}")


def flip_reference(torch, m, model, examples, image_size):
    """The flip test of ``examples`` built from plain ops on the card: the
    same crops (K1), then (hm + hm_f) / 2 with hm_f the model's heatmaps of
    the width-flipped crops flipped back and shifted right one pixel, column
    0 repeated (a gather, not the validate step's concatenation). Returns
    its keypoints (N, J, 2) and confidences (N, J), the largest difference
    of ``make_validate_step``'s flip-test heatmaps on the same crops from
    it, its peak, and how far three wrong flip tests' heatmaps lie from it
    (a roll for the shift, no un-flip, the height flipped), for the log."""
    import numpy as np

    dev = next(model.parameters()).device
    exs = [examples.example(i) for i in range(len(examples))]
    images = torch.stack([torch.as_tensor(e["image"]).to(dev) for e in exs])
    bboxes = torch.from_numpy(np.stack([e["bbox"] for e in exs])).to(dev)
    centers, scales = m.geometry.bbox_to_center_scale(bboxes)
    with torch.inference_mode():
        x = m.pipeline.normalize_crops(m.warp.crop_and_resize(images, centers, scales, image_size))
        hm = model(x)
        back = model(x.flip(2)).flip(2)
        shift = (torch.arange(back.shape[2], device=dev) - 1).clamp_min(0)
        want = (hm + back[:, :, shift]) / 2
        kp, conf = m.heatmap.decode_heatmaps(want, centers, scales)
        _, _, got = m.landmark_loop.make_validate_step(model, flip_test=True)(x, centers, scales)
        wrong = {"roll": back.roll(1, dims=2), "no un-flip": model(x.flip(2)),
                 "height flipped": model(x.flip(1)).flip(1)[:, :, shift]}
        wrong = {name: ((hm + v) / 2 - want).abs().max().item() for name, v in wrong.items()}
        return SimpleNamespace(keypoints=kp.float().cpu().numpy(), confidence=conf.float().cpu().numpy(),
                               hm_err=(got - want).abs().max().item(), peak=want.abs().max().item(), wrong=wrong)


def evaluate_stage_times(torch, m, det, hr, frames, config, lm3d, cam, r101) -> None:
    """Device time (CUDA events, ms) of each stage of one evaluate batch,
    GN PnP beside RANSAC, and the X101 backbone+FPN's FLOP rate beside
    R101's from the bf16 serving run."""
    dev = frames.device
    lm3d_t, K, dist = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (lm3d, cam.K, cam.dist))
    gumbel = m.pnp.gumbel_noise((frames.shape[0], config.ransac_hypotheses, NUM_JOINTS),
                                torch.Generator(device=dev).manual_seed(5), dev)
    with torch.inference_mode():
        lb, scale = m.serving.letterbox_linear(frames, EVAL_SIZE)
        best = m.rcnn.select_best_box(det(lb), (EVAL_SIZE, EVAL_SIZE)) / scale
        xywh = torch.cat([best[:, :2], best[:, 2:] - best[:, :2]], 1)
        rgb = frames.flip(-1)
        land = m.pipeline.make_landmark_stage(hr, config)(rgb, xywh)
        centers, scales = land["centers"], land["scales"]
        crops = m.warp.crop_and_resize(rgb, centers, scales, config.image_size)
        w = m.pnp.adaptive_confidence_mask(land["confidence"], min_count=config.min_keypoints).float()
        stages = {
            "letterbox (cv2-style bilinear, BGR)": lambda: m.serving.letterbox_linear(frames, EVAL_SIZE),
            "detector: X101 backbone+fpn": lambda: det.pyramid(lb),
            "detector: all": lambda: det(lb),
            "crop (K1, RGB)": lambda: m.warp.crop_and_resize(rgb, centers, scales, config.image_size),
            "normalize+hrnet": lambda: hr(m.pipeline.normalize_crops(crops)),
            "decode": lambda: m.heatmap.decode_heatmaps(land["heatmaps"], centers, scales),
            "pnp ransac (256 hypotheses, 10 GN steps)": lambda: m.pnp.pnp_ransac(
                lm3d_t, land["keypoints"], K, dist, land["confidence"], gumbel=gumbel,
                num_hypotheses=config.ransac_hypotheses, reproj_threshold=config.reproj_threshold,
                refine_iters=config.refine_iters, min_count=config.min_keypoints),
            "pnp gn (epnp + 10 GN steps), for comparison": lambda: m.pnp.solve_pnp(
                lm3d_t, land["keypoints"], K, dist, w, config.refine_iters),
        }
        times = {name: time_ms(fn, 3) for name, fn in stages.items()}
    times["detector: rest (all - backbone+fpn)"] = times["detector: all"] - times["detector: X101 backbone+fpn"]
    log(f"stage device ms per evaluate batch of {frames.shape[0]}: "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))
    x101_flops = conv_flops(torch, m, [det.backbone, det.fpn], lambda: det.pyramid(lb[:1]))
    x101_rate = x101_flops * frames.shape[0] / (times["detector: X101 backbone+fpn"] * 1e-3)
    r101_rate = r101["flops_per_image"] * r101["images"] / (r101["ms"] * 1e-3)
    log(f"backbone+fpn at {EVAL_SIZE}: X101-32x8d {x101_flops / 1e9:.2f} GFLOP an image, "
        f"{times['detector: X101 backbone+fpn'] / frames.shape[0]:.4f} ms an image = {x101_rate / 1e12:.2f} TFLOP/s; "
        f"R101 (bf16 serving run) {r101['flops_per_image'] / 1e9:.2f} GFLOP an image, "
        f"{r101['ms'] / r101['images']:.4f} ms an image = {r101_rate / 1e12:.2f} TFLOP/s; "
        f"X101 takes {r101_rate / x101_rate:.2f}x R101's time per FLOP")


TRAIN_HW = (720, 1280)  # the events dataset's frames
TRAIN_FRAMES, TRAIN_VAL_FRAMES, TRAIN_REPEATS = 96, 16, 30


class Timed:
    """Time every call to ``module.name`` on the card (synchronized before
    and after) while active; ``factory``: ``name`` makes the function to
    time (the trainer's ``make_train_step``). ``keep`` keeps the results."""

    def __init__(self, module, name: str, factory: bool = False, keep: bool = False):
        self.module, self.name, self.factory, self.keep = module, name, factory, keep
        self.orig, self.ms, self.results = getattr(module, name), [], []

    def _timed(self, fn):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if self.keep:
                self.results.append(out)
            return out

        return call

    def __enter__(self):
        patched = (lambda *a, **k: self._timed(self.orig(*a, **k))) if self.factory else self._timed(self.orig)
        setattr(self.module, self.name, patched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def landmark_scene(torch, m, dev, n: int, seed: int, out_dir: str, split: str, hw=None):
    """``n`` seeded uint8 BGR frames of ``hw`` (default 1280x720) on the
    card (dim noise, the 11 landmarks of a random body drawn as 7x7 white
    squares at their projections under seeded poses) and their COCO json ->
    ``LandmarkExamples`` over the frames in memory."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    lm3d = rng.normal(0, 0.5, (NUM_JOINTS, 3))
    h, w = hw or TRAIN_HW
    f = 1100.0 * w / 1280
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    frames = torch.randint(0, 48, (n, h, w, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    images, anns = [], []
    for i in range(n):
        q = np.concatenate([[1.0], rng.normal(0, 0.3, 3)])
        R = m.geometry.quat_to_dcm(torch.tensor(q / np.linalg.norm(q), dtype=torch.float32)).double().numpy()
        t = np.array([rng.normal(0, 0.3), rng.normal(0, 0.2), rng.uniform(6.0, 10.0)])
        uv = m.coco_io.project_landmarks(lm3d, R, t, K)
        for x, y in np.rint(uv).astype(int):
            frames[i, max(y - 3, 0):max(y + 4, 0), max(x - 3, 0):max(x + 4, 0)] = 255
        lo, hi = uv.min(0) - 20, uv.max(0) + 20
        images.append(m.coco_io.image_record(f"{split}{i:04d}.png", w, h, i))
        kps = np.concatenate([uv, np.full((NUM_JOINTS, 1), 2.0)], 1)
        anns.append(m.coco_io.keypoint_annotation(kps, [lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]], i, i))
    path = os.path.join(out_dir, f"{split}.json")
    m.coco_io.save_coco(m.coco_io.build_coco_dict(images, anns, NUM_JOINTS), path)
    return m.landmark_dataset.LandmarkExamples(path, frames={im["file_name"]: frames[i]
                                                             for i, im in enumerate(images)})


def check_train_tiny_against_cpu(torch, m) -> None:
    """``HRNET_TINY`` in float32 (TF32 off) on the card against the CPU:
    the training transform from the same draws (crops within 1e-3 grey,
    targets 1e-6, weights equal; boxes inside the frames, the frame's edge
    being held on the CPU by the tests), then 3 Adam updates on the same
    batch from the same weights (losses and grad norms 1e-4 relative, BN
    statistics 1e-5, parameters within 1 lr and at most 1% of them beyond
    1e-3 lr: Adam moves an entry whose gradient is near its eps by up to lr
    on a rounding)."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(5)
    b, lr = 4, 1e-3
    x = torch.nn.functional.avg_pool2d(torch.rand(b, 3, 96, 128, generator=torch.Generator().manual_seed(5)) * 255,
                                       7, 1, 3, count_include_pad=False)
    frames = ((x - x.mean()) / x.std() * 50 + 128).clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    bboxes = torch.from_numpy(np.concatenate([rng.uniform(50, 60, (b, 2)), rng.uniform(14, 20, (b, 2))], 1)
                              .astype(np.float32))
    joints = bboxes[:, None, :2] + torch.from_numpy(rng.uniform(0, 1, (b, NUM_JOINTS, 2)).astype(np.float32)) \
        * bboxes[:, None, 2:]
    vis = torch.ones(b, NUM_JOINTS)
    draws = m.landmark_dataset.sample_draws(torch.Generator().manual_seed(6), b, 0.25, 30.0, half_body=False)
    kw = dict(image_size=(64, 64), heatmap_size=(16, 16), sigma=2.0, draws=draws)
    cpu = m.landmark_dataset.device_transform(frames, bboxes, joints, vis, **kw)
    gpu = m.landmark_dataset.device_transform(frames.cuda(), bboxes.cuda(), joints.cuda(), vis.cuda(), **kw)
    std = torch.tensor(m.pipeline.IMAGENET_STD) * 255.0
    crop_err = ((gpu["image"].cpu() - cpu["image"]) * std).abs().max().item()
    tgt_err = (gpu["target"].cpu() - cpu["target"]).abs().max().item()
    tw_same = torch.equal(gpu["target_weight"].cpu(), cpu["target_weight"])
    log(f"tiny train transform, card vs CPU: crops max_abs_err {crop_err:.3g} grey (limit 1e-3), targets "
        f"{tgt_err:.3g} (limit 1e-6), target weights equal {tw_same}; rotations {draws['rots'].tolist()}")
    if not (crop_err <= 1e-3 and tgt_err <= 1e-6 and tw_same):
        raise RuntimeError(f"tiny train transform: crops {crop_err}, targets {tgt_err}, weights equal {tw_same}")
    cfg = dataclasses.replace(m.hrnet.HRNET_TINY, num_joints=NUM_JOINTS)
    states = {}
    for device in ("cpu", "cuda"):
        model = m.hrnet.HRNet(cfg, device=device, generator=torch.Generator().manual_seed(1))
        opt = m.optim.build_optimizer("adam", model.parameters(), m.optim.multistep_schedule(lr, [2]),
                                      weight_decay=1e-4)
        states[device] = (m.train_state.TrainState(model, opt), [])
    step = m.train_state.make_train_step(True)
    for _ in range(3):
        for device, (state, mets) in states.items():
            batch = {k: cpu[k].to(device) for k in ("image", "target", "target_weight")}
            mets.append({k: v.item() for k, v in step(state, batch).items()})
    (sc, mc), (sg, mg) = states["cpu"], states["cuda"]
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(mc, mg))
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(a["grad_norm"]) for a, b in zip(mc, mg))
    sd_c, sd_g = sc.model.state_dict(), sg.model.state_dict()
    stats_err = max((sd_g[k].cpu() - v).abs().max().item() for k, v in sd_c.items() if k.endswith((".mean", ".var")))
    dp = torch.cat([((sd_g[k].cpu() - v).abs() / lr).flatten() for k, v in sd_c.items()
                    if not k.endswith((".mean", ".var"))])
    share = (dp > 1e-3).float().mean().item()
    log(f"tiny train steps, card vs CPU (3 Adam updates, f32): losses {[round(a['loss'], 6) for a in mg]}, "
        f"relative err {loss_err:.3g} (limit 1e-4), grad norms {gn_err:.3g} (limit 1e-4), BN statistics "
        f"{stats_err:.3g} (limit 1e-5), parameters max {dp.max().item():.3g} lr (limit 1), share beyond 1e-3 lr "
        f"{share:.3g} (limit 0.01) of {dp.numel()}")
    if not (loss_err <= 1e-4 and gn_err <= 1e-4 and stats_err <= 1e-5 and dp.max().item() <= 1.0 and share <= 0.01):
        raise RuntimeError(f"tiny train steps differ between the card and the CPU: loss {loss_err}, grad norm "
                           f"{gn_err}, BN statistics {stats_err}, parameters {dp.max().item()} lr, share {share}")


def train_phase(torch, m, dev, card):
    """``tools.train_landmarks.train`` at the events preset's full width on
    the card; returns K1's row on the last validation batch and the phase's
    launch counts."""
    import os
    import tempfile

    check_train_tiny_against_cpu(torch, m)
    cfg = m.config.apply_overrides(m.config.get_preset("events"), ["TRAIN.END_EPOCH", "2"])
    log(f"train_landmarks config: {cfg.model.name} {cfg.model.image_size} -> {cfg.model.heatmap_size}, batch "
        f"{cfg.train.batch_size_per_chip}, {cfg.model.compute_dtype}, {cfg.train.optimizer} lr {cfg.train.lr}, "
        f"lr_step {cfg.train.lr_step}, {TRAIN_FRAMES} frames of {TRAIN_HW[1]}x{TRAIN_HW[0]}, validation "
        f"{TRAIN_VAL_FRAMES} frames in batches of {cfg.test.batch_size_per_chip}")
    with tempfile.TemporaryDirectory() as out_dir:
        train_ex = landmark_scene(torch, m, dev, TRAIN_FRAMES, 11, out_dir, "train")
        val_ex = landmark_scene(torch, m, dev, TRAIN_VAL_FRAMES, 12, out_dir, "val")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps = Timed(m.train_landmarks, "make_train_step", factory=True, keep=True)
        transform = Timed(m.landmark_loop, "device_transform")
        validate = Timed(m.landmark_loop, "validate")
        epochs = Timed(m.landmark_loop, "train_epoch")
        k1 = Capture(*m.kernels["K1"][:2])
        with steps, transform, validate, epochs, k1:
            reset_counts(m)
            t0 = time.perf_counter()
            state = m.train_landmarks.train(cfg, train_ex, out_dir, dev, val_ex)
            sync()
            wall = time.perf_counter() - t0
            launches = read_counts(m)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [met["loss"].item() for met in steps.results]
        finite = all(math.isfinite(v) for v in losses) and all(
            bool(torch.isfinite(v).all()) for v in state.model.state_dict().values())
        per_epoch = len(steps.ms) // 2
        step_ms = median(steps.ms[per_epoch:])  # after one warm-up epoch
        batch = cfg.train.batch_size_per_chip
        log(f"train_landmarks ({cfg.model.name} {cfg.model.image_size} -> {cfg.model.heatmap_size}, batch {batch}, "
            f"{cfg.model.compute_dtype} over float32, {TRAIN_FRAMES} frames, "
            f"2 epochs of {per_epoch} steps, validation of {TRAIN_VAL_FRAMES} after each) on {card}: {wall:.4f} s in "
            f"all; train step {step_ms:.4f} ms (median of the {len(steps.ms) - per_epoch} steps after the warm-up "
            f"epoch; all {[round(v, 4) for v in steps.ms]}) = {batch / step_ms * 1e3:.2f} images/s; transform "
            f"{median(transform.ms):.4f} ms a batch (all {[round(v, 4) for v in transform.ms]}); epochs "
            f"{[round(v, 4) for v in epochs.ms]} ms; validate {[round(v, 4) for v in validate.ms]} ms; peak memory "
            f"{peak_gb:.4f} GB (torch.cuda.max_memory_allocated); losses {[round(v, 5) for v in losses]}; launches "
            f"{json.dumps(launches)}")
        if not finite:
            raise RuntimeError(f"train_landmarks: a loss or a parameter is not finite: losses {losses}")
        if launches["K1"] == 0:
            raise RuntimeError("kernel K1 was not launched by the trainer's validation")
        # the final checkpoint's .npz through the evaluation loader: the same heatmaps
        npz = os.path.join(out_dir, "checkpoints", str(state.step), "model.npz")
        loaded = m.evaluate.load_landmark_model(npz, cfg.model.name, NUM_JOINTS, torch.bfloat16, dev)
        frames, bboxes, _, _ = m.landmark_dataset.DeviceDatasetCache(val_ex, dev).gather(range(TRAIN_VAL_FRAMES))
        centers, scales = m.geometry.bbox_to_center_scale(bboxes)
        crops = m.pipeline.normalize_crops(m.warp.crop_bilinear_plain(
            frames, m.warp.crop_params(centers, scales, (512, 512)), (512, 512)))
        state.model.eval()
        with torch.inference_mode():
            npz_err = (loaded(crops) - state.model(crops)).abs().max().item()
        log(f"train_landmarks: the final .npz ({os.path.getsize(npz)} bytes) through evaluate.load_landmark_model: "
            f"heatmaps on {TRAIN_VAL_FRAMES} validation crops {npz_err} from the trained model's (limit 0)")
        if npz_err != 0:
            raise RuntimeError(f"the trained model's .npz gives other heatmaps: {npz_err}")
        k1_row = crop_row(torch, m, dev, k1.calls[-1],
                          f"crop_bilinear (train_landmarks validate: batch {cfg.test.batch_size_per_chip})")
        del state, loaded, crops
        repeated_batch(torch, m, dev, cfg, train_ex, card)
    return k1_row, launches


def repeated_batch(torch, m, dev, cfg, examples, card) -> None:
    """30 updates of a fresh W32 on one augmented batch of 24: the mean loss
    of the last 5 must be below the first; the steps after the fifth timed."""
    model = m.models.build_landmark_model(cfg.model.name, NUM_JOINTS, device=dev, dtype=torch.bfloat16,
                                          generator=torch.Generator().manual_seed(0))
    opt = m.optim.build_optimizer("adam", model.parameters(), cfg.train.lr)
    state = m.train_state.TrainState(model, opt)
    step = m.train_state.make_train_step(True)
    b = cfg.train.batch_size_per_chip
    images, bboxes, joints, vis = m.landmark_dataset.DeviceDatasetCache(examples, dev).gather(range(b))
    batch = m.landmark_dataset.device_transform(
        images, bboxes, joints, vis, m.landmark_loop.step_generator(1, 0), image_size=tuple(cfg.model.image_size),
        heatmap_size=tuple(cfg.model.heatmap_size), sigma=cfg.model.sigma)
    losses, ms, enqueue_ms = [], [], []
    for _ in range(TRAIN_REPEATS):
        sync()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)  # the host's share: nothing in the step waits
        losses.append(metrics["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    last = sum(losses[-5:]) / 5
    step_ms = median(ms[5:])
    log(f"train step on one repeated batch of {b} ({cfg.model.name} {cfg.model.image_size}, bf16, Adam "
        f"{cfg.train.lr}) on {card}: losses "
        f"{[round(v, 6) for v in losses]}; first {losses[0]:.6f}, mean of the last 5 {last:.6f} (must be lower); "
        f"step {step_ms:.4f} ms (median of steps 6-{TRAIN_REPEATS}; all {[round(v, 4) for v in ms]}) = "
        f"{b / step_ms * 1e3:.2f} images/s; the host returned from the step after {median(enqueue_ms[5:]):.4f} ms "
        f"(median)")
    if not (all(math.isfinite(v) for v in losses) and last < losses[0]):
        raise RuntimeError(f"30 updates on one batch did not lower its loss: {losses}")
    profile_call(torch, lambda: step(state, batch), f"train step (batch {b})")


DA_SOURCE, DA_TARGET, DA_VAL, DA_REPEATS = 8, 12, 16, 10
DA_TINY_BETA = 0.5  # the adversarial gradient weighs in the tiny check's generator update
# the repeated batch's Adam: at the preset's 1e-3 the first update overshoots
# the heads' N(0, 0.001) start (on an H100, hm_loss 0.010312 -> 0.011854,
# back to only 0.010301 after 10 updates)
DA_REPEAT_LR = 1e-4


def param_drift(torch, sd_a, sd_b, lr) -> tuple[float, float, float, int]:
    """|a - b| of every parameter entry (BN statistics left out) in units of
    ``lr``: (max, share beyond 0.1 lr, share beyond 1e-3 lr, entries)."""
    d = torch.cat([((sd_a[k].float().cpu() - v.float().cpu()).abs() / lr).flatten() for k, v in sd_b.items()
                   if not k.endswith((".mean", ".var"))])
    return d.max().item(), (d > 0.1).float().mean().item(), (d > 1e-3).float().mean().item(), d.numel()


def stats_err(sd_a, sd_b) -> float:
    return max((sd_a[k].float().cpu() - v.float().cpu()).abs().max().item() for k, v in sd_b.items()
               if k.endswith((".mean", ".var")))


def check_da_tiny_against_cpu(torch, m) -> None:
    """``hrnet_tiny_cms`` and ``MultiScaleDiscriminator(stage_blocks=(1, 1, 1,
    1))`` at 64x64, float32 (TF32 off), d_loss_mode 2, 3 updates on one
    batch of 2 source and 3 target images, held phase by phase card
    against CPU (as ``tests/test_torch_adversarial.py`` holds the port to
    JAX): before each update the card takes the CPU's state (both models,
    both Adam states); phase 1 is held (d_loss 1e-4 relative, the
    discriminator's BN statistics 1e-5, its parameters within 4 lr and at
    most 1% beyond 0.1 lr); the card takes the CPU's updated
    discriminator; phase 2 is held (loss, hm_loss, adv_loss 1e-4 relative,
    the generator's statistics and parameters likewise). Free-running
    float32 runs part within 3 updates: the first Adam update sets an entry
    whose gradient sign is rounding 2 lr apart. The parameter bounds are
    wider than the CPU tests' against JAX (2 lr, 0.1%): cuDNN runs float32
    convolutions by FFT and GEMM algorithms that round unlike the CPU's
    direct ones (measured on an H100: 1.8 lr, 0.073% beyond 0.1 lr), and
    after the first update Adam's step on a rounding-signed gradient
    reaches (1 - b1) / sqrt(1 - b2) = 3.2 lr."""
    import copy
    import dataclasses

    A, size, lr = m.adversarial, 64, 1e-3
    cfg = dataclasses.replace(m.hrnet.HRNET_TINY, num_joints=NUM_JOINTS, head="cms")
    g = torch.Generator().manual_seed(7)
    batch = {"source_image": torch.randn(2, size, size, 3, generator=g),
             "target_image": torch.randn(3, size, size, 3, generator=g)}
    joints, vis = torch.rand(2, NUM_JOINTS, 2, generator=g) * size, torch.ones(2, NUM_JOINTS)
    for idx, div in enumerate((1, 2, 4, 8)):
        suffix = "" if idx == 0 else str(idx + 1)
        batch[f"target{suffix}"], batch[f"target_weight{suffix}"] = m.heatmap.generate_target(
            joints, vis, (size, size), (size // div, size // div), 4.0 / (idx + 1))
    states = {}
    for device in ("cpu", "cuda"):
        gen = m.hrnet.HRNet(cfg, device=device, generator=torch.Generator().manual_seed(1))
        disc = m.discriminator.MultiScaleDiscriminator(NUM_JOINTS, stage_blocks=(1, 1, 1, 1), device=device,
                                                       generator=torch.Generator().manual_seed(2))
        sched = m.optim.multistep_schedule(lr, [2])
        states[device] = A.DAState(gen, disc, m.optim.build_optimizer("adam", gen.parameters(), sched,
                                                                        weight_decay=1e-4),
                                   m.optim.build_optimizer("adam", disc.parameters(), sched))
    cpu, card = states["cpu"], states["cuda"]
    batches = {d: {k: v.to(d) for k, v in batch.items()} for d in states}
    worst = {"loss": 0.0, "d_stats": 0.0, "g_stats": 0.0, "d_max": 0.0, "g_max": 0.0, "d_01": 0.0, "g_01": 0.0}
    losses = []
    for k in range(3):
        step_lr = lr * (0.1 if k >= 2 else 1.0)
        card.load_state_dict(copy.deepcopy(cpu.state_dict()))  # no tensor shared with the CPU's optimizer
        phase = {}
        for d, st in states.items():
            domain = A.domain_labels(batches[d])
            outs = A.generator_forward(st, batches[d])
            phase[d] = (domain, outs, A.discriminator_update(st, outs, domain).item())
        worst["loss"] = max(worst["loss"], abs(phase["cuda"][2] - phase["cpu"][2]) / abs(phase["cpu"][2]))
        sd_c, sd_g = cpu.discriminator.state_dict(), card.discriminator.state_dict()
        worst["d_stats"] = max(worst["d_stats"], stats_err(sd_g, sd_c))
        mx, s01, s3, n_d = param_drift(torch, sd_g, sd_c, step_lr)
        worst["d_max"], worst["d_01"] = max(worst["d_max"], mx), max(worst["d_01"], s01)
        card.discriminator.load_state_dict(sd_c)
        out = {}
        for d, st in states.items():
            domain, outs, _ = phase[d]
            out[d] = [v.item() for v in A.generator_update(st, outs, batches[d], domain, DA_TINY_BETA, 2)]
            st.step += 1
        losses.append(out["cuda"] + [phase["cuda"][2]])
        worst["loss"] = max(worst["loss"], *(abs(a - b) / abs(b) for a, b in zip(out["cuda"], out["cpu"])))
        sd_c, sd_g = cpu.generator.state_dict(), card.generator.state_dict()
        worst["g_stats"] = max(worst["g_stats"], stats_err(sd_g, sd_c))
        mx, s01, s3g, n_g = param_drift(torch, sd_g, sd_c, step_lr)
        worst["g_max"], worst["g_01"] = max(worst["g_max"], mx), max(worst["g_01"], s01)
        log(f"tiny DA update {k}: share beyond 1e-3 lr: discriminator {s3:.4g} of {n_d}, generator {s3g:.4g} of {n_g}")
    log(f"tiny DA steps, card vs CPU phase by phase (hrnet_tiny_cms + discriminator (1, 1, 1, 1) at 64^2, f32, "
        f"d_loss_mode 2, beta {DA_TINY_BETA}, 3 Adam updates): [loss, hm_loss, adv_loss, d_loss] "
        f"{[[round(v, 6) for v in row] for row in losses]}; worst: losses {worst['loss']:.3g} relative (limit 1e-4), "
        f"BN statistics discriminator {worst['d_stats']:.3g} / generator {worst['g_stats']:.3g} (limit 1e-5), "
        f"parameters max {worst['d_max']:.3g} / {worst['g_max']:.3g} lr (limit 4), share beyond 0.1 lr "
        f"{worst['d_01']:.3g} / {worst['g_01']:.3g} (limit 1e-2)")
    if not (worst["loss"] <= 1e-4 and max(worst["d_stats"], worst["g_stats"]) <= 1e-5
            and max(worst["d_max"], worst["g_max"]) <= 4.0 and max(worst["d_01"], worst["g_01"]) <= 1e-2):
        raise RuntimeError(f"tiny DA steps differ between the card and the CPU: {worst}")


def da_batch(torch, m, dev, cfg, source, target, preset: str) -> dict:
    """One DA batch on the card, as ``train_landmarks_da.train`` builds it:
    the first source and target examples, the draws of step 0."""
    T = m.train_landmarks_da
    src_draws, tgt_draws = T.sample_step_draws(m.landmark_loop.step_generator(cfg.seed + 2, 0), cfg, preset)
    image_size, hm_size = tuple(cfg.model.image_size), tuple(cfg.model.heatmap_size)
    sigmas = (cfg.model.sigma, cfg.model.sigma2, cfg.model.sigma3, cfg.model.sigma4)
    src = m.landmark_dataset.DeviceDatasetCache(source, dev).gather(range(cfg.train.batch_size_per_chip))
    tgt = m.landmark_dataset.DeviceDatasetCache(target, dev).gather(range(cfg.train.batch_size_adversarial))
    batch = T.multi_scale_targets(*src, src_draws, image_size, hm_size, sigmas, T.photo_ranges(preset)["erase_p"])
    batch["target_image"] = m.landmark_dataset.device_transform(
        *tgt, image_size=image_size, heatmap_size=hm_size, sigma=cfg.model.sigma, draws=tgt_draws)["image"]
    return batch


def fresh_da_state(torch, m, dev, cfg, lr):
    """The trainer's models from its seeds on the card, Adam at ``lr`` for both."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    gen = m.models.build_landmark_model(cfg.model.name, NUM_JOINTS, device=dev, dtype=dtype,
                                        generator=torch.Generator().manual_seed(cfg.seed))
    disc = m.discriminator.MultiScaleDiscriminator(NUM_JOINTS, device=dev,
                                                   generator=torch.Generator().manual_seed(cfg.seed + 1))
    return m.adversarial.DAState(gen, disc, m.optim.build_optimizer("adam", gen.parameters(), lr),
                                 m.optim.build_optimizer("adam", disc.parameters(), lr))


def da_split(torch, m, state, batch, cfg, card) -> None:
    """CUDA events around the DA step's three phases (3 steps, the last
    reported), the discriminator's own part of phase 2 (its eval forward
    and the gradient to its inputs) timed alone, and torch.profiler over
    one more step."""
    A = m.adversarial
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    spans = []
    for _ in range(3):
        domain = A.domain_labels(batch)
        ev[0].record()
        outs = A.generator_forward(state, batch)
        ev[1].record()
        A.discriminator_update(state, outs, domain)
        ev[2].record()
        A.generator_update(state, outs, batch, domain, cfg.train.beta, cfg.train.d_loss_mode)
        ev[3].record()
        state.step += 1
        sync()
        spans.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    with torch.no_grad():
        outs = [o.detach().requires_grad_(True) for o in A.generator_forward(state, batch)]
    disc = state.discriminator
    disc.eval()
    disc.requires_grad_(False)
    disc_ms = []
    for _ in range(3):
        ev[0].record()
        A.softmax_ce(disc(*outs), domain).backward()
        ev[1].record()
        sync()
        disc_ms.append(ev[0].elapsed_time(ev[1]))
    disc.requires_grad_(True)
    fwd, d_phase, g_phase = spans[-1]
    total = fwd + d_phase + g_phase
    log(f"DA step split by CUDA events ({cfg.model.name} -> {cfg.model.heatmap_size}) on {card} (all "
        f"{[[round(v, 4) for v in r] for r in spans]}): generator "
        f"forward {fwd:.4f} ms, discriminator phase (train-mode forward, backward, Adam) {d_phase:.4f} ms, generator "
        f"phase (losses, eval-mode discriminator forward and input gradient, generator backward, Adam) "
        f"{g_phase:.4f} ms; the discriminator's eval forward + input gradient alone {median(disc_ms):.4f} ms "
        f"(all {[round(v, 4) for v in disc_ms]}); the discriminator's share of the step "
        f"{(d_phase + median(disc_ms)) / total:.4f}")
    step = A.make_da_train_step(beta=cfg.train.beta, d_loss_mode=cfg.train.d_loss_mode)
    profile_call(torch, lambda: step(state, batch), f"DA step ({cfg.model.name}, {cfg.train.batch_size_per_chip} "
                                                    f"source + {cfg.train.batch_size_adversarial} target)")


def da_train_run(torch, m, dev, cfg, preset, source, target, val, out_dir, card):
    """``train_landmarks_da.train`` on the card with its steps, validation and
    K1 calls recorded (counters reset just before, read just after)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = Timed(m.train_landmarks_da, "make_da_train_step", factory=True, keep=True)
    validate = Timed(m.landmark_loop, "validate")
    k1 = Capture(*m.kernels["K1"][:2])
    with steps, validate, k1:
        reset_counts(m)
        t0 = time.perf_counter()
        state = m.train_landmarks_da.train(cfg, source, target, out_dir, dev, val, preset)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts(m)
    metrics = [{k: v.item() for k, v in met.items()} for met in steps.results]
    finite = all(math.isfinite(v) for met in metrics for v in met.values()) and all(
        bool(torch.isfinite(v).all()) for part in (state.generator, state.discriminator)
        for v in part.state_dict().values())
    per_epoch = max(len(steps.ms) // max(cfg.train.end_epoch, 1), 1)
    warm_up = per_epoch if cfg.train.end_epoch > 1 else 1  # the first epoch, or the first step of one
    timed = steps.ms[warm_up:] or steps.ms
    step_ms = median(timed)
    images = cfg.train.batch_size_per_chip + cfg.train.batch_size_adversarial
    log(f"train_landmarks_da --preset {preset} ({cfg.model.name} {cfg.model.image_size} -> "
        f"{cfg.model.heatmap_size}, {cfg.train.batch_size_per_chip} source + {cfg.train.batch_size_adversarial} "
        f"target images a step, {cfg.model.compute_dtype} generator over float32, float32 discriminator "
        f"(3, 4, 6, 3), beta {cfg.train.beta}, d_loss_mode {cfg.train.d_loss_mode}, {len(source)} source / "
        f"{len(target)} target frames, {cfg.train.end_epoch} epochs of {per_epoch} steps, validation of "
        f"{0 if val is None else len(val)} at the last) on {card}: {wall:.4f} s in all; DA step {step_ms:.4f} ms "
        f"(median of the {len(timed)} after the first {warm_up}; all "
        f"{[round(v, 4) for v in steps.ms]}) = {images / step_ms * 1e3:.2f} images/s; validate "
        f"{[round(v, 4) for v in validate.ms]} ms; peak memory {torch.cuda.max_memory_allocated() / 1e9:.4f} GB "
        f"(torch.cuda.max_memory_allocated); [loss, hm_loss, d_loss, adv_loss] "
        f"{[[round(met[k], 6) for k in ('loss', 'hm_loss', 'd_loss', 'adv_loss')] for met in metrics]}; launches "
        f"{json.dumps(launches)}")
    if not finite:
        raise RuntimeError(f"train_landmarks_da --preset {preset}: a loss or a parameter is not finite: {metrics}")
    return state, k1, launches


def da_repeated_batch(torch, m, dev, cfg, batch, card) -> None:
    """10 DA updates of fresh models on one batch, Adam at ``DA_REPEAT_LR``:
    the mean hm_loss of the last 3 must be below the first."""
    state = fresh_da_state(torch, m, dev, cfg, DA_REPEAT_LR)
    step = m.adversarial.make_da_train_step(beta=cfg.train.beta, d_loss_mode=cfg.train.d_loss_mode)
    hm, ms = [], []
    for _ in range(DA_REPEATS):
        sync()
        t0 = time.perf_counter()
        hm.append(step(state, batch)["hm_loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    last = sum(hm[-3:]) / 3
    log(f"DA updates on one repeated batch ({cfg.model.name}, Adam {DA_REPEAT_LR} for both) on {card}: hm_loss "
        f"{[round(v, 6) for v in hm]}; first {hm[0]:.6f}, mean of the last 3 {last:.6f} (must be lower); step ms "
        f"{[round(v, 4) for v in ms]}")
    if not (all(math.isfinite(v) for v in hm) and last < hm[0]):
        raise RuntimeError(f"{DA_REPEATS} DA updates on one batch did not lower its hm_loss: {hm}")


def cms_evaluate(torch, m, dev, hr, out_dir):
    """``evaluate.run_scene`` with a CMS landmark model (768 crops, 768^2
    heatmaps) on one batch of 8 seeded 1920x1200 frames, the evaluation
    phase's X101-32x8d detector and camera; poses finite. Returns the K1,
    K2 and K4 rows on its inputs and its launch counts."""
    import numpy as np

    det = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, dtype=torch.bfloat16, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    lm3d = np.random.default_rng(2).normal(0, 0.8, (NUM_JOINTS, 3))
    cam = m.camera.CameraModel(K=np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]]),
                               dist=np.array(EVAL_DIST), width=FRAME_HW[1], height=FRAME_HW[0])
    config = m.pipeline.PipelineConfig(image_size=(768, 768), solver="ransac")
    frames = torch.randint(0, 256, (EVAL_BATCH, *FRAME_HW, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    names = [f"img{i:06d}.png" for i in range(EVAL_BATCH)]
    captures = {key: Capture(*m.kernels[key][:2]) for key in ("K1", "K2", "K4")}
    with contextlib.ExitStack() as stack:
        for c in captures.values():
            stack.enter_context(c)
        reset_counts(m)
        t0 = time.perf_counter()
        res = m.evaluate.run_scene(frames, names, out_dir, det, hr, lm3d, cam, batch_size=EVAL_BATCH,
                                   input_size=EVAL_SIZE, config=config,
                                   generator=torch.Generator(device=dev).manual_seed(6))
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts(m)
    check_artifacts(torch, out_dir, EVAL_BATCH)
    finite = bool(np.isfinite(res["R"]).all() and np.isfinite(res["t"]).all())
    log(f"evaluate with the CMS landmark model (X101-32x8d bf16 at {EVAL_SIZE}, {type(hr).__name__} "
        f"{hr.config.head} at 768 -> 768^2 heatmaps, RANSAC 256): {EVAL_BATCH} frames in {wall:.4f} s (one batch, "
        f"no warm-up); poses finite {finite}; launches {json.dumps(launches)}; first t {res['t'][0].tolist()}")
    if not finite:
        raise RuntimeError("evaluate with the CMS landmark model gave a pose that is not finite")
    for key in ("K1", "K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by the CMS evaluation")
    boxes = captures["K2"].calls[-1][0][1]
    rows = [crop_row(torch, m, dev, captures["K1"].calls[-1], f"crop_bilinear (evaluate, CMS: 768^2 crops, batch "
                                                                 f"{EVAL_BATCH})"),
            pooler_row(torch, m, captures["K2"].calls[-1],
                       f"roi_align_multilevel (evaluate, CMS: X101, batch {EVAL_BATCH}, {boxes.shape[0]} ROIs)")]
    rows += nms_rows(torch, m, dev, captures["K4"].calls[-2:], "evaluate, CMS: X101 ")
    return rows, launches


def da_phase(torch, m, dev, card):
    """The CMS models and the adversarial domain adaptation at full width:
    the tiny card-vs-CPU check; ``tools.train_landmarks_da.train`` with the
    ``lightbox_cms`` preset (HRNet-W32 CMS at 768 -> 768^2, 11 joints, bf16
    generator over float32, float32 ResNet-34 discriminator, 2 source + 3
    target images a step, Adam 1e-3 for both, beta 2e-4, d_loss_mode 2) on
    seeded 1920x1200 frames on the card (8 source, 12 target, 16
    target-domain validation), 2 epochs of 4 steps and validation at the
    last (K1's counter reset just before, read just after); the generator's
    ``.npz`` through ``tools.test_landmarks``; K1 on the validation batch;
    the step's split, profile and a repeated batch; ``sunlamp_cms``
    (``hrnet_cms_384``, 384^2 heatmaps) for an epoch of 2 steps, with its
    step's split and profile; and
    ``evaluate.run_scene`` with the trained CMS model. Returns (rows,
    launches) of the DA run's validation and of the CMS evaluation."""
    import os
    import tempfile

    t0 = time.perf_counter()
    check_da_tiny_against_cpu(torch, m)
    cfg = m.config.apply_overrides(m.config.get_preset("lightbox_cms"), ["TRAIN.END_EPOCH", "2"])
    with tempfile.TemporaryDirectory() as out_dir:
        source = landmark_scene(torch, m, dev, DA_SOURCE, 21, out_dir, "source", FRAME_HW)
        target = landmark_scene(torch, m, dev, DA_TARGET, 22, out_dir, "target", FRAME_HW)
        val = landmark_scene(torch, m, dev, DA_VAL, 23, out_dir, "target_val", FRAME_HW)
        state, k1, da_launches = da_train_run(torch, m, dev, cfg, "lightbox_cms", source, target, val,
                                              os.path.join(out_dir, "lightbox"), card)
        if da_launches["K1"] == 0:
            raise RuntimeError("kernel K1 was not launched by the DA trainer's validation")
        # the generator's checkpoint, as tools/test_landmarks reads it
        npz = os.path.join(out_dir, "lightbox", "checkpoints", str(state.step), "model.npz")
        loaded = m.evaluate.load_landmark_model(npz, cfg.model.name, NUM_JOINTS, state.generator.dtype, dev)
        frames, bboxes, _, _ = m.landmark_dataset.DeviceDatasetCache(val, dev).gather(range(DA_VAL))
        centers, scales = m.geometry.bbox_to_center_scale(bboxes)
        size = tuple(cfg.model.image_size)
        crops = m.pipeline.normalize_crops(m.warp.crop_bilinear_plain(
            frames, m.warp.crop_params(centers, scales, size), size))
        state.generator.eval()
        with torch.inference_mode():
            npz_err = (loaded(crops) - state.generator(crops)).abs().max().item()
        preds = [m.test_landmarks.predict_landmarks([model], val, cfg) for model in (loaded, state.generator)]
        pred_err = float(abs(preds[0] - preds[1]).max())
        log(f"train_landmarks_da: the generator's .npz ({os.path.getsize(npz)} bytes) through "
            f"evaluate.load_landmark_model: heatmaps on {DA_VAL} validation crops {npz_err} from the trained "
            f"model's (limit 0); tools.test_landmarks.predict_landmarks {pred_err} apart (limit 0)")
        if npz_err != 0 or pred_err != 0:
            raise RuntimeError(f"the DA generator's .npz gives other heatmaps: {npz_err}, predictions {pred_err}")
        k1_row = crop_row(torch, m, dev, k1.calls[-1], f"crop_bilinear (train_landmarks_da validate: batch "
                                                       f"{cfg.test.batch_size_per_chip} of 768^2)")
        del crops, frames
        batch = da_batch(torch, m, dev, cfg, source, target, "lightbox_cms")
        da_split(torch, m, state, batch, cfg, card)
        del state
        torch.cuda.empty_cache()
        da_repeated_batch(torch, m, dev, cfg, batch, card)
        del batch
        torch.cuda.empty_cache()
        sun_cfg = m.config.apply_overrides(m.config.get_preset("sunlamp_cms"), ["TRAIN.END_EPOCH", "1"])
        sun_source = landmark_scene(torch, m, dev, 2 * sun_cfg.train.batch_size_per_chip, 24, out_dir,
                                    "sun_source", FRAME_HW)
        state, _, _ = da_train_run(torch, m, dev, sun_cfg, "sunlamp_cms", sun_source, target, None,
                                   os.path.join(out_dir, "sunlamp"), card)
        da_split(torch, m, state, da_batch(torch, m, dev, sun_cfg, sun_source, target, "sunlamp_cms"), sun_cfg, card)
        del state
        torch.cuda.empty_cache()
        eval_rows, eval_launches = cms_evaluate(torch, m, dev, loaded, os.path.join(out_dir, "evaluate"))
    log(f"DA phase: {time.perf_counter() - t0:.1f} s")
    return ([k1_row], da_launches), (eval_rows, eval_launches)


DET_TRAIN_FRAMES, DET_VAL_FRAMES, DET_TRAIN_STEPS, DET_REPEATS = 32, 8, 8, 20
# the repeated batch's SGD: a constant rate, where config_1's warmup starts at
# 1e-3 x 1e-3 and would not move the weights in 20 updates
DET_REPEAT_LR = 2e-3
DET_TINY_LR = 1e-3


def detection_scene(torch, m, dev, n: int, seed: int, out_dir: str, split: str):
    """``n`` seeded 1920x1200 uint8 BGR frames on the card (dim noise, one
    bright box of 150-600 px a side each) and their COCO json ->
    ``DetectionExamples`` over the frames in memory."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    frames = torch.randint(0, 48, (n, h, w, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    images, anns = [], []
    for i in range(n):
        bw, bh = (int(v) for v in rng.integers(min(h, w) // 8, min(h, w) // 2, 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        frames[i, y0:y0 + bh, x0:x0 + bw] = torch.tensor([int(v) for v in rng.integers(180, 256, 3)],
                                                         dtype=torch.uint8, device=dev)
        images.append({"id": i, "file_name": f"{split}{i:04d}.png", "height": h, "width": w})
        anns.append({"id": i, "image_id": i, "category_id": 1, "bbox": [x0, y0, bw, bh], "area": bw * bh,
                     "iscrowd": 0})
    path = os.path.join(out_dir, f"{split}.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "spacecraft"}]}, f)
    return path, m.detection_dataset.DetectionExamples(path, frames={im["file_name"]: frames[i]
                                                                    for i, im in enumerate(images)})


def tiny_det_batch(torch):
    """2 seeded 64x64 images, two GT boxes each (padded to 16)."""
    import numpy as np

    rng = np.random.default_rng(3)
    gt = np.zeros((2, 16, 4), np.float32)
    gt[0, :2] = [[6, 8, 30, 40], [30, 20, 60, 58]]
    gt[1, :2] = [[0, 10, 44, 50], [20, 2, 36, 22]]
    valid = np.zeros((2, 16), bool)
    valid[:, :2] = True
    return {"image": torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)),
            "gt_boxes": torch.from_numpy(gt), "gt_classes": torch.zeros(2, 16, dtype=torch.int32),
            "gt_valid": torch.from_numpy(valid)}


def check_det_train_tiny_against_cpu(torch, m) -> None:
    """``RCNN_TINY`` with ``freeze_at=2`` in float32 (TF32 off) on the card
    against the CPU: 3 SGD updates (lr 1e-3, momentum 0.9, weight decay
    1e-4) from the same weights on the same batch and sampling draws. The
    losses and grad norms within 1e-4 relative; the parameters within 1 lr,
    at most 1% of them beyond 1e-3 lr; the frozen ones (FrozenBN's tensors,
    the stem's and res2's weights), which only the decay moves, within 1e-6
    relative and moved."""
    import dataclasses

    cfg = dataclasses.replace(m.rcnn.RCNN_TINY, backbone=dataclasses.replace(m.rcnn.RCNN_TINY.backbone, freeze_at=2))
    data = tiny_det_batch(torch)
    runs = {}
    for device in ("cpu", "cuda"):
        model = m.rcnn.GeneralizedRCNN(cfg, device=device, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # tests/test_torch_detection_train.py's conditioning: a small stem keeps raw
            model.backbone.stem.conv.weight.mul_(1e-2)  # 0-255 pixels from saturating the logits, and tame heads
            bn_gen = torch.Generator().manual_seed(7)  # keep 3 updates from amplifying roundings
            heads = model.roi_heads.predictor
            for lin in (model.rpn_head.deltas, heads.bbox_pred, heads.cls_score):
                lin.weight.copy_(0.05 * torch.randn(lin.weight.shape, generator=bn_gen))
            for bn in model.modules():
                if isinstance(bn, m.resnet_backbone.FrozenBN):  # frozen statistics off the identity, as trained ones
                    for t in (bn.scale, bn.var):
                        t.copy_(0.5 + torch.rand(t.shape, generator=bn_gen))
                    for t in (bn.bias, bn.mean):
                        t.copy_(0.1 * torch.randn(t.shape, generator=bn_gen))
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        opt = m.optim.build_optimizer("sgd", model.parameters(), m.optim.multistep_schedule(DET_TINY_LR, [2]),
                                      weight_decay=1e-4, momentum=0.9)
        state = m.detection_state.DetTrainState(model, opt)
        step = m.detection_state.make_detection_train_step()
        batch = {k: v.to(device) for k, v in data.items()}
        mets = []
        for i in range(3):
            gen = torch.Generator().manual_seed(100 + i)  # the same draws on both devices
            mets.append({k: v.item() for k, v in step(state, batch, generator=gen).items()})
        runs[device] = (mets, {k: v.detach().cpu() for k, v in model.state_dict().items()}, init)
    (mc, sc, init), (mg, sg, _) = runs["cpu"], runs["cuda"]
    rel = lambda k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-6) for a, b in zip(mc, mg))
    loss_err, gn_err = max(rel(k) for k in mc[0] if k.startswith("loss")), rel("grad_norm")
    dp = torch.cat([((sg[k] - v).abs() / DET_TINY_LR).flatten() for k, v in sc.items()])
    share = (dp > 1e-3).float().mean().item()
    frozen = [k for k in sc if k.split(".")[-1] in ("scale", "bias", "mean", "var") and ".norm." in k]
    frozen += [k for k in sc if k.startswith(("backbone.stem.", "backbone.res2_")) and k.endswith("conv.weight")]
    frozen_err = max(((sg[k] - sc[k]).abs() / sc[k].abs().clamp(min=1e-9)).max().item() for k in frozen)
    moved = sum(int(not torch.equal(sc[k], init[k])) for k in frozen)
    log(f"tiny detector train steps, card vs CPU (RCNN_TINY, freeze_at 2, 3 SGD updates, f32): losses "
        f"{[round(a['loss_total'], 6) for a in mg]}, relative err {loss_err:.3g} (limit 1e-4), grad norms "
        f"{gn_err:.3g} (limit 1e-4), parameters max {dp.max().item():.3g} lr (limit 1), share beyond 1e-3 lr "
        f"{share:.3g} (limit 0.01) of {dp.numel()}; frozen tensors {len(frozen)}, moved by the decay {moved}, "
        f"card vs CPU {frozen_err:.3g} relative (limit 1e-6)")
    if not (loss_err <= 1e-4 and gn_err <= 1e-4 and dp.max().item() <= 1.0 and share <= 0.01
            and frozen_err <= 1e-6 and moved == len(frozen)):
        raise RuntimeError(f"tiny detector train steps differ between the card and the CPU: loss {loss_err}, grad "
                           f"norm {gn_err}, parameters {dp.max().item()} lr, share {share}, frozen {frozen_err}, "
                           f"moved {moved} of {len(frozen)}")


def pooler_grad_controls(torch, m, a, got, want, limit) -> dict[str, float]:
    """Wrong gradients that K2's backward bar must reject, on the row's own
    call (bound arguments ``a``, the kernel's gradient ``got`` and the plain
    one ``want``): the kernel's gradient doubled; the busiest level's
    gradient lost, as a kernel that sent it to another level would leave
    it; and each ROI's gradient sent to the box half the batch away, on
    another image (the kernel on ``grad_out`` rolled by R/2). Returns each
    one's max_abs_err; raises if one is within ``limit``."""
    busiest = max(range(len(want)), key=lambda i: want[i].float().abs().max().item())
    half = a["boxes"].shape[0] // 2
    rolled = m.roi_align.roi_align_multilevel_backward(**{**a, "grad_out": a["grad_out"].roll(half, 0)})
    controls = {"doubled": [2 * g for g in got],
                f"level P{busiest + 2} lost": [torch.zeros_like(g) if i == busiest else g for i, g in enumerate(got)],
                "ROIs sent to another image's boxes": rolled}
    errs = {k: max((g.float() - w.float()).abs().max().item() for g, w in zip(c, want)) for k, c in controls.items()}
    log(f"K2b bar's controls on the train step's call: max_abs_err {json.dumps(errs)} (each must exceed the limit "
        f"{limit:.3g})")
    for k, err in errs.items():
        if not err > limit:
            raise RuntimeError(f"K2b's bar {limit} cannot tell a wrong gradient ({k}: {err}) from the right one")
    return errs


def pooler_backward_row(torch, m, call, name):
    """K2's backward row on one captured call: held to the plain autograd
    gradient within ``pooler_grad_limit`` of its own scale, a bar shown to
    reject wrong gradients (``pooler_grad_controls``); its library
    yardstick is the backward of ``F.grid_sample`` + ``F.avg_pool2d`` under
    autograd."""
    import torch.nn.functional as F

    bargs, bkw = call
    b = inspect.signature(m.roi_align.roi_align_multilevel_backward_plain).bind(*bargs, **bkw)  # the same parameters
    b.apply_defaults()
    a = b.arguments
    grad_out, shapes, dtype, boxes, batch_idx = (a[k] for k in ("grad_out", "shapes", "dtype", "boxes", "batch_idx"))
    want = m.roi_align.roi_align_multilevel_backward_plain(*bargs, **bkw)
    scale = max(w.float().abs().max().item() for w in want)
    limit = pooler_grad_limit(dtype, scale)
    got = m.roi_align.roi_align_multilevel_backward(*bargs, **bkw)
    again = m.roi_align.roi_align_multilevel_backward(*bargs, **bkw)
    sync()
    same = all(torch.equal(g, h) for g, h in zip(got, again))
    log(f"K2b on the train step's call: two calls equal bit for bit {same}")
    if not same:
        raise RuntimeError("K2b: two calls on the same inputs differ")
    controls = pooler_grad_controls(torch, m, a, got, want, limit)
    del got, again
    r, p, _, c = grad_out.shape
    out_bytes = sum(math.prod(sh) for sh in shapes) * (2 if dtype == torch.bfloat16 else 4)
    nbytes_ = nbytes(grad_out, boxes, batch_idx) + out_bytes
    # the yardstick: per level, autograd of grid_sample + avg_pool2d on the f32 map, one forward kept
    feats = [torch.zeros(sh, device=boxes.device, dtype=dtype) for sh in shapes]
    levels = m.roi_align.assign_levels(boxes, len(shapes), int(math.log2(a["strides"][0])))
    maps = [(x.requires_grad_(), g) for x, g in pooler_library_maps(
        torch, m.roi_align, (feats, boxes, batch_idx, p, a["strides"]), {"sampling_ratio": a["sampling_ratio"]})]
    outs = [F.avg_pool2d(F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=False),
                         a["sampling_ratio"]) for x, g in maps]
    gouts = [torch.randn_like(o) for o in outs]
    run_lib = lambda: torch.autograd.grad(outs, [x for x, _ in maps], gouts, retain_graph=True)
    return dict(id="K2b", name=name,
                source="spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel_backward.cu",
                replaces="none: the gradient of spacecraft_pose_estimation_tpu/ops/roi_align.py:194 (windowed XLA "
                         "pooler, jax.grad); no TPU kernel has a backward",
                run_k=lambda: m.roi_align.roi_align_multilevel_backward(*bargs, **bkw),
                run_p=lambda: m.roi_align.roi_align_multilevel_backward_plain(*bargs, **bkw),
                run_lib=run_lib, lib_graph=False,  # autograd of a forward built outside cannot be captured
                tol=limit, peak=FP32_FLOPS, numbers=(nbytes_, 53.0 * r * p * p * c),
                extra={"grad_scale": scale, "grad_limit": limit, "controls_max_abs_err": controls,
                       "impl": a["impl"], "rois": r, "levels_hist": torch.bincount(levels, minlength=4).tolist(),
                       "bit_equal_calls": same})


def det_step_split(torch, m, state, batch, card) -> None:
    """The detector train step of ``make_detection_train_step`` split by
    CUDA events that wrappers around its ``model.losses`` and
    ``optimizer.step`` record (3 steps, the last reported): the losses'
    forward; the backward (from the losses to SGD: zero_grad, backward, the
    frozen parameters' zero gradients, the gradient norm); SGD. Then
    torch.profiler over one more step."""
    model, opt = state.model, state.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def between(fn, first: int, last: int):
        def call(*args, **kwargs):
            ev[first].record()
            out = fn(*args, **kwargs)
            ev[last].record()
            return out

        return call

    step = m.detection_state.make_detection_train_step()
    gen = lambda: m.landmark_loop.step_generator(42, 0)
    spans = []
    model.losses, opt.step = between(model.losses, 0, 1), between(opt.step, 2, 3)
    try:
        for _ in range(3):
            step(state, batch, generator=gen())
            sync()
            spans.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    finally:
        del model.losses, opt.step  # the instance's wrappers: the class's methods again
    fwd, bwd, sgd = spans[-1]
    log(f"detector train step split by CUDA events (X101-32x8d FPN 800^2, batch 4) on {card} (all "
        f"{[[round(v, 4) for v in r] for r in spans]}): losses forward {fwd:.4f} ms, backward {bwd:.4f} ms, "
        f"SGD {sgd:.4f} ms")
    profile_call(torch, lambda: step(state, batch, generator=gen()), "detector train step (config_1, batch 4)")


def det_repeated_batch(torch, m, dev, args, batch, card) -> None:
    """20 updates of a fresh config_1 model on one augmented batch of 4 with
    the same sampling draws each time, SGD at a constant DET_REPEAT_LR
    (momentum 0.9, weight decay 1e-4): the mean loss_total of the last 5
    must be below the first."""
    model = m.train_detector.build_model(args, dev)
    opt = m.optim.build_optimizer("sgd", model.parameters(), DET_REPEAT_LR, weight_decay=1e-4, momentum=0.9)
    state = m.detection_state.DetTrainState(model, opt)
    step = m.detection_state.make_detection_train_step()
    losses, ms = [], []
    for _ in range(DET_REPEATS):
        sync()
        t0 = time.perf_counter()
        losses.append(step(state, batch, generator=m.landmark_loop.step_generator(42, 0))
                      ["loss_total"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    last = sum(losses[-5:]) / 5
    log(f"detector train step on one repeated batch of 4 (config_1 X101-32x8d FPN 800^2, bf16, SGD at a constant "
        f"{DET_REPEAT_LR}) on {card}: loss_total {[round(v, 6) for v in losses]}; first {losses[0]:.6f}, mean of "
        f"the last 5 {last:.6f} (must be lower); step {median(ms[5:]):.4f} ms (median of steps 6-{DET_REPEATS})")
    if not (all(math.isfinite(v) for v in losses) and last < losses[0]):
        raise RuntimeError(f"{DET_REPEATS} updates on one batch did not lower loss_total: {losses}")
    det_step_split(torch, m, state, batch, card)


def det_phase(torch, m, dev, card):
    """``tools.train_detector.train`` with ``--preset config_1`` at full
    width on the card; returns the rows of K2, K2's backward and K4 at
    N = 2000 on a train step's own inputs, and the run's launch counts."""
    import os
    import tempfile

    t0 = time.perf_counter()
    check_det_train_tiny_against_cpu(torch, m)
    with tempfile.TemporaryDirectory() as out_dir:
        train_json, train_ex = detection_scene(torch, m, dev, DET_TRAIN_FRAMES, 31, out_dir, "det_train")
        val_json, val_ex = detection_scene(torch, m, dev, DET_VAL_FRAMES, 32, out_dir, "det_val")
        args = m.train_detector.parse_args([
            "--preset", "config_1", "--train-json", train_json, "--val-json", val_json, "--image-dir", out_dir,
            "--output", os.path.join(out_dir, "run"), "--max-iter", str(DET_TRAIN_STEPS)])
        log(f"train_detector config: --preset config_1 (X101-32x8d FPN, {args.input_size}^2, batch "
            f"{args.batch_size}, ROI batch {m.train_detector.model_config(args).roi.batch_size_per_image}, pooler "
            f"{m.train_detector.model_config(args).roi.pooler_impl}, flip {args.flip}), SGD lr {args.lr} warmup "
            f"{args.solver.warmup_iters} momentum 0.9 weight decay 1e-4, bf16 over float32; {DET_TRAIN_FRAMES} "
            f"training and {DET_VAL_FRAMES} validation frames of {FRAME_HW[1]}x{FRAME_HW[0]}, {DET_TRAIN_STEPS} "
            f"steps (cut from {args.solver.max_iter}), one evaluation at the end")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases and the frames still hold
        steps = Timed(m.train_detector, "make_detection_train_step", factory=True, keep=True)
        det_cfg = m.train_detector.model_config(args)
        n_train, n_nms = args.batch_size * det_cfg.roi.batch_size_per_image, det_cfg.rpn.pre_nms_topk_train
        k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[1].shape[0] == n_train)
        k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[3].shape[0] == n_train)
        k4 = Capture(m.nms, "nms_mask_sorted", keep=lambda a: a[0].shape[1] == n_nms)
        with steps, k2, k2b, k4:
            reset_counts(m)
            t1 = time.perf_counter()
            trainer = m.train_detector.train(args, train_ex, val_ex, dev)
            sync()
            wall = time.perf_counter() - t1
            launches = read_counts(m)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state = trainer.state
        losses = [met["loss_total"].item() for met in steps.results]
        finite = all(math.isfinite(v) for v in losses) and all(
            bool(torch.isfinite(v).all()) for v in state.model.state_dict().values())
        ap = {k: v[0] for k, v in trainer.storage.latest().items() if k.startswith("bbox/")}
        step_ms = median(steps.ms[2:])
        log(f"train_detector (config_1 on {card}): {wall:.4f} s in all; train step {step_ms:.4f} ms (median of "
            f"steps 3-{DET_TRAIN_STEPS}; all {[round(v, 4) for v in steps.ms]}) = "
            f"{args.batch_size / step_ms * 1e3:.3f} "
            f"images/s; peak memory {peak_gb:.4f} GB (torch.cuda.max_memory_allocated; {held_gb:.4f} GB of it held "
            f"before the run); loss_total "
            f"{[round(v, 5) for v in losses]}; last metrics "
            f"{json.dumps({k: round(float(v), 6) for k, v in steps.results[-1].items()})}; EvalHook box AP at one "
            f"detection an image {json.dumps(ap)}; launches {json.dumps(launches)}")
        if not finite or len(losses) != DET_TRAIN_STEPS:
            raise RuntimeError(f"train_detector: a loss or a parameter is not finite: {losses}")
        for key in ("K2", "K2b", "K4"):
            if launches[key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the detector trainer")
        if "bbox/AP" not in ap:
            raise RuntimeError(f"the detector trainer's EvalHook reported no AP: {ap}")
        # the final checkpoint's .npz through the evaluation entry's loader
        npz = os.path.join(args.output, "checkpoints", str(state.step), "model.npz")
        loaded = m.evaluate.load_detector(npz, False, False, torch.bfloat16, dev)
        trained = {k: v for k, v in state.model.state_dict().items()}
        params_equal = all(torch.equal(v, trained[k]) for k, v in loaded.state_dict().items())
        same_cfg = m.rcnn.GeneralizedRCNN(loaded.config, dtype=torch.bfloat16, device=dev)
        same_cfg.load_state_dict(trained)
        batch = next(m.detection_dataset.detection_batches(val_ex, 4, (args.input_size, args.input_size),
                                                           train=False, augment=False, num_workers=0))
        with torch.no_grad():
            a, b = loaded(batch["image"]), same_cfg(batch["image"])
        box_err = (a["boxes"] - b["boxes"]).abs().max().item()
        log(f"train_detector: the final .npz ({os.path.getsize(npz)} bytes) through evaluate.load_detector: "
            f"parameters equal {params_equal}; detections on 4 validation frames {box_err} px from the trained "
            f"weights' in the loader's config (limit 0), valid equal {torch.equal(a['valid'], b['valid'])}")
        if not params_equal or box_err != 0 or not torch.equal(a["valid"], b["valid"]):
            raise RuntimeError(f"the trained detector's .npz gives other detections: {box_err}")
        del loaded, same_cfg
        k2_call, k2b_call, k4_call = k2.calls[-1], k2b.calls[-1], k4.calls[-1]
        rows = [pooler_row(torch, m, k2_call, f"roi_align_multilevel (train_detector config_1: {n_train} ROIs, "
                                              "windowed read window)"),
                pooler_backward_row(torch, m, k2b_call, f"roi_align_multilevel_backward (train_detector config_1: "
                                                        f"{n_train} ROIs, bf16 gradient)")]
        rows += nms_rows(torch, m, dev, [k4_call], "train_detector config_1: ")
        del k2, k2b, k4
        train_batch = next(m.detection_dataset.detection_batches(train_ex, 4, (args.input_size, args.input_size),
                                                                 flip=True, num_workers=0))
        del trainer, state
        torch.cuda.empty_cache()
        det_repeated_batch(torch, m, dev, args, train_batch, card)
    log(f"detector training phase: {time.perf_counter() - t0:.1f} s")
    return rows, launches


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
            "launches": launches[row.get("count", key)], "max_abs_err": err, "share_off": share,
            "ms": time_ms(row["run_k"], 10),
            "plain_ms": time_ms(row["run_p"], 2), "bound_ms": bound,
            "bound_by": bound_by, "bytes": nb, "ops": ops, "peak_ops_per_s": row["peak"],
            "library_ms": time_ms(row["run_lib"], 10) if row["run_lib"] is not None else None,
        }
        entry["device_ms"], entry["k"] = graph_ms(row["run_k"])
        if row["run_lib"] is not None and row.get("lib_graph", True):  # the yardstick's device time, as the kernel's
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


def load_port():
    """The port's modules the phases use, as one namespace ``m``, with
    ``m.kernels`` (kernel id -> (module, wrapper name, launch counter)) and
    ``m.counters``."""
    from spacecraft_pose_estimation_tpu_torch import _cuda, config, evaluate, models, pipeline, serving
    from spacecraft_pose_estimation_tpu_torch.data import camera
    from spacecraft_pose_estimation_tpu_torch.data import coco_io, detection_dataset, landmark_dataset
    from spacecraft_pose_estimation_tpu_torch.models import (
        backbone_int8, hrnet, hrnet_int8, layers, rcnn, resnet_backbone,
    )
    from spacecraft_pose_estimation_tpu_torch.models import discriminator
    from spacecraft_pose_estimation_tpu_torch.tools import (
        export_boxes, export_poses, test_landmarks, train_detector, train_landmarks, train_landmarks_da,
    )
    from spacecraft_pose_estimation_tpu_torch.train import adversarial, detection_state, landmark_loop, optim
    from spacecraft_pose_estimation_tpu_torch.train import state as train_state
    from spacecraft_pose_estimation_tpu_torch.ops import (
        geometry, heatmap, int8_blocks, int8_conv, nms, pnp, roi_align, warp,
    )

    m = SimpleNamespace(rcnn=rcnn, hrnet=hrnet, hrnet_int8=hrnet_int8, backbone_int8=backbone_int8, pnp=pnp,
                        geometry=geometry, pipeline=pipeline, serving=serving, warp=warp, roi_align=roi_align,
                        nms=nms, heatmap=heatmap, int8_conv=int8_conv, int8_blocks=int8_blocks, models=models,
                        layers=layers, camera=camera, evaluate=evaluate, resnet_backbone=resnet_backbone,
                        coco_io=coco_io, landmark_dataset=landmark_dataset, export_boxes=export_boxes,
                        test_landmarks=test_landmarks, export_poses=export_poses, landmark_loop=landmark_loop,
                        config=config, train_landmarks=train_landmarks, optim=optim, train_state=train_state,
                        train_landmarks_da=train_landmarks_da, adversarial=adversarial, discriminator=discriminator,
                        detection_dataset=detection_dataset, detection_state=detection_state,
                        train_detector=train_detector)
    # kernel id -> (module, wrapper name, launch counter)
    m.kernels = {
        "K1": (warp, "crop_bilinear", warp.KERNEL), "K2": (roi_align, "roi_align_multilevel", roi_align.KERNEL),
        "K2b": (roi_align, "roi_align_multilevel_backward", roi_align.BACKWARD),
        "K3": (roi_align, "roi_align_single", roi_align.SINGLE),
        "K4": (nms, "nms_mask_sorted", nms.KERNEL), "K5a": (int8_conv, "int8_conv", int8_conv.KERNEL),
        "K5": (int8_blocks, "basic_block_chain", int8_blocks.CHAIN),
        "K6": (int8_blocks, "bottleneck_chain", int8_blocks.BOTTLENECK),
        "K7": (int8_blocks, "up_exchange", int8_blocks.EXCHANGE),
    }
    m.counters = {key: k for key, (_, _, k) in m.kernels.items()} | {"K5a grouped": int8_conv.GROUPED}
    m._cuda = _cuda
    return m


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    m = load_port()
    _cuda, rcnn, hrnet, serving = m._cuda, m.rcnn, m.hrnet, m.serving
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    # full float32 wherever float32 runs (the serving models run bf16 and int8)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    import importlib.util

    log("optional packages the port's library path does without: " + json.dumps(
        {name: importlib.util.find_spec(name) is not None for name in ("cv2", "PIL", "pandas", "yaml")}))

    build_s = _cuda.build_all()
    log("build (s): " + json.dumps({k: round(v, 2) for k, v in build_s.items()}))
    check_tensor_core_sass(_cuda)
    check_pooler_coverage(torch, m)
    check_pooler_backward_tiles(torch, m)
    check_single_coverage(torch, m)
    check_nms_coverage(torch, m)
    check_tiny_against_cpu(torch, m)

    dev = torch.device("cuda")
    args = (rcnn.FASTER_RCNN_R101_SERVING_1OBJ, hrnet.POSE_HRNET_W32, FRAME_HW, 768, serving.SERVING_PIPELINE)
    launches, captures, run = serve(torch, m, dev, "bf16", *args, CLIPS, expect=("K1", "K2", "K4"))
    times = stage_times(torch, m, run)
    det = run.server.detector
    lb1 = m.serving.letterbox(run.frames[:1], 768)[0]
    r101 = dict(ms=times["detector: backbone+fpn"], images=DET_BATCH,
                flops_per_image=conv_flops(torch, m, [det.backbone, det.fpn], lambda: det.pyramid(lb1)))
    profile_clip(torch, run)
    report = kernel_report(float_rows(torch, m, dev, captures), launches)
    del run, captures, det

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
    del run, captures

    # bench.py's det_kind="x101" point: the X101 serving preset in bf16, GN PnP
    x101_args = (rcnn.FASTER_RCNN_X101_SERVING,) + args[1:]
    _, _, run = serve(torch, m, dev, "x101 bf16", *x101_args, 2, expect=("K1", "K2", "K4"))
    stage_times(torch, m, run)
    del run
    torch.cuda.empty_cache()

    eval_rows, eval_launches, scene = evaluate_phase(torch, m, dev, r101)
    report += kernel_report(eval_rows, eval_launches)
    staged_phase(torch, m, dev, scene)
    del scene
    torch.cuda.empty_cache()

    # bench.py's det_kind="x101_int8" point: the int8 ResNeXt backbone (K5a on
    # merged grouped convs), the int8 HRNet, GN PnP
    launches, _, run = serve(torch, m, dev, "x101 int8", *x101_args, 2, expect=("K1", "K2", "K4") + INT8_IDS)
    # at one group: the backbone's dense sites and the int8 HRNet's
    launches["K5a dense"] = launches["K5a"] - launches["K5a grouped"]
    log(f"x101 int8: K5a launches at a merged group count above 1 in the 2 served clips: "
        f"{launches['K5a grouped']} (33 conv2 sites a keyframe batch); at one group {launches['K5a dense']}")
    if launches["K5a grouped"] != 2 * 33:
        raise RuntimeError(f"x101 int8: {launches['K5a grouped']} grouped K5a launches in 2 clips, not 2 x 33")
    stage_times(torch, m, run)
    report += kernel_report(x101_conv_rows(torch, m, run), launches)
    del run
    torch.cuda.empty_cache()

    # tools/train_landmarks.py's events preset at full width, and K1 in its validation
    k1_row, train_launches = train_phase(torch, m, dev, card)
    report += kernel_report([k1_row], train_launches)
    torch.cuda.empty_cache()

    # the lightbox_cms / sunlamp_cms presets: tools/train_landmarks_da.py at full
    # width, K1 in its validation, and the evaluation entry on the CMS model
    for rows, launches in da_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
    torch.cuda.empty_cache()

    # tools/train_detector.py's config_1 at full width: K2, its backward and K4 at N = 2000
    report += kernel_report(*det_phase(torch, m, dev, card))

    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
