#!/usr/bin/env python3
"""Drive the PyTorch port's serving, evaluation, training, domain-adaptation, detector-training (Faster R-CNN and RetinaNet), weight import and export, Mask / Keypoint / Cascade R-CNN and FCOS, event-camera, DVS-training, detection-library (TTA, RegNet, deformable conv, rotated boxes, ASPP, tracker, trainer hooks, PreciseBN), int8-option (s2d, fused_even3, merge_fuse, fold), LazyConfig-training, tools (demo, benchmark, utils, data parallelism) and projects (PointRend, PointSup, DeepLab, Panoptic-DeepLab; DensePose, TridentNet, ViTDet, MViTv2, TensorMask, Rethinking-BN) paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit. It

1. builds the CUDA kernels of ``spacecraft_pose_estimation_tpu_torch/csrc``
   (one nvcc per source, in parallel) and reads the SASS of the four int8
   kernels K5a, K5, K6 and K7: integer tensor-core instructions (IGMMA),
   no dp4a;
2. holds K2 and its backward (``roi_align_multilevel_backward.cu``, in
   both read windows and in the gather read, which has none) to their
   plain versions on seeded boxes that the served proposals may not reach
   (every pyramid level, the image's edges, boxes larger than the read
   window, level boundaries; P 7 and 14; f32 and bf16 features, 256 and 16
   channels; the backward also on the 800^2
   pyramid, whose every level ends in partial tiles, with a level no box
   reaches and with no box at all, both exactly 0, and two calls equal
   bit for bit), K3 likewise on maps larger and smaller than its read window
   at spatial scales 0.25, 0.3 and 1/12 (boxes across every edge, larger
   than the window, zero-area, wholly outside the map; a CUDA call with 12
   channels must raise), and K4 exactly on seeded problems of 1, 63, 65,
   1024, 1025, 1500, 2000, 2048, 2049, 4096, 4441, 5000 and 8192 boxes
   with duplicates, ties, zero-area boxes and no valid box (8193 must
   raise);
   then checks the tiny detector + HRNet serving path on the card against
   the same path on the CPU (plain PyTorch versions of the kernels), in
   the bf16 form and in the int8 form with every fused route on, the
   latter also on a tiny grouped trunk (K5a on merged groups), and the
   PnP solvers against a known pose (RANSAC also with 3 of 11 points 200
   px off, and against the CPU on the same noise), and RANSAC on identical
   seeded keypoints (101 frames of 12 landmarks, half of them off) at 256
   and 512 hypotheses twice in the process and once in a fresh one: every
   step bit-equal, or the first that differs named;
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
14. moves weights in and out: builds from seeds, in the reference's
   names, an HRNet-W32 ``pose_hrnet`` ``.pth`` (11 joints, with
   ``num_batches_tracked``), the X101-32x8d FPN as a detectron2 ``.pth``
   and as a Caffe2 zoo ``.pkl`` (342 blobs, BN absorbed into scale and
   bias, the background class first); imports each with
   ``tools.import_weights`` (no leaf skipped; every imported tensor bit-equal
   to its source after the layout map, but final_layer under the
   PRETRAINED_LAYERS filter and FrozenBN mean/var from the ``.pkl``);
   resumes ``tools.train_detector --preset config_1`` from the imported
   detector for 2 steps (the resume logged at update 0, SGD at weight
   decay 1e-4 and momentum 0.9, losses finite, K2, K2b and K4 launched)
   and ``tools.train_landmarks`` (``events``, AUTO_RESUME) from the
   imported HRNet for one epoch of 2 steps with its validation (resumed at
   epoch 1, K1 launched); runs ``evaluate.run_scene`` on 8 frames with the
   imported detector's ``.npz`` and with the source's tensors loaded
   directly (boxes, keypoints and poses bit-equal; K2 and K4 launched);
   exports the HRNet back with ``tools.export_weights`` (keys and tensors
   the source's) and the pose pipeline with ``tools.export_model`` at the
   JAX defaults, which a fresh ``python3`` that imports only the port
   loads and runs on 8 seeded frames (keypoints within 1e-3 px of the
   eager pipeline's, poses finite, K1 launched once a call); K1 is held to
   its plain version on the program's own crop call (read there by a
   ``torch.fx.Interpreter``) and timed; the program's ms a batch is
   printed beside the eager pipeline's;
15. runs the heads: first ``RCNN_TINY`` with both heads, ``FCOS_TINY``
   and ``CascadeROIHeads`` in float32 on the card against the CPU
   (inference, 3 SGD updates, the cascade's gradients); then
   ``FASTER_RCNN_X101_SPACECRAFT`` with the mask and keypoint heads (11
   keypoints, ``mask_resolution`` 14) in bf16 at 800^2, batch 4: 3 SGD
   steps at config_1's solver on seeded polygons (their bitmasks and 11
   keypoints a box), inference on 8 frames, the masks pasted and the
   keypoints decoded into segm AP and keypoint AP; ``CascadeROIHeads`` on
   that model's pyramid and 1,000 proposals an image, forward and backward;
   ``FCOSConfig()`` (R50) in bf16 at 800^2, batch 4, FrozenBN calibrated, 4
   steps and one evaluation on 8 frames (K4 on 8 problems of 2,843); each
   path with its counters reset just before and read just after (K2 and
   K2b in the gather read counted apart, ``K2 gather`` / ``K2b gather``),
   K2 and K2b held to their plain versions on the paths' calls (K2b's bar
   shown to reject three wrong gradients) and K4 exactly, on FCOS's call
   and on boxes of its shape jittered around the GT boxes, where K4 must
   suppress;
16. trains RetinaNet: first ``RETINANET_TINY`` in float32 on the card
   against the CPU (3 EMA SGD updates on the same batch); then
   ``tools.train_detector.train`` with ``--preset config_20`` at full
   width (R101 RetinaNet at 800^2, batch 10, flips, SGD 1e-4 with warmup
   500, the EMA loss normalizer, bf16 activations over float32 weights,
   the seeded trunk's FrozenBN calibrated on a training batch) on 20
   seeded 1920x1200 frames, 6 steps (2 warm-up, 4 timed; cut from 20000)
   and one evaluation on 10 more, whose NMS is K4 on 10 problems of 4441
   candidates (K4's counter reset just before, read just after; K4 held to
   its plain version on that call as scored and with every candidate
   valid); checks the metrics and parameters finite, the final ``.npz``
   loaded into a fresh RetinaNet (0 apart) and that 8 updates on one
   repeated batch lower loss_total below its value after the first;
   prints the step ms, images/s, peak memory, the box AP, the step's
   split by CUDA events and a profiled step;
17. runs the event-camera half: first the ``noisy`` emulator at 48x64 on
   the card against the CPU on the same draws (at most 1e-4 of the event
   maps' entries flipped), chunks against one run on the card (bit-equal)
   and SuperSloMo at 96x64 against the CPU (1e-4); then ``tools.v2e`` at
   1280x720 (33 seeded source frames at 30 fps, SuperSloMo x4 with random
   weights, the ``clean`` preset, max_iters 8, chunks of 64, duration
   exposure 0.01 s: events > 0, event frames finite in [0, 1], events
   sorted on t; SloMo's weight load and first call in the command, then
   SloMo again on the command's weights and source frames, held to the
   command's frames within 1e-3 grey and timed warm by CUDA events with
   its conv FLOPs; emulator, dense-to-sparse and render times, a
   profiled frame step's launches, the peak memory); then a seeded
   346x260 stream under ``noisy`` written by ``tools.v2e`` as AEDAT2 and
   CSV recordings, through ``tools.evaluate_event_pipeline``
   (``convert_aedats``, 24 undistorted frames a scene, then ``evaluate``
   at its defaults from ``.npz`` weights made from seeds), its artifacts
   checked, the AEDAT2 scene equal to the CSV stream after microsecond
   truncation, K1, K2 and K4 launched (counters reset just before, read
   just after) and each held to its plain version on the phase's inputs;
18. trains on event frames: renders a synthetic scene
   (``tools.make_synthetic_scene``, 48 frames of 1280x720), writes its GT
   from a probe run of ``tools.v2e`` (``clean``, duration exposure 0.02 s),
   then runs ``tools.train_pipeline_dvs`` in process at that exposure:
   v2e, the split, the COCO conversion, the no-preset detector
   (X101-32x8d FPN at 768, batch 8, K2 in the Pallas read window, K2b,
   K4 at N = 2000) for 4 steps and the ``events`` preset (HRNet-W32) for
   one epoch with its validation (K1); the launch counters of K1, K2, K2b
   and K4 reset just before and read just after, each kernel held to its
   plain version on the pipeline's inputs; checks both trainers' losses
   finite and their ``.npz`` written, and every COCO annotation's box and
   12 keypoints; holds ``EVENT_STACK`` and ``SPEEDPLUS_STACK`` on two of
   its frames letterboxed to 768^2, the card against the CPU on the card's
   draws stage by stage (the event stages exact, the others within 1e-3
   grey, threshold flips counted against 1e-3 of the pixels), times both
   stacks, and runs 2 detector steps with ``--photometric-augs event``;
19. runs the rest of the detection library ("library"): TTA around
   ``config_1``'s X101-32x8d Faster R-CNN (bf16, 100 detections an image)
   on 8 seeded uint8 800^2 frames, scales 1.0 and 0.8 with the flip (four
   detector calls, the 640^2 views in float32, then one class-aware NMS,
   K4, on 8 x 400 candidates; K2 and K4 counters reset just before, read
   just after; K2 held to its plain version on the 640^2 view's box head
   and K4 exactly on the merge; the output as ``Instances``, counts equal
   to ``valid``); ``IouTracker`` over 16 jittered frames of its boxes (ids
   equal to the CPU's); RegNetX / RegNetY-400MF at 800^2, batch 4, bf16
   (timed, peak memory) and in float32 at 224^2 against the CPU (1e-4 of
   scale); ``deform_conv2d`` v2 on (4, 100, 100, 256) float32 with offsets
   of up to 3 px against the CPU (1e-4 of scale); rotated IoU and NMS (0.7)
   on 2,000 clustered boxes against the CPU (IoU 1e-5; keep-masks equal but
   where an IoU lies within 1e-6 of the threshold) and the rotated AP of 8
   images (1e-9); ASPP at DeepLabV3's widths against the CPU (1e-4 of
   scale); a ``Trainer`` of 6 ``config_1`` steps with ``TraceProfiler``
   (K2's and K4's kernels in the trace), ``MemoryStats`` (equal to
   ``memory_allocated``) and a ``BestCheckpointer`` (the best step in
   ``best/``), K2, K2b and K4 counted; and PreciseBN on the ``events``
   HRNet-W32 at 512^2 against the CPU (1e-3 of scale) and against itself;
20. serves the int8 R101 form of step 3 under each of the int8 HRNet's
   options ("int8 options"), 2 clips each, counters reset just before and
   read just after: O1 ``s2d`` (``build_int8_server`` calibrating its own
   trees with the space-to-depth twins; K5a's padded 4x4 entry, 2x2 downs
   and even3 3x3 convs), O2 ``s2d + fused_blocks + fused_even3`` (K5 on
   branch 0's 64x64x128 packed map), O3 ``merge_fuse`` (K5a with its
   per-channel clip), O4 ``fold=2`` (the backbone's and the HRNet's
   ``fold_residual`` and ``fold_fuse_up``: K5a's f32 epilogue); the HRNet's
   heatmaps on the served crops bit-equal to the card's per-op walk for
   O1-O3 and within the JAX package's fold bars for O4 (0.1 of scale,
   correlation 0.995); each form's HRNet timed beside the per-op walk (and
   O1's beside the served fused form); K5a's new routes and K5 on even3
   held to their plain versions on the served calls and timed; then
   ``tools.lazyconfig_train`` on a config file it writes (HRNet-W32, 11
   joints, 512^2 -> 128^2 synthetic batches of 8, Adam 1e-3, 10
   iterations): finite losses, and the checkpoint's ``.npz`` through
   ``evaluate.load_landmark_model`` giving the trained model's heatmaps;
21. runs the tools, the utils and data parallelism ("tools"):
   ``utils.memory.retry_if_oom`` on a real out-of-memory error (12 GiB a
   row of 8: the full call must raise ``torch.OutOfMemoryError``, the retry
   succeed at 2 or 4 parts and equal a direct call on them);
   ``tools.demo`` at ``pose_hrnet`` 512^2 (random weights saved through the
   port's ``CheckpointManager``) on a seeded 1920x1200 PNG with landmarks
   and calibration, as the command and as ``demo.run`` (K1 once a call,
   counters reset just before and read just after; keypoints within 1e-3
   px of ``make_pose_pipeline`` on the same frame, weights and generator; R
   and t finite; the overlay decodes), ``utils.vis.save_debug_images`` on
   its heatmaps, and K1 held to its plain version on the demo's crop;
   ``tools.benchmark`` on every task at the JAX tool's defaults (train and
   eval ``pose_hrnet`` 512^2 batch 32, train-det ``config_1`` 800^2 batch 4,
   which must launch K2, K2b and K4, data on 32 seeded PNGs);
   ``utils.analysis`` (``model_summary`` of HRNet-W32; ``flops_of`` of the
   R101 backbone + FPN at 768^2 equal to ``conv_flops``); ``parallel`` with
   NCCL at world size 1 (a ``data_parallel`` step of ``HRNET_TINY`` equal to
   the plain step within 1e-6, a sharded ``RCNN_TINY`` forward equal to the
   unsharded one with K2 and K4 launched, the world-1 gathers);
   ``collect_env_info``, whose device row must name the card;
22. runs the projects ("projects"): first their tiny paths in float32 on
   the card against the CPU (PointRend's standard, implicit and semantic
   heads with the CPU's top-k selections fed to the card, PointSup on K2's
   and K2b's gather read, DeepLabV3+ and both Panoptic-DeepLab heads on
   ``DEEPLAB_TINY``: outputs, losses and gradients within 1e-3 of scale;
   ``get_panoptic_segmentation`` on the CPU's outputs equal); then
   PointRend on ``config_1``'s X101-32x8d FPN (bf16, seeded, FrozenBN
   calibrated, 100 detections an image) at 800^2, batch 4: the detections
   (K2, K4; counters reset just before, read just after),
   ``PointRendMaskHead(PointRendConfig())`` (28 -> 3 steps -> 224^2) and the
   implicit head (28 -> 5 steps -> 896^2) on P2, and 3 SGD steps of each
   head's point loss on the GT boxes and masks; PointSup
   (``cascade.MaskHead`` pooled by K2's gather read at P 14, 3 SGD steps of
   ``mask_rcnn_point_sup_loss`` on 10 points an instance, K2b's gather read
   in the backward); DeepLabV3+ R103-OS16 (3 SGD steps under
   ``warmup_poly_schedule`` on 2 crops of 512x1024, inference at 1024x2048)
   with ``PointRendSemSegHead`` at its defaults (one step, one inference);
   Panoptic-DeepLab R52-OS16 (3 Adam steps on 4 crops whose targets
   ``PanopticTargetGenerator`` makes, inference at 1024x2048,
   ``get_panoptic_segmentation`` at its defaults on the heads' outputs and
   on the frame's targets, equal to the CPU's); K2 and K4 held to their
   plain versions on the detector's inference, K2 and K2b on PointSup's
   calls;
23. runs the last projects ("projects c"): first their tiny paths in
   float32 on the card against the CPU (DensePose on both routes with the
   chart loss and its gradients through K2b, TridentNet's stage, ViTDet,
   MViTv2, both BNConvTower variants, swap_align2nat: within 1e-3 of
   scale; the branch merge through K4 and the chart labels of the CPU's
   outputs equal); then DensePose (``DensePoseConfig()``) on ``config_1``'s
   X101-32x8d FPN (bf16, seeded, FrozenBN calibrated, 100 detections an
   image) at 800^2, batch 4: the decoder route (K2's gather read on the
   merged stride-4 map, P 28, 400 ROIs) and ``chart_result_for_grid``, the
   route without the decoder (K2's gather read on P2-P5), the DeepLab head,
   and 3 SGD steps of the decoder and head on 32 instances x 128 points a
   frame (K2b's gather read in the backward); TridentNet-R101's res4 (23
   blocks) on 2 frames' res3, every branch and branch 1, and the branch
   merge on 4 x 3 x 100 jittered detections (K4); ViTDet-B + FPN(256) at
   1024^2, batch 2, and MViTv2-B at 1024^2, batch 1 (forward and one
   backward); BNConvTower (256 x 4) on P3-P7, both variants, train and
   eval; swap_align2nat on (2, 15, 15, 100, 100) at lambda 2; K2 (one
   level and four) and K2b held to their plain versions on DensePose's
   calls, K4 on the merge's; each path's counters reset just before it and
   read just after;
24. prints the card, a ``{"kernels": [...]}`` line and, last, the result
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


_LAST_LOGGED = [""]  # shown on standard error if the script fails
PHASE_READINGS: dict[str, float] = {}  # numbers one phase logs for a later one to put beside its own


def log(msg: str) -> None:
    print(msg, flush=True)
    _LAST_LOGGED[0] = msg


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


HEALTH_FIELDS = "driver_version,ecc.errors.uncorrected.volatile.total,ecc.errors.corrected.volatile.total"


def card_health() -> str:
    """The driver's version and the card's ECC error counts since its last
    reset, to read a fault by; a diagnostic that never raises."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={HEALTH_FIELDS}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return f"{HEALTH_FIELDS}: {(out.stdout or out.stderr).strip()}"
    except Exception as e:  # it is printed beside the failure, never in its place
        return f"nvidia-smi {HEALTH_FIELDS}: {e}"


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def kernel_sync(what: str) -> None:
    """Wait for the kernel just launched and name it if it faulted. A fault
    on the card is raised by the first later call that waits for the
    device, often the plain version checked beside the kernel, so the
    coverage checks wait here, before and after each launch."""
    import torch

    try:
        torch.cuda.synchronize()
    except Exception as e:
        raise RuntimeError(f"{what} faulted on the card: {e}") from e


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


RANSAC_REPEAT_FRAMES, RANSAC_REPEAT_POINTS = 101, 12  # the DVS accuracy run's test split and landmarks
RANSAC_REPEAT_HYPOTHESES = (256, 512)  # the evaluation entry's, the staged export_poses'
RANSAC_STEPS = ("gumbel", "valid", "hypothesis R", "hypothesis t", "hypothesis errors", "R", "t", "inliers")


def ransac_repeat_inputs(torch, m):
    """101 frames of a 12-landmark body under seeded poses, 2 px of noise
    and about half the landmarks 40-150 px off (as a landmark model that
    learned only some of them gives them), seeded confidences; on the card:
    world, px, K, dist, conf."""
    g = torch.Generator().manual_seed(13)
    b, n = RANSAC_REPEAT_FRAMES, RANSAC_REPEAT_POINTS
    world = torch.randn(n, 3, generator=g) * 0.6
    R = m.geometry.quat_to_dcm(torch.randn(b, 4, generator=g))
    t = torch.cat([torch.randn(b, 2, generator=g) * 0.3, 8 + 4 * torch.rand(b, 1, generator=g)], -1)
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    dist = torch.tensor(EVAL_DIST)
    px = m.geometry.project_points(world, R, t, K, dist) + torch.randn(b, n, 2, generator=g) * 2
    off = (torch.rand(b, n, 1, generator=g) < 0.5) * torch.sign(torch.randn(b, n, 2, generator=g))
    px = px + off * (40 + 110 * torch.rand(b, n, 2, generator=g))
    conf = 0.2 + 0.8 * torch.rand(b, n, generator=g)
    return [x.cuda() for x in (world, px, K, dist, conf)]


def ransac_repeat_trace(torch, m, hypotheses: int) -> dict:
    """The port's ``pnp_ransac`` on ``ransac_repeat_inputs`` with its own
    draw (generator 0 on the card), and its steps: the Gumbel noise that
    draw gives, the confidence mask, each hypothesis's EPnP pose and every
    point's error under it; then the entry's R, t and inliers. {step: CPU
    tensor}, in ``RANSAC_STEPS`` order."""
    world, px, K, dist, conf = ransac_repeat_inputs(torch, m)
    b, n = px.shape[:2]
    with torch.inference_mode():
        gumbel = m.pnp.gumbel_noise((b, hypotheses, n), torch.Generator(device="cuda").manual_seed(0), "cuda")
        valid = m.pnp.adaptive_confidence_mask(conf, min_count=15)
        Rs, ts, errs = m.pnp.ransac_hypotheses(world.expand(b, n, 3), px, K, dist, valid, gumbel, 6)
        out = m.pnp.pnp_ransac(world, px, K, dist, conf, num_hypotheses=hypotheses)
    steps = (gumbel, valid, Rs, ts, errs, out["R"], out["t"], out["inliers"])
    return {k: v.cpu() for k, v in zip(RANSAC_STEPS, steps)}


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:  # NaNs included, bit for bit
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def check_ransac_repeats(torch, m) -> None:
    """RANSAC PnP on identical keypoints on the card: ``ransac_repeat_trace``
    at 256 and 512 hypotheses twice in this process and once in a fresh
    one. Every step must be equal bit for bit; else the first step that
    differs is named and the run fails."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fresh.pt")
        code = ("import sys, torch\n"
                f"sys.path.insert(0, {root!r})\n"
                "import chip_smoke as cs\n"
                "m = cs.load_port()\n"
                f"torch.save({{h: cs.ransac_repeat_trace(torch, m, h) for h in {RANSAC_REPEAT_HYPOTHESES!r}}}, "
                f"{path!r})\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the fresh RANSAC process failed: {proc.stderr[-2000:]}")
        fresh = torch.load(path, weights_only=True)
    for h in RANSAC_REPEAT_HYPOTHESES:
        first = ransac_repeat_trace(torch, m, h)
        runs = {"a second call in this process": ransac_repeat_trace(torch, m, h), "a fresh process": fresh[h]}
        for label, other in runs.items():
            differ = [k for k in RANSAC_STEPS if not same_bits(first[k], other[k])]
            log(f"RANSAC on identical keypoints ({RANSAC_REPEAT_FRAMES} frames x {RANSAC_REPEAT_POINTS} landmarks, "
                f"{h} hypotheses) against {label}: steps differing {differ or 'none'}; poses finite "
                f"{bool(torch.isfinite(first['R']).all() and torch.isfinite(first['t']).all())}, inliers "
                f"{int(first['inliers'].sum())}")
            if differ:
                raise RuntimeError(f"RANSAC at {h} hypotheses gives other results on identical inputs in {label}: "
                                   f"first differing step {differ[0]!r} (all: {differ})")
    log(f"RANSAC repeat gate: {time.perf_counter() - t0:.1f} s")


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
    the read window, three boxes on level boundaries; every read (the two
    windows and the gather's whole level), at P = 7 (the box heads', the
    cascade's) and 14 (the mask and keypoint heads'); f32 and bf16
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
    for impl, p, dtype, c in itertools.product(m.roi_align.READS, (7, 14), (torch.float32, torch.bfloat16),
                                               (256, 16)):
        feats = [torch.randn(n_img, POOLER_SIZE // s, POOLER_SIZE // s, c, generator=gen).to(boxes.device, dtype)
                 for s in POOLER_STRIDES]
        args = (feats, boxes, batch_idx, p, POOLER_STRIDES)
        kw = dict(sampling_ratio=2, window=POOLER_WINDOW, impl=impl)
        case = f"{impl} read, P {p}, {dtype} features, C {c}"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the window-coverage warning: these boxes exceed it on purpose
            sync()
            got = m.roi_align.roi_align_multilevel(*args, **kw)
            kernel_sync(f"K2 on the coverage boxes ({case})")
            want = m.roi_align.roi_align_multilevel_plain(*args, **kw)
        sync()
        err, share, ok = compare(got, want, None)
        log(f"K2 coverage, {case}: max_abs_err {err:.3g} of scale {want.abs().max().item():.3g}, share off "
            f"{share:.3g} (limit 1e-5 of the scale)")
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version on the coverage boxes ({case}): {err}")
        grad_out = torch.randn(r, p, p, c, generator=gen).cuda()
        shapes = [tuple(f.shape) for f in feats]
        bargs = (grad_out, shapes, dtype, boxes, batch_idx, p, POOLER_STRIDES, 2, POOLER_WINDOW, 224.0, 4, impl)
        sync()
        got = m.roi_align.roi_align_multilevel_backward(*bargs)
        kernel_sync(f"K2b on the coverage boxes ({case})")
        want = m.roi_align.roi_align_multilevel_backward_plain(*bargs)
        sync()
        scale = max(w.float().abs().max().item() for w in want)
        limit = pooler_grad_limit(dtype, scale)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        same_dtype = all(g.dtype == dtype for g in got)
        log(f"K2 backward coverage, {case}: max_abs_err {err:.3g} of scale {scale:.3g} (limit {limit:.3g}); per "
            f"level P2..P5 nonzero cells {[int((g != 0).any(-1).sum()) for g in got]}")
        if err > limit or not same_dtype:
            raise RuntimeError(f"K2's backward disagrees with the plain gradient ({case}): {err}")
        if dtype == torch.bfloat16 and c == 256:  # the same through autograd
            leaves = [f.detach().requires_grad_() for f in feats]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m.roi_align.roi_align_multilevel(leaves, boxes, batch_idx, p, POOLER_STRIDES, **kw).backward(grad_out)
            kernel_sync(f"K2 and K2b through autograd ({impl} read, P {p}, bf16, C 256)")
            auto = max((f.grad.float() - w.float()).abs().max().item() for f, w in zip(leaves, want))
            log(f"K2 backward through autograd ({impl} read, P {p}, bf16, C 256): max_abs_err {auto:.3g} "
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
    for impl, dtype, c in itertools.product(m.roi_align.READS, (torch.float32, torch.bfloat16), (256, 16)):
        shapes = [(n_img, TILED_SIZE // s, TILED_SIZE // s, c) for s in POOLER_STRIDES]
        grad_all = torch.randn(r, 7, 7, c, generator=gen).cuda()
        for case, (bx, bi) in cases.items():
            grad_out = grad_all[no_p4] if case == "no box on P4" else grad_all[:bx.shape[0]].contiguous()
            bargs = (grad_out, shapes, dtype, bx, bi, 7, POOLER_STRIDES, 2, POOLER_WINDOW, 224.0, 4, impl)
            sync()
            got = m.roi_align.roi_align_multilevel_backward(*bargs)
            again = m.roi_align.roi_align_multilevel_backward(*bargs)
            kernel_sync(f"K2b on the tiling boxes, {case} ({impl}, {dtype}, C {c})")
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
                    sync()
                    got = ra.roi_align_single(*args)
                    kernel_sync(f"K3 on a {h}x{w} map at scale {scale} ({dtype}, C {c})")
                    want = ra.roi_align_single_plain(*args)
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


NMS_COVERAGE_N = (1, 63, 65, 1024, 1025, 1500, 2000, 2048, 2049, 4096, 4441, 5000, 8192)


def check_nms_coverage(torch, m) -> None:
    """K4 exact against its plain version at N = 1, 63, 65 and 1024 (edges
    of its 64-bit words and its largest problem with 128 KB of mask in
    shared memory), 1025, 1500, 2000 (the RPN's in training), 2048 (the
    last with one removed-word a lane of the walking warp), 2049, 4096,
    4441 (RetinaNet's five levels at 800^2; 3 words a lane), 5000 (the most
    RetinaNet gives at any size) and 8192 (4 words a lane, the most), the
    mask in the global workspace above 1024, with duplicates, ties,
    zero-area boxes and an all-invalid problem, at IoU thresholds 0, 0.5 and
    0.99; a problem of 8193 boxes must raise."""
    gen = torch.Generator().manual_seed(5)
    for n in NMS_COVERAGE_N:
        boxes, valid = (t.cuda() for t in nms_edge_problems(torch, n, 4, gen))
        for thresh in (0.0, 0.5, 0.99):
            sync()
            got = m.nms.nms_mask_sorted(boxes, valid, thresh)
            kernel_sync(f"K4 at N {n}, IoU {thresh}")
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
    """K5a call: bytes (x, w, m, b and lo read once, out written once) and
    int8 ops (2 per multiply-add, the packed weights' zeros included: the
    space-to-depth convs do that work)."""
    x, w = a["x"], a["w"]
    k = w.shape[0]
    pad_y, pad_x = m.int8_conv.conv_padding(k, a.get("padding"))
    ho = m.int8_conv.out_size(x.shape[1], k, a["stride"], pad_y)
    wo = m.int8_conv.out_size(x.shape[2], k, a["stride"], pad_x)
    out = x.shape[0] * ho * wo * w.shape[3] * (4 if a["out_f32"] else 1)
    lo = [a["lo"]] if a.get("lo") is not None else []
    return nbytes(x, w, a["m"], a["b"], *lo) + out, 2.0 * x.shape[0] * ho * wo * w.shape[3] * k * k * w.shape[2]


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
    (top, bottom), (left, right) = a.get("padding") or ((k // 2, k // 2), (k // 2, k // 2))
    xp = F.pad(x, (0, 0, left, right, top, bottom))
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


def profile_counts(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device's kernel time
    (``busy_us``), the call's wall time, its kernel launches and the host's
    ATen operator calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"busy_us": sum(e.self_device_time_total for e in kernels), "wall_us": wall_us,
            "kernel_launches": sum(e.count for e in kernels),
            "aten_calls": sum(e.count for e in events if e.key.startswith("aten::"))}


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


def pooler_row(torch, m, call, name, count="K2"):
    """K2's row on one captured call; ``count``: the launch counter its
    ``launches`` reads (``"K2 gather"`` for the gather read's calls)."""
    pool_args, pool_kwargs = call
    *pool_totals, tap_bytes = pooler_numbers(torch, m.roi_align, pool_args, pool_kwargs)
    return dict(id="K2", name=name, count=count,
                source="spacecraft_pose_estimation_tpu_torch/csrc/roi_align_multilevel.cu",
                replaces="spacecraft_pose_estimation_tpu/ops/pallas_pooler.py:135",
                run_k=lambda: m.roi_align.roi_align_multilevel(*pool_args, **pool_kwargs),
                run_p=lambda: m.roi_align.roi_align_multilevel_plain(*pool_args, **pool_kwargs),
                run_lib=pooler_library_call(torch, m.roi_align, pool_args, pool_kwargs), tol=None,
                peak=FP32_FLOPS, numbers=tuple(pool_totals), extra={"tap_load_bytes": tap_bytes})


def nms_pairs(keep, valid) -> float:
    """The IoUs greedy NMS needs on these inputs: each kept box against
    the valid boxes after it in its own problem (padding and earlier boxes
    take none)."""
    after = valid.flip(1).cumsum(1).flip(1) - valid.long()  # valid boxes j > i
    return float((after * (keep & valid)).sum())


def nms_row(torch, m, dev, nms_args, name):
    """K4's row on one call's arguments (boxes, valid, threshold). Its bound
    counts 15 operations an IoU pair that greedy NMS needs (``nms_pairs``)."""
    try:
        import torchvision.ops as tv_ops  # a yardstick only: the port never calls it
    except ImportError:
        tv_ops = None
    boxes, valid, thresh = nms_args
    p, n = valid.shape
    keep = m.nms.nms_mask_sorted_plain(boxes, valid, thresh)
    kept = float(keep.sum())
    pairs = nms_pairs(keep, valid)
    lib = None
    if tv_ops is not None:
        idxs = torch.arange(p, device=dev)[:, None].expand(p, n)[valid]
        order = torch.arange(n, 0, -1, device=dev, dtype=torch.float32)[None].expand(p, n)[valid]
        lib = (lambda b=boxes[valid], s=order, i=idxs, th=thresh: tv_ops.batched_nms(b, s, i, th))
    return dict(id="K4", name=name, source="spacecraft_pose_estimation_tpu_torch/csrc/nms_mask_sorted.cu",
                replaces="spacecraft_pose_estimation_tpu/ops/pallas_nms.py:67",
                run_k=lambda a=nms_args: m.nms.nms_mask_sorted(*a),
                run_p=lambda a=nms_args: m.nms.nms_mask_sorted_plain(*a),
                run_lib=lib, tol=0.0, peak=FP32_FLOPS, numbers=(p * n * (16 + 1 + 1), pairs * 15.0),
                extra={"valid": int(valid.sum()), "kept": int(kept), "iou_pairs": int(pairs)})


def nms_rows(torch, m, dev, calls, label):
    """K4's rows on a detector call's two captured calls: the RPN's, then the box head's."""
    rows = []
    for i, (nms_args, _) in enumerate(calls):
        p, n = nms_args[1].shape
        rows.append(nms_row(torch, m, dev, nms_args, f"nms_mask_sorted ({label}{'rpn' if i == 0 else 'box head'} "
                                                     f"{p}x{n})"))
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
    """Multiply-adds x 2 of every port Conv or ``nn.Conv2d`` inside ``modules`` during ``run()``."""
    total = [0.0]

    def hook(mod, inputs, out):
        k = mod.weight.shape[-1]
        total[0] += 2.0 * out.numel() * mod.weight.shape[1] * k * k

    handles = [c.register_forward_hook(hook) for mod in modules for c in mod.modules()
               if isinstance(c, (m.layers.Conv, torch.nn.Conv2d))]
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
    evaluate phase's frames (kept on the card, so no frame goes through a
    file; cv2 does import on the card's machine, as the "optional
    packages" line of every run logs) and
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
    log(f"K2b bar's controls on the row's call: max_abs_err {json.dumps(errs)} (each must exceed the limit "
        f"{limit:.3g})")
    for k, err in errs.items():
        if not err > limit:
            raise RuntimeError(f"K2b's bar {limit} cannot tell a wrong gradient ({k}: {err}) from the right one")
    return errs


def pooler_backward_row(torch, m, call, name, count="K2b"):
    """K2's backward row on one captured call: held to the plain autograd
    gradient within ``pooler_grad_limit`` of its own scale, a bar shown to
    reject wrong gradients (``pooler_grad_controls``); its library
    yardstick is the backward of ``F.grid_sample`` + ``F.avg_pool2d`` under
    autograd. ``count`` as ``pooler_row``'s."""
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
    log(f"K2b on the row's call ({name}): two calls equal bit for bit {same}")
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
    return dict(id="K2b", name=name, count=count,
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
    frozen parameters' zero gradients, RetinaNet's EMA rescale, the gradient
    norm); SGD. Then torch.profiler over one more step. A RetinaNet state
    takes its step: no sampling draws, the EMA loss normalizer; an FCOS
    state no sampling draws; a Mask / Keypoint R-CNN's batch carries its
    heads' GT."""
    model, opt = state.model, state.optimizer
    retina = isinstance(model, m.retinanet.RetinaNet)
    rcnn = isinstance(model, m.rcnn.GeneralizedRCNN)
    b = batch["image"].shape[0]
    if retina:
        name, what, preset = "RetinaNet", f"R101 RetinaNet 800^2, batch {b}", "config_20"
    elif not rcnn:
        name, what, preset = "FCOS", f"R50 FCOS 800^2, batch {b}", "FCOSConfig()"
    elif model.config.with_mask or model.config.with_keypoints:
        name, what, preset = ("Mask and Keypoint R-CNN", f"X101-32x8d FPN with both heads 800^2, batch {b}",
                              "FASTER_RCNN_X101_SPACECRAFT with heads")
    else:
        name, what, preset = "detector", f"X101-32x8d FPN 800^2, batch {b}", "config_1"
    label = f"{name} train step ({preset}, batch {b})"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def between(fn, first: int, last: int):
        def call(*args, **kwargs):
            ev[first].record()
            out = fn(*args, **kwargs)
            ev[last].record()
            return out

        return call

    step = m.detection_state.make_detection_train_step(needs_sampling_rng=rcnn, ema_loss_normalizer=retina)
    run = lambda: step(state, batch, generator=m.landmark_loop.step_generator(42, 0))
    spans = []
    model.losses, opt.step = between(model.losses, 0, 1), between(opt.step, 2, 3)
    try:
        for _ in range(3):
            run()
            sync()
            spans.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    finally:
        del model.losses, opt.step  # the instance's wrappers: the class's methods again
    fwd, bwd, sgd = spans[-1]
    log(f"{name} train step split by CUDA events ({what}) on {card} (all "
        f"{[[round(v, 4) for v in r] for r in spans]}): losses forward {fwd:.4f} ms, backward {bwd:.4f} ms, "
        f"SGD {sgd:.4f} ms")
    profile_call(torch, run, label)


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
    PHASE_READINGS["config_1 repeated-batch step ms"] = median(ms[5:])
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


BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
C2_BRANCH = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c", "shortcut": "branch1"}
WEIGHTS_DET_FRAMES, WEIGHTS_DET_STEPS, WEIGHTS_LM_FRAMES, WEIGHTS_EVAL_FRAMES = 8, 2, 48, 8
WEIGHTS_LANDMARK_MODEL, X101_C2_BLOBS = "pose_hrnet", 342  # the events preset's model; the X101 zoo pickle's blobs
EXPORT_SIZES = ("--image-size", "512", "512", "--frame-size", "1920", "1200")  # tools/export_model.py's defaults
EXPORT_REPS = 5


def hrnet_reference_name(key: str) -> str:
    """A port HRNet state-dict key -> its name in the reference's ``pose_hrnet``
    (``lib/models/pose_hrnet.py``), re-derived here from the module layout."""
    *path, kind, leaf = key.split(".")
    if path == []:  # final_layer.{weight,bias}
        return key
    tail = "weight" if kind == "conv" else BN_LEAVES[leaf]
    pos = "0" if kind == "conv" else "1"
    head = path[0]
    if head.startswith("stem"):
        return f"{'conv' if kind == 'conv' else 'bn'}{head[-1]}.{tail}"
    if head.startswith("transition"):
        unit = path[1]
        if unit.startswith("adapt"):
            return f"{head}.{unit[5:]}.{pos}.{tail}"
        i, j = unit[3:].split("_")
        return f"{head}.{i}.{j}.{pos}.{tail}"
    if head == "layer1":
        base, rest = f"layer1.{path[1][5:]}", path[2:]
    else:
        s, mod = head[5:].split("_m")
        if path[1] == "fuse":
            idx = path[2][2:] if path[2].startswith("up") else path[2][4:]
            return f"stage{s}.{mod}.fuse_layers.{'.'.join(idx.split('_'))}.{pos}.{tail}"
        base, rest = f"stage{s}.{mod}.branches.{path[1][6:]}.{path[2][5:]}", path[3:]
    if rest[0] == "down":
        return f"{base}.downsample.{pos}.{tail}"
    return f"{base}.{'conv' if kind == 'conv' else 'bn'}{rest[0][4:]}.{tail}"


def hrnet_reference_state(torch, model) -> dict:
    """``model``'s tensors under the reference's names, each BN with its
    ``num_batches_tracked``, as a torch checkpoint holds them."""
    out = {}
    for key, v in model.state_dict().items():
        name = hrnet_reference_name(key)
        out[name] = v.detach().clone()
        if name.endswith(".running_var"):
            out[name.removesuffix("running_var") + "num_batches_tracked"] = torch.tensor(1000)
    return out


def d2_reference_state(torch, det, p: int = 7) -> dict:
    """The X101 detector's tensors under detectron2's GeneralizedRCNN names;
    fc1 back to the NCHW flatten of d2's ``FastRCNNConvFCHead``."""
    out = {}
    for key, v in det.state_dict().items():
        mods, v = key.split("."), v.detach().clone()
        if mods[0] == "backbone":
            blk = mods[1]
            pre = ("backbone.bottom_up.stem.conv1" if blk == "stem"
                   else f"backbone.bottom_up.res{blk[3]}.{blk.split('_b')[1]}.{mods[2]}")
            out[pre + (".weight" if mods[-2] == "conv" else ".norm." + BN_LEAVES[mods[-1]])] = v
        elif mods[0] == "fpn":
            unit = mods[1]
            name = f"fpn_lateral{unit[-1]}" if unit.startswith("lateral") else f"fpn_output{unit[-1]}"
            out[f"backbone.{name}.{mods[2]}"] = v
        elif mods[0] == "rpn_head":
            unit = {"conv": "conv", "objectness": "objectness_logits", "deltas": "anchor_deltas"}[mods[1]]
            out[f"proposal_generator.rpn_head.{unit}.{mods[2]}"] = v
        elif mods[1] == "box_head":
            if mods[2] == "fc1" and mods[3] == "weight":
                v = v.reshape(v.shape[0], p, p, -1).permute(0, 3, 1, 2).reshape(v.shape[0], -1).contiguous()
            out[key] = v
        else:  # roi_heads.predictor.{cls_score,bbox_pred}
            out[f"roi_heads.box_predictor.{mods[2]}.{mods[3]}"] = v
    return out


def c2_reference_blobs(torch, det, d2: dict, gen) -> tuple[dict, dict]:
    """The X101 detector as a Caffe2 zoo ``.pkl``'s blobs (Caffe2 names, BN
    absorbed into scale and bias, the background class first and its 4
    deltas in ``bbox_pred``, fc6 in the NCHW flatten) -> (blobs, the port
    state dict the import must give: FrozenBN mean and var at 0 and 1)."""
    import numpy as np

    blobs, want = {}, {k: v.detach().clone() for k, v in det.state_dict().items()}
    sd = det.state_dict()
    last_block = {}  # each stage's last block: the FPN blobs are named after it
    for key in sd:
        if key.startswith("backbone.res"):
            s, i = key.split(".")[1][3:].split("_b")
            last_block[int(s)] = max(last_block.get(int(s), 0), int(i))
    for key, v in sd.items():
        mods, leaf = key.split("."), key.split(".")[-1]
        if mods[0] == "backbone":
            blk = mods[1]
            unit = "conv1" if blk == "stem" else f"res{blk[3]}_{blk.split('_b')[1]}_{C2_BRANCH[mods[2]]}"
            prefix = "res_conv1" if blk == "stem" else unit
            if mods[-2] == "conv":
                blobs[f"{unit}_w"] = v.numpy().copy()
            elif leaf == "scale":  # absorb: s = scale / sqrt(var + eps), b = bias - mean * s
                norm = key.removesuffix("scale")
                s = (sd[norm + "scale"].double() * torch.rsqrt(sd[norm + "var"].double() + 1e-5)).float()
                b = (sd[norm + "bias"].double() - sd[norm + "mean"].double() * s.double()).float()
                blobs[f"{prefix}_bn_s"], blobs[f"{prefix}_bn_b"] = s.numpy(), b.numpy()
                want[norm + "scale"], want[norm + "bias"] = s, b
                want[norm + "mean"], want[norm + "var"] = torch.zeros_like(s), torch.ones_like(s)
        elif mods[0] == "fpn":
            s = int(mods[1][-1])
            tag = (f"fpn_inner_res{s}_{last_block[s]}_sum" + ("_lateral" if s < 5 else "")
                   if mods[1].startswith("lateral") else f"fpn_res{s}_{last_block[s]}_sum")
            blobs[f"{tag}_{leaf[0]}"] = v.numpy().copy()
        elif mods[0] == "rpn_head":
            tag = {"conv": "conv_rpn_fpn2", "objectness": "rpn_cls_logits_fpn2", "deltas": "rpn_bbox_pred_fpn2"}
            blobs[f"{tag[mods[1]]}_{leaf[0]}"] = v.numpy().copy()
        elif mods[1] == "box_head":
            tag = {"fc1": "fc6", "fc2": "fc7"}[mods[2]]
            blobs[f"{tag}_{leaf[0]}"] = d2[key].numpy().copy()
        elif mods[2] == "cls_score":  # the background class first
            blobs[f"cls_score_{leaf[0]}"] = torch.cat([v[-1:], v[:-1]]).numpy()
        else:  # bbox_pred: 4 deltas of the background class first
            bg = torch.randn((4, *v.shape[1:]), generator=gen)
            blobs[f"bbox_pred_{leaf[0]}"] = torch.cat([bg, v]).numpy()
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in blobs.items()}, want


def perturb_frozen_bn(torch, m, det, gen) -> None:
    """FrozenBN statistics off their 0/1 start (scale and bias near 1 and 0,
    mean N(0, 0.1), var U(0.5, 1.5)): a checkpoint's, whose every leaf
    then tells a misplaced one."""
    with torch.no_grad():
        for mod in det.modules():
            if isinstance(mod, m.resnet_backbone.FrozenBN):
                n = mod.scale.numel()
                mod.scale.add_(0.05 * torch.randn(n, generator=gen))
                mod.bias.add_(0.05 * torch.randn(n, generator=gen))
                mod.mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.var.copy_(0.5 + torch.rand(n, generator=gen))


class LogLines(contextlib.AbstractContextManager):
    """Collect the messages of the loggers ``names`` while active."""

    def __init__(self, *names):
        import logging

        self.loggers = [logging.getLogger(n) for n in names]
        self.lines = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.lines.append(record.getMessage())

        self.handler = Handler(level=logging.INFO)

    def __enter__(self):
        import logging

        for lg in self.loggers:
            lg.addHandler(self.handler)
            self.levels = getattr(self, "levels", []) + [lg.level]
            lg.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        for lg, level in zip(self.loggers, self.levels):
            lg.removeHandler(self.handler)
            lg.setLevel(level)


def imported_state(torch, ck_dir: str) -> dict:
    import os

    return torch.load(os.path.join(ck_dir, "0", "state.pt"), map_location="cpu", weights_only=True)["model"]


def differing(got: dict, want: dict, skip=()) -> list[str]:
    """The keys of ``want`` whose tensor in ``got`` is missing or differs by a bit."""
    import torch

    return [k for k, v in want.items() if not k.startswith(skip)
            and (k not in got or got[k].dtype != v.dtype or not torch.equal(got[k], v))]


def check_import(report: dict, label: str, want_mapped: int, want_ignored: int, seconds: float, paths) -> None:
    import os

    sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
    log(f"import_weights {label}: {report['sources']} entries, {report['mapped']} leaves loaded (want "
        f"{want_mapped}), {len(report['skipped'])} skipped {report['skipped'][:5]}, {report['ignored']} ignored "
        f"(want {want_ignored}); {seconds:.3f} s; sizes (bytes) {json.dumps(sizes)}")
    if report["skipped"] or report["mapped"] != want_mapped or report["ignored"] != want_ignored:
        raise RuntimeError(f"import_weights {label}: unexpected leaves: {report}")


EXPORT_RUNNER = r'''
import json, sys, time
import torch
import spacecraft_pose_estimation_tpu_torch.ops.warp as warp

inputs, program_path, out_path, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
inp = torch.load(inputs, map_location="cuda")
t0 = time.perf_counter()
program = torch.export.load(program_path).module()
load_s = time.perf_counter() - t0
warp.KERNEL.launches = 0
t0 = time.perf_counter()
out = program(inp["frames"], inp["boxes"])
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(reps):
    program(inp["frames"], inp["boxes"])
end.record()
torch.cuda.synchronize()
ms = start.elapsed_time(end) / reps
launches = warp.KERNEL.launches
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    program(inp["frames"], inp["boxes"])
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
events = prof.key_averages()
kernels = [e for e in events if e.device_type == DeviceType.CUDA]
profiled = {"busy_us": sum(e.self_device_time_total for e in kernels), "wall_us": wall_us,
            "kernel_launches": sum(e.count for e in kernels),
            "aten_calls": sum(e.count for e in events if e.key.startswith("aten::"))}
seen = []


class Recorder(torch.fx.Interpreter):
    def call_function(self, target, args, kwargs):
        if target is torch.ops.spe_port.crop_bilinear.default:
            seen.append(args)
        return super().call_function(target, args, kwargs)


Recorder(program).run(inp["frames"], inp["boxes"])
frames, params, out_w, out_h = seen[0]
torch.save({"out": [o.cpu() for o in out], "params": params.cpu(), "out_size": (out_w, out_h),
            "frames_are_input": frames.data_ptr() == inp["frames"].data_ptr()}, out_path)
print(json.dumps({"load_s": load_s, "first_s": first_s, "ms": ms, "launches": launches, "calls": 1 + reps,
                  "profiled": profiled,
                  "jax_imported": "jax" in sys.modules, "modules_of_the_jax_package":
                  [n for n in sys.modules if n.split(".")[0] == "spacecraft_pose_estimation_tpu"]}))
'''


def weights_phase(torch, m, dev, card):
    """Weights in and out at full width: synthetic reference files from seeds
    (HRNet-W32 ``pose_hrnet`` ``.pth`` for the events preset's 11 joints,
    the X101-32x8d FPN as a detectron2 ``.pth`` and as a Caffe2 zoo
    ``.pkl`` of 342 blobs) through ``tools.import_weights``, each imported
    tensor bit-equal to its source; ``tools.train_detector --preset
    config_1`` resumed from the imported detector for 2 steps (K2, K2b, K4;
    the trainer's weight decay 1e-4 and momentum 0.9 kept) and
    ``tools.train_landmarks`` (``events``, AUTO_RESUME) from the imported
    HRNet for one epoch with its validation (K1); ``evaluate.run_scene``
    with the imported detector, boxes bit-equal to the source's;
    ``tools.export_weights`` bit-equal to the source; ``tools.export_model``
    at the JAX defaults, loaded in a fresh process (K1 launched once a
    call there, keypoints within 1e-3 px of the eager pipeline's). Returns
    K1's row on the exported program's own crop inputs and its launches in
    that process."""
    import os
    import pickle
    import shutil
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(41)
    with tempfile.TemporaryDirectory() as d:
        # a. the sources, on the host
        t0 = time.perf_counter()
        hr_src = m.models.build_landmark_model(WEIGHTS_LANDMARK_MODEL, NUM_JOINTS, device="cpu",
                                               generator=torch.Generator().manual_seed(42))
        hr_sd = hrnet_reference_state(torch, hr_src)
        det_src = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, device="cpu",
                                         generator=torch.Generator().manual_seed(43))
        perturb_frozen_bn(torch, m, det_src, gen)
        d2_sd = d2_reference_state(torch, det_src)
        blobs, pkl_want = c2_reference_blobs(torch, det_src, d2_sd, gen)
        paths = {"hrnet": os.path.join(d, "hrnet_w32.pth"), "d2": os.path.join(d, "model_final.pth"),
                 "pkl": os.path.join(d, "model_final.pkl")}
        torch.save(hr_sd, paths["hrnet"])
        torch.save({"model": d2_sd, "iteration": 0}, paths["d2"])
        with open(paths["pkl"], "wb") as f:
            pickle.dump({"model": blobs, "__author__": "Caffe2", "matching_heuristics": True}, f)
        n_frozen = sum(isinstance(mod, m.resnet_backbone.FrozenBN) for mod in det_src.modules())
        log(f"weights sources: pose_hrnet {len(hr_sd)} entries ({sum(k.endswith('num_batches_tracked') for k in hr_sd)}"
            f" num_batches_tracked), detectron2 {len(d2_sd)}, Caffe2 {len(blobs)} blobs ({n_frozen} FrozenBN); "
            f"{time.perf_counter() - t0:.3f} s to build and write")
        if len(blobs) != X101_C2_BLOBS:
            raise RuntimeError(f"the X101 zoo pickle has {len(blobs)} blobs, not {X101_C2_BLOBS}")

        # b. import
        outs = {key: os.path.join(d, f"{key}_import") for key in paths}
        reports, import_s = {}, {}
        for key, argv in (("hrnet", ["--kind", "hrnet", "--model", WEIGHTS_LANDMARK_MODEL, "--num-joints",
                                     str(NUM_JOINTS)]),
                          ("d2", ["--kind", "detectron2"]), ("pkl", ["--kind", "detectron2"])):
            t0 = time.perf_counter()
            reports[key] = m.import_weights.main(["--torch-checkpoint", paths[key], "--output", outs[key], *argv])
            import_s[key] = time.perf_counter() - t0
        hr_keys, det_keys = hr_src.state_dict(), det_src.state_dict()
        n_batches = sum(k.endswith("num_batches_tracked") for k in hr_sd)
        ck = lambda key: [paths[key], os.path.join(outs[key], "0", "state.pt"), os.path.join(outs[key], "0", "model.npz")]
        check_import(reports["hrnet"], "pose_hrnet (PRETRAINED_LAYERS)", len(hr_keys) - 2, n_batches + 2,
                     import_s["hrnet"], ck("hrnet"))
        check_import(reports["d2"], "detectron2 .pth", len(det_keys), 0, import_s["d2"], ck("d2"))
        check_import(reports["pkl"], "Caffe2 .pkl", len(det_keys) - 2 * n_frozen, 0, import_s["pkl"], ck("pkl"))
        bad = {"hrnet": differing(imported_state(torch, outs["hrnet"]), hr_keys, skip=("final_layer",)),
               "d2": differing(imported_state(torch, outs["d2"]), det_keys),
               "pkl": differing(imported_state(torch, outs["pkl"]), pkl_want)}
        log(f"import_weights: tensors not bit-equal to their source after the layout map: "
            f"{json.dumps({k: v[:5] for k, v in bad.items()})} (limit none; final_layer left out by the filter)")
        if any(bad.values()):
            raise RuntimeError(f"an imported tensor differs from its source: {bad}")
        del blobs, pkl_want, d2_sd

        # c. resume on the card from copies of the imports: the detector (config_1) and the landmarks (events)
        shutil.copytree(outs["d2"], os.path.join(d, "det_run", "checkpoints"))
        shutil.copytree(outs["hrnet"], os.path.join(d, "lm", "checkpoints"))
        train_json, train_ex = detection_scene(torch, m, dev, WEIGHTS_DET_FRAMES, 31, d, "w_det")
        args = m.train_detector.parse_args([
            "--preset", "config_1", "--train-json", train_json, "--image-dir", d,
            "--output", os.path.join(d, "det_run"), "--max-iter", str(WEIGHTS_DET_STEPS)])
        steps = Timed(m.train_detector, "make_detection_train_step", factory=True, keep=True)
        with steps, LogLines("train_detector") as lines:
            reset_counts(m)
            t0 = time.perf_counter()
            trainer = m.train_detector.train(args, train_ex, None, dev)
            sync()
            det_s = time.perf_counter() - t0
            launches = read_counts(m)
        groups = trainer.state.optimizer.inner.param_groups
        hyper = sorted({(g["weight_decay"], g["momentum"]) for g in groups})
        losses = [met["loss_total"].item() for met in steps.results]
        log(f"train_detector --preset config_1 resumed from the imported detector on {card}: {det_s:.3f} s, "
            f"steps {[round(v, 4) for v in steps.ms]} ms, loss_total {[round(v, 5) for v in losses]}; log "
            f"{[l for l in lines.lines if 'resumed' in l]}; SGD (weight_decay, momentum) {hyper} (want "
            f"[(0.0001, 0.9)]; the import saved weight_decay 0); launches {json.dumps(launches)}")
        if "resumed at update 0" not in lines.lines or hyper != [(1e-4, 0.9)]:
            raise RuntimeError(f"train_detector did not resume from the import with its own hyperparameters: "
                               f"{lines.lines}, {hyper}")
        if len(losses) != WEIGHTS_DET_STEPS or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"train_detector from the import: losses {losses}")
        for key in ("K2", "K2b", "K4"):
            if launches[key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the resumed detector trainer")
        del trainer, steps, train_ex
        torch.cuda.empty_cache()

        cfg = m.config.apply_overrides(m.config.get_preset("events"),
                                       ["TRAIN.END_EPOCH", "2", "TRAIN.AUTO_RESUME", "True"])
        lm_train = landmark_scene(torch, m, dev, WEIGHTS_LM_FRAMES, 11, d, "w_lm_train")
        lm_val = landmark_scene(torch, m, dev, TRAIN_VAL_FRAMES, 12, d, "w_lm_val")
        with LogLines("train_landmarks") as lines:
            reset_counts(m)
            t0 = time.perf_counter()
            state = m.train_landmarks.train(cfg, lm_train, os.path.join(d, "lm"), dev, lm_val)
            sync()
            lm_s = time.perf_counter() - t0
            lm_launches = read_counts(m)
        resumed = [l for l in lines.lines if l.startswith("resumed")]
        log(f"train_landmarks (events, AUTO_RESUME) from the imported HRNet on {card}: {lm_s:.3f} s, {state.step} "
            f"updates, log {resumed} (want epoch 1, as the JAX trainer: meta.get('epoch', 0) + 1); launches "
            f"{json.dumps(lm_launches)}")
        if resumed != ["resumed from step 0 (epoch 1)"] or state.step != WEIGHTS_LM_FRAMES // cfg.train.batch_size_per_chip:
            raise RuntimeError(f"train_landmarks did not resume from the import at epoch 1: {resumed}, {state.step}")
        if lm_launches["K1"] == 0:
            raise RuntimeError("kernel K1 was not launched by the resumed trainer's validation")
        del state, lm_train, lm_val
        torch.cuda.empty_cache()

        # d. the imported detector through the evaluation entry, against the source's tensors loaded directly
        hr = m.evaluate.load_landmark_model(os.path.join(outs["hrnet"], "0", "model.npz"), WEIGHTS_LANDMARK_MODEL,
                                            NUM_JOINTS, torch.bfloat16, dev)
        lm3d = np.random.default_rng(2).normal(0, 0.8, (NUM_JOINTS, 3))
        cam = m.camera.CameraModel(K=np.array([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]]),
                                   dist=np.array(EVAL_DIST), width=FRAME_HW[1], height=FRAME_HW[0])
        frames = torch.randint(0, 256, (WEIGHTS_EVAL_FRAMES, *FRAME_HW, 3), dtype=torch.uint8, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(44))
        names = [f"w{i:04d}.png" for i in range(WEIGHTS_EVAL_FRAMES)]
        size = int(EXPORT_SIZES[1])
        config = m.pipeline.PipelineConfig(image_size=(size, size), solver="gn")
        det_imported = m.evaluate.load_detector(os.path.join(outs["d2"], "0", "model.npz"), False, False,
                                                torch.bfloat16, dev)
        det_direct = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, dtype=torch.bfloat16, device=dev)
        det_direct.load_state_dict(det_keys)
        results = {}
        for label, det in (("imported", det_imported), ("direct", det_direct)):
            with tempfile.TemporaryDirectory() as out_dir:
                reset_counts(m)
                results[label] = m.evaluate.run_scene(frames, names, out_dir, det, hr, lm3d, cam,
                                                      batch_size=WEIGHTS_EVAL_FRAMES, input_size=EVAL_SIZE,
                                                      config=config)
                results[label + " launches"] = read_counts(m)
        same = all(np.array_equal(results["imported"][k], results["direct"][k]) for k in ("boxes", "preds", "R", "t"))
        log(f"evaluate.run_scene with the detector of the imported .npz and with the source's tensors loaded "
            f"directly ({WEIGHTS_EVAL_FRAMES} frames of {FRAME_HW[1]}x{FRAME_HW[0]}): boxes, keypoints and poses "
            f"bit-equal {same}; first box {results['imported']['boxes'][0].tolist()}; launches "
            f"{json.dumps(results['imported launches'])}")
        if not same:
            raise RuntimeError("the imported detector's evaluation differs from the source's")
        for key in ("K2", "K4"):
            if results["imported launches"][key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the evaluation of the imported detector")
        del det_imported, det_direct, results
        torch.cuda.empty_cache()

        # e. export: the weights back to the reference's names, and the pose pipeline as a program
        t0 = time.perf_counter()
        out_pth = os.path.join(d, "exported", "pose_hrnet.pth")
        m.export_weights.main(["--checkpoint", outs["hrnet"], "--model", WEIGHTS_LANDMARK_MODEL, "--num-joints",
                               str(NUM_JOINTS), "--output", out_pth])
        export_w_s = time.perf_counter() - t0
        exported = torch.load(out_pth, weights_only=True)
        want_keys = {k for k in hr_sd if not k.endswith("num_batches_tracked")}
        bad = differing(exported, {k: v for k, v in hr_sd.items() if k in want_keys}, skip=("final_layer",))
        log(f"export_weights: {len(exported)} tensors ({os.path.getsize(out_pth)} bytes) in {export_w_s:.3f} s; keys "
            f"equal the source's less num_batches_tracked {set(exported) == want_keys}; not bit-equal "
            f"{bad[:5]} (final_layer is the import's own: the filter)")
        if set(exported) != want_keys or bad:
            raise RuntimeError(f"export_weights gives other keys or tensors: {bad[:5]}")

        lm_csv, calib = os.path.join(d, "landmarks.csv"), os.path.join(d, "calibration.json")
        with open(lm_csv, "w") as f:
            f.write("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in lm3d.tolist()))
        with open(calib, "w") as f:
            json.dump({"intrinsics": {"camera_matrix": cam.K.tolist(), "distortion_coefficients": list(EVAL_DIST)}}, f)
        program_path = os.path.join(d, "pose.pt2")
        argv = ["--checkpoint", outs["hrnet"], "--landmarks-file", lm_csv, "--calibration-file", calib,
                "--model", WEIGHTS_LANDMARK_MODEL, *EXPORT_SIZES, "--output", program_path]
        t0 = time.perf_counter()
        m.export_model.main(argv)
        export_m_s = time.perf_counter() - t0
        rng = np.random.default_rng(45)
        wh = rng.uniform(200, 600, (WEIGHTS_EVAL_FRAMES, 2))
        xy = rng.uniform(0, 1, (WEIGHTS_EVAL_FRAMES, 2)) * (np.array([FRAME_HW[1], FRAME_HW[0]]) - wh)
        boxes = torch.tensor(np.concatenate([xy, wh], 1), dtype=torch.float32, device=dev)
        inputs = os.path.join(d, "inputs.pt")
        torch.save({"frames": frames, "boxes": boxes}, inputs)
        prog = m.export_model.build_program(m.export_model.build_parser().parse_args(argv), dev)
        eager = m.pipeline.make_pose_pipeline(prog.model, prog.lm3d, prog.K, prog.dist, prog.config)
        want = eager(frames, boxes)
        eager_ms = time_ms(lambda: eager(frames, boxes), EXPORT_REPS)
        eager_profiled = profile_counts(torch, lambda: eager(frames, boxes))
        out_path = os.path.join(d, "outputs.pt")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EXPORT_RUNNER, inputs, program_path, out_path, str(EXPORT_REPS)],
                              cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                              timeout=600)
        fresh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"the exported program failed in a fresh process:\n{proc.stderr[-4000:]}")
        ran = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(out_path, weights_only=True)
        kp_err = (got["out"][0] - want["keypoints"].cpu()).abs().max().item()
        finite = all(bool(torch.isfinite(o).all()) for o in got["out"][2:])
        log(f"export_model ({WEIGHTS_LANDMARK_MODEL} bf16 at {size}, GN, batch {WEIGHTS_EVAL_FRAMES} of {FRAME_HW[1]}x{FRAME_HW[0]} "
            f"uint8) on {card}: export and save {export_m_s:.3f} s, {os.path.getsize(program_path)} bytes; in a fresh "
            f"process ({fresh_s:.3f} s in all): load {ran['load_s']:.3f} s, first call {ran['first_s']:.3f} s, "
            f"{ran['ms']:.4f} ms a batch (CUDA events over {EXPORT_REPS} calls) against the eager pipeline's "
            f"{eager_ms:.4f} ms here; K1 launches {ran['launches']} in {ran['calls']} calls; JAX imported "
            f"{ran['jax_imported']}, modules of the JAX package {ran['modules_of_the_jax_package']}; keypoints "
            f"{kp_err} px from the eager pipeline's (limit 1e-3); R, t, quat finite {finite}")
        log(f"export_model: one profiled call (profiler on) of the exported program {json.dumps(ran['profiled'])}, "
            f"of the eager pipeline {json.dumps(eager_profiled)} (busy_us: the device's kernel time; aten_calls: "
            f"the host's ATen operator calls)")
        if kp_err > 1e-3 or not finite or ran["launches"] != ran["calls"] or ran["jax_imported"] \
                or ran["modules_of_the_jax_package"] or not got["frames_are_input"]:
            raise RuntimeError(f"the exported program disagrees with the eager pipeline or missed K1: {ran}")
        call = ((frames, got["params"].to(dev), tuple(got["out_size"])), {})
        row = crop_row(torch, m, dev, call, f"crop_bilinear (export_model: the exported program's call in a fresh "
                                            f"process, batch {WEIGHTS_EVAL_FRAMES}, {size}^2 crops)")
        del prog, eager, want, hr, frames
    torch.cuda.empty_cache()
    log(f"weights phase: {time.perf_counter() - t_phase:.1f} s")
    return [row], {"K1": ran["launches"]}


# ---------------------------------------------------------------------------
# the heads: Mask / Keypoint R-CNN on the X101 detector, Cascade R-CNN's ROI
# heads and FCOS, with K2 and K2b in the gather read and K4 on FCOS's NMS
# ---------------------------------------------------------------------------

HEADS_HW, HEADS_BATCH, HEADS_STEPS, HEADS_EVAL_FRAMES, FCOS_STEPS = 800, 4, 3, 8, 4
HEADS_KEYPOINTS, HEADS_GT = 11, 2  # the spacecraft's landmarks; GT slots an image (the second in every other image)
HEADS_LR = 1e-4  # config_1's solver: SGD, momentum 0.9, weight decay 1e-4
TINY_HEADS = dict(with_mask=True, with_keypoints=True, num_keypoints=4, mask_resolution=7)
BOX_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid")


def heads_scene(torch, m, dev, n: int, seed: int) -> dict:
    """n seeded HEADS_HW x HEADS_HW raw 0-255 float32 images on ``dev``: dim
    noise and one bright star-shaped polygon (5-9 vertices), two in every
    other image; the batch of a Mask / Keypoint R-CNN step: ``gt_boxes``
    (the polygons' bounds, padded to HEADS_GT), ``gt_classes`` 0,
    ``gt_valid``, ``gt_masks`` (``polygon_to_bitmask``) and HEADS_KEYPOINTS
    visible keypoints in each box."""
    import numpy as np

    hw, num_kps, slots = HEADS_HW, HEADS_KEYPOINTS, HEADS_GT
    rng = np.random.default_rng(seed)
    images = torch.randint(0, 48, (n, hw, hw, 3), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed)).float()
    boxes, valid = np.zeros((n, slots, 4), np.float32), np.zeros((n, slots), bool)
    kps = np.zeros((n, slots, num_kps, 3), np.float32)
    masks = torch.zeros((n, slots, hw, hw), dtype=torch.bool, device=dev)
    for i in range(n):
        for j in range(min(slots, 1 + i % 2)):
            v = int(rng.integers(5, 10))
            ang = np.sort(rng.uniform(0, 2 * np.pi, v))
            rad = rng.uniform(0.04 * hw, 0.2 * hw, v)
            cx, cy = rng.uniform(0.25 * hw, 0.75 * hw, 2)
            poly = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1).astype(np.float32)
            masks[i, j] = m.masks.polygon_to_bitmask(torch.from_numpy(poly).to(dev), hw, hw)
            colour = torch.tensor(rng.integers(180, 256, 3).tolist(), dtype=torch.float32, device=dev)
            images[i][masks[i, j]] = colour
            (x0, y0), (x1, y1) = poly.min(0), poly.max(0)
            boxes[i, j], valid[i, j] = (x0, y0, x1, y1), True
            kps[i, j, :, 0] = rng.uniform(x0, x1, num_kps)
            kps[i, j, :, 1] = rng.uniform(y0, y1, num_kps)
            kps[i, j, :, 2] = 2.0
    to = lambda a: torch.from_numpy(a).to(dev)
    return {"image": images, "gt_boxes": to(boxes), "gt_valid": to(valid), "gt_masks": masks,
            "gt_classes": torch.zeros((n, slots), dtype=torch.int32, device=dev), "gt_keypoints": to(kps)}


def tiny_updates(torch, m, model, batch, steps: int = 3, sampling: bool = True, starts=None):
    """``steps`` SGD updates (lr DET_TINY_LR, momentum 0.9, weight decay
    1e-4) of ``model`` on ``batch`` through ``make_detection_train_step``,
    the draws of step i from a CPU generator seeded 100 + i (the same on
    every device): the metrics, the final state dict on the CPU and the
    training state (model, momentum, step) before each update, copied to
    the CPU. Given another run's ``starts``, update i starts from its
    entry i instead of from this run's update i - 1, so that each update
    is held to that run's from the same state."""
    opt = m.optim.build_optimizer("sgd", model.parameters(), m.optim.multistep_schedule(DET_TINY_LR, [2]),
                                  weight_decay=1e-4, momentum=0.9)
    state = m.detection_state.DetTrainState(model, opt)
    step = m.detection_state.make_detection_train_step(needs_sampling_rng=sampling)
    mets, before = [], []
    for i in range(steps):
        if starts is not None:
            state.load_state_dict(starts[i])
        before.append(tree_to_cpu(state.state_dict()))
        mets.append({k: v.item() for k, v in step(state, batch, generator=torch.Generator().manual_seed(100 + i)).items()})
    return mets, {k: v.detach().cpu() for k, v in model.state_dict().items()}, before


def tree_to_cpu(tree):
    """A copy of a state dict, its tensors (nested in dicts and lists) on the CPU."""
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_cpu(v) for v in tree]
    return tree.detach().to("cpu", copy=True) if hasattr(tree, "detach") else tree


def updates_agree(torch, runs, what: str) -> str:
    """The tiny detector check's bars on a card run against a CPU run of
    ``tiny_updates``: losses and grad norms within 1e-4 relative, the
    parameters within 1 lr, at most 1% of them beyond 1e-3 lr; raises
    otherwise and returns the log's text."""
    (mc, sc, _), (mg, sg, _) = runs["cpu"], runs["cuda"]
    rel = lambda k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-6) for a, b in zip(mc, mg))
    per_loss = {k: float(f"{rel(k):.3g}") for k in mc[0] if k.startswith("loss")}
    loss_err, gn_err = max(per_loss.values()), rel("grad_norm")
    dp = torch.cat([((sg[k] - v).abs() / DET_TINY_LR).flatten() for k, v in sc.items()])
    share = (dp > 1e-3).float().mean().item()
    text = (f"{what}: loss_total {[round(a['loss_total'], 6) for a in mg]}, losses relative err {loss_err:.3g} "
            f"(limit 1e-4; by loss {json.dumps(per_loss)}), grad norms {gn_err:.3g} (limit 1e-4), parameters max "
            f"{dp.max().item():.3g} lr (limit 1), share beyond 1e-3 lr {share:.3g} (limit 0.01) of {dp.numel()}")
    if not (loss_err <= 1e-4 and gn_err <= 1e-4 and dp.max().item() <= 1.0 and share <= 0.01):
        raise RuntimeError(f"{what} differ between the card and the CPU: {text}")
    return text


def outputs_agree(got: dict, want: dict, what: str, scaled=(), exact=("valid", "classes")) -> str:
    """Card outputs against the CPU's: ``exact`` keys equal, boxes within
    1e-3 px, scores within 1e-5, each ``scaled`` key within 1e-4 of its
    scale; raises otherwise and returns the log's text."""
    errs, ok = {}, True
    for k in exact:
        errs[k] = int((got[k].cpu() != want[k]).sum())
        ok &= errs[k] == 0
    for k, limit in [("boxes", 1e-3), ("scores", 1e-5)] + [(k, None) for k in scaled]:
        if k not in want:
            continue
        w = want[k].float()
        errs[k] = (got[k].cpu().float() - w).abs().max().item()
        ok &= errs[k] <= (limit if limit is not None else 1e-4 * max(w.abs().max().item(), 1e-6))
    text = f"{what}: max errors {json.dumps({k: float(v) for k, v in errs.items()})}"
    if not ok:
        raise RuntimeError(f"{what} differ between the card and the CPU: {text}")
    return text


def check_heads_tiny_against_cpu(torch, m) -> None:
    """The heads' tiny paths in float32 (TF32 off) on the card (K2 and K2b
    in the gather read, K4) against the CPU (their plain versions), from the
    same seeded weights on the same batch and draws: ``RCNN_TINY`` with both
    heads (4 keypoints, ``mask_resolution`` 7) and ``FCOS_TINY``, inference
    (valid and classes equal, boxes within 1e-3 px, scores 1e-5, the heads'
    logits 1e-4 of their scale) and 3 SGD updates at the tiny detector
    check's bars (``updates_agree``), both at that check's ``freeze_at=2``:
    at 0 the updates move the trunk so far that a perturbation of 1e-6 of
    the weights alone, on the CPU, moves the third update's loss_cls by 2.9%
    (the R-CNN with heads) and the grad norm by 9e-5 (FCOS). Each card
    update starts from the CPU's state before that update (weights,
    momentum, step), so the updates' rounding does not compound: on the
    CPU a perturbation of 1e-7 of the weights alone moves the R-CNN with
    heads' third grad norm by 3e-5 (ReLU kinks among the keypoint head's
    8 x 512 convs flip), and on the card the chained updates read 3.7e-5 to
    1.2e-4 against the 1e-4 bar over five runs;
    ``CascadeROIHeads`` (fc 16, C 16) on seeded levels and boxes: its scores
    1e-5, boxes 1e-3 px, and the gradients of its parameters and of the
    levels 1e-4 of their scale."""
    import dataclasses

    import numpy as np

    det_batch = tiny_det_batch(torch)
    rng = np.random.default_rng(9)
    g = det_batch["gt_boxes"].shape[1]
    masks = torch.zeros(2, g, 64, 64, dtype=torch.bool)
    kps = torch.zeros(2, g, 4, 3)
    for b in range(2):
        for j in range(2):
            x0, y0, x1, y1 = (int(v) for v in det_batch["gt_boxes"][b, j])
            masks[b, j, y0 + 2:y1, x0:x1 - 3] = True
            kps[b, j, :, 0] = torch.from_numpy(rng.uniform(x0 - 2, x1, 4))
            kps[b, j, :, 1] = torch.from_numpy(rng.uniform(y0, y1, 4))
            kps[b, j, :, 2] = torch.tensor([2.0, 2.0, 1.0, 0.0])
    heads_batch = {**det_batch, "gt_masks": masks, "gt_keypoints": kps}
    frozen = lambda c: dataclasses.replace(c, backbone=dataclasses.replace(c.backbone, freeze_at=2))
    cfg, fcfg = frozen(dataclasses.replace(m.rcnn.RCNN_TINY, **TINY_HEADS)), frozen(m.fcos.FCOS_TINY)
    inf, runs, finf, fruns = {}, {}, {}, {}
    for device in ("cpu", "cuda"):
        det = m.rcnn.GeneralizedRCNN(cfg, device=device, generator=torch.Generator().manual_seed(0))
        fcos = m.fcos.FCOS(fcfg, device=device, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():  # tests/test_torch_detection_train.py's conditioning: a small stem, tame heads
            det.backbone.stem.conv.weight.mul_(1e-2)
            fcos.backbone.stem.conv.weight.mul_(1e-2)
            gen = torch.Generator().manual_seed(7)
            heads = det.roi_heads.predictor
            for lin in (det.rpn_head.deltas, heads.bbox_pred, heads.cls_score):
                lin.weight.copy_(0.05 * torch.randn(lin.weight.shape, generator=gen))
            inf[device] = det(det_batch["image"].to(device))
            finf[device] = fcos(det_batch["image"].to(device))
        # the card's update i from the CPU's state before it (the CPU runs first)
        runs[device] = tiny_updates(torch, m, det, {k: v.to(device) for k, v in heads_batch.items()},
                                    starts=runs["cpu"][2] if "cpu" in runs else None)
        fruns[device] = tiny_updates(torch, m, fcos, {k: det_batch[k].to(device) for k in BOX_KEYS}, sampling=False,
                                     starts=fruns["cpu"][2] if "cpu" in fruns else None)
    log("tiny heads, card vs CPU (f32): " + outputs_agree(
        inf["cuda"], inf["cpu"], "RCNN_TINY with both heads, inference", scaled=("mask_logits", "keypoint_logits")))
    log("tiny heads, card vs CPU (f32): " + updates_agree(torch, runs, "RCNN_TINY with both heads (freeze_at 2), 3 "
                                                                       "SGD updates"))
    if not all(a["loss_mask"] > 0 and a["loss_keypoint"] > 0 for a in runs["cuda"][0]):
        raise RuntimeError(f"the tiny heads trained on no ROI: {runs['cuda'][0]}")
    log("tiny heads, card vs CPU (f32): " + outputs_agree(finf["cuda"], finf["cpu"], "FCOS_TINY, inference"))
    log("tiny heads, card vs CPU (f32): " + updates_agree(torch, fruns, "FCOS_TINY (freeze_at 2), 3 SGD updates"))
    # the cascade on seeded levels and boxes, forward and backward
    base = m.roi_heads.ROIHeadsConfig(num_classes=1, cls_agnostic_bbox_reg=True, fc_dim=16)
    levels = {f"p{i + 2}": torch.randn(2, 32 >> i, 48 >> i, 16, generator=torch.Generator().manual_seed(11 + i))
              for i in range(4)}
    boxes = coverage_boxes(torch, 40, 192, torch.Generator().manual_seed(12)).reshape(2, 20, 4)
    strides = {f"p{i + 2}": 4 << i for i in range(4)}
    got = {}
    for device in ("cpu", "cuda"):
        cascade = m.cascade.CascadeROIHeads(m.cascade.CascadeConfig(base=base), 16, device=device,
                                            generator=torch.Generator().manual_seed(13))
        feats = {k: v.to(device).detach().requires_grad_() for k, v in levels.items()}
        scores, out = cascade(feats, boxes.to(device), strides, (128, 192))
        weigh = torch.Generator().manual_seed(14)  # the scores' rows sum to 1: a plain sum has no gradient there
        ws, wb = (torch.randn(x.shape, generator=weigh).to(device) for x in (scores, out))
        ((scores * ws).sum() + 1e-2 * (out * wb).sum()).backward()
        got[device] = {"scores": scores.detach().cpu(), "boxes": out.detach().cpu(),
                       **{f"grad {k}": p.grad.cpu() for k, p in cascade.named_parameters() if p.grad is not None},
                       # a level no box pools from gets no gradient from CPU autograd, zeros from K2b
                       **{f"grad {k}": (torch.zeros_like(v) if v.grad is None else v.grad).cpu()
                          for k, v in feats.items()}}
    log("tiny heads, card vs CPU (f32): " + outputs_agree(
        got["cuda"], got["cpu"], "CascadeROIHeads (fc 16, C 16), 40 boxes, forward and backward", exact=(),
        scaled=[k for k in got["cpu"] if k.startswith("grad")]))


def heads_rows_train(torch, m, dev, card):
    """Mask and Keypoint R-CNN at full width: ``FASTER_RCNN_X101_SPACECRAFT``
    with both heads (11 keypoints, ``mask_resolution`` 14) in bf16 at 800^2,
    batch 4: HEADS_STEPS SGD steps (config_1's solver) through
    ``make_detection_train_step``, then inference on HEADS_EVAL_FRAMES
    frames in batches of 4, the masks pasted, the keypoints decoded, segm AP
    and keypoint AP, every counter reset just before and read just after;
    then the step's split and a profiled step. Returns the rows of K2 and
    K2b in the gather read on the path's calls, the launches, the model and
    the training batch (for the cascade)."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, with_mask=True, with_keypoints=True,
                              num_keypoints=HEADS_KEYPOINTS, mask_resolution=14)
    model = m.rcnn.GeneralizedRCNN(cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(17))
    train = heads_scene(torch, m, dev, HEADS_BATCH, 51)
    val = heads_scene(torch, m, dev, HEADS_EVAL_FRAMES, 52)
    n_train, p = HEADS_BATCH * cfg.roi.batch_size_per_image, cfg.mask_resolution
    log(f"heads: Mask and Keypoint R-CNN (FASTER_RCNN_X101_SPACECRAFT with both heads: X101-32x8d FPN, "
        f"{HEADS_KEYPOINTS} keypoints, mask_resolution {p}, box head pooler {cfg.roi.pooler_impl}, ROI batch "
        f"{cfg.roi.batch_size_per_image}) in bf16 over float32 at {HEADS_HW}^2, batch {HEADS_BATCH}, SGD {HEADS_LR} "
        f"momentum 0.9 weight decay 1e-4, seeded weights; {HEADS_STEPS} steps, inference on {HEADS_EVAL_FRAMES} "
        f"frames; {int(train['gt_valid'].sum())} objects in the {HEADS_BATCH} training images")
    opt = m.optim.build_optimizer("sgd", model.parameters(), HEADS_LR, weight_decay=1e-4, momentum=0.9)
    state = m.detection_state.DetTrainState(model, opt)
    step = m.detection_state.make_detection_train_step()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == p and a[1].shape[0] == n_train)
    k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[5] == p)
    mets, ms, inf_ms, dets = [], [], [], []
    with k2, k2b:
        reset_counts(m)
        for i in range(HEADS_STEPS):
            sync()
            t0 = time.perf_counter()
            met = step(state, train, generator=m.landmark_loop.step_generator(42, i))
            mets.append({k: v.item() for k, v in met.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        # built here, so that it wraps k2's wrapper: the inference's detections
        k2i = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == p and a[1].shape[0] < n_train)
        with k2i, torch.no_grad():
            for s in range(0, HEADS_EVAL_FRAMES, HEADS_BATCH):
                sync()
                t0 = time.perf_counter()
                dets.append(model(val["image"][s:s + HEADS_BATCH]))
                sync()
                inf_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts(m)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"heads: Mask and Keypoint R-CNN train steps on {card}: {[round(v, 4) for v in ms]} ms (the first with "
        f"cuDNN's warm-up); peak memory {peak_gb:.4f} GB ({held_gb:.4f} GB held before); losses "
        f"{json.dumps([{k: round(v, 5) for k, v in met.items()} for met in mets])}; inference "
        f"{[round(v, 4) for v in inf_ms]} ms a batch of {HEADS_BATCH}; launches {json.dumps(launches)}")
    if not all(math.isfinite(v) for met in mets for v in met.values()):
        raise RuntimeError(f"heads: a Mask / Keypoint R-CNN loss is not finite: {mets}")
    if not all(met["loss_mask"] > 0 and met["loss_keypoint"] > 0 for met in mets):
        raise RuntimeError(f"heads: a head trained on no ROI: {mets}")
    for key in ("K2", "K2 gather", "K2b", "K2b gather", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by the Mask / Keypoint R-CNN path")
    if launches["K2"] == launches["K2 gather"] or launches["K2b"] == launches["K2b gather"]:
        raise RuntimeError(f"the box head's windowed read did not launch beside the heads' gather: {launches}")
    # segm AP and keypoint AP of the detections
    out = {k: torch.cat([d[k] for d in dets]) for k in dets[0]}
    seg_d, seg_g, kp_d, kp_g = [], [], [], []
    for b in range(HEADS_EVAL_FRAMES):
        valid, gv = out["valid"][b], val["gt_valid"][b]
        pasted = m.masks.paste_masks_in_image(torch.sigmoid(out["mask_logits"][b, :, :, :, 0]), out["boxes"][b],
                                              HEADS_HW, HEADS_HW)
        kps = m.cascade.keypoints_from_logits(out["keypoint_logits"][b], out["boxes"][b])
        scores, gb = out["scores"][b][valid].cpu().numpy(), val["gt_boxes"][b][gv].cpu().numpy()
        seg_d.append({"masks": pasted[valid].cpu().numpy(), "scores": scores})
        seg_g.append({"masks": val["gt_masks"][b][gv].cpu().numpy()})
        kp_d.append({"keypoints": kps[valid].cpu().numpy(), "scores": scores})
        kp_g.append({"keypoints": val["gt_keypoints"][b][gv].cpu().numpy(),
                     "boxes": np.concatenate([gb[:, :2], gb[:, 2:] - gb[:, :2]], 1)})
    seg = m.coco_eval.evaluate_instance_segmentation(seg_d, seg_g)
    kp = m.coco_eval.evaluate_keypoints(kp_d, kp_g)
    shapes = {k: tuple(out[k].shape) for k in ("mask_logits", "keypoint_logits")}
    log(f"heads: Mask and Keypoint R-CNN inference on {HEADS_EVAL_FRAMES} frames: {int(out['valid'].sum())} valid "
        f"detections, logits {json.dumps(shapes)}; segm AP {json.dumps(seg)}; keypoint AP {json.dumps(kp)}")
    if shapes != {"mask_logits": (HEADS_EVAL_FRAMES, 2, 2 * p, 2 * p, 1),
                  "keypoint_logits": (HEADS_EVAL_FRAMES, 2, 4 * p, 4 * p, HEADS_KEYPOINTS)}:
        raise RuntimeError(f"heads: inference logits of shapes {shapes}")
    if not all(bool(torch.isfinite(out[k]).all()) for k in shapes):
        raise RuntimeError("heads: inference logits are not finite")
    for res in (seg, kp):
        if not (0.0 <= res["AP"] <= 100.0 or math.isnan(res["AP"])):
            raise RuntimeError(f"heads: an AP out of range: {res}")
    det_step_split(torch, m, state, train, card)
    r_inf = k2i.calls[-1][0][1].shape[0]
    rows = [pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (heads: Mask and Keypoint R-CNN train step, "
                                               f"{n_train} sampled ROIs, gather read, P {p})", count="K2 gather"),
            pooler_row(torch, m, k2i.calls[-1], f"roi_align_multilevel (heads: Mask and Keypoint R-CNN inference, "
                                                f"{r_inf} detections, gather read, P {p})", count="K2 gather"),
            pooler_backward_row(torch, m, k2b.calls[-1], f"roi_align_multilevel_backward (heads: Mask and Keypoint "
                                                         f"R-CNN train step, {n_train} ROIs, gather read, P {p}, bf16 "
                                                         "gradient)", count="K2b gather")]
    return rows, launches, model, train


def heads_rows_cascade(torch, m, dev, card, model, batch):
    """``CascadeROIHeads(CascadeConfig())`` on the X101 pyramid of ``model``
    over ``batch``'s images and its 1,000 test proposals an image: three
    stages of K2 in the gather read at P = 7 on 4,000 ROIs, then the
    backward of a seeded weighted sum of its outputs (K2b in the gather
    read; the scores' rows sum to 1, so their plain sum would send no
    gradient), 3 times (counters reset just before, read just after; each
    timed by CUDA events)."""
    cfg = model.config
    with torch.no_grad():
        pyr = model.pyramid(batch["image"])
        shapes = {lvl: (v.shape[2], v.shape[3]) for lvl, v in pyr.items()}
        proposals, _, _ = m.rpn.find_top_proposals(model.rpn_head(pyr), model.anchors(shapes, dev),
                                                   (HEADS_HW, HEADS_HW), cfg.rpn)
    feats = {lvl: pyr[lvl].permute(0, 2, 3, 1).detach().requires_grad_() for lvl in ("p2", "p3", "p4", "p5")}
    cascade = m.cascade.CascadeROIHeads(m.cascade.CascadeConfig(), cfg.fpn_channels, device=dev,
                                        generator=torch.Generator().manual_seed(23))
    r = proposals.shape[0] * proposals.shape[1]
    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == 7)
    k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[5] == 7)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    weigh = torch.Generator(device=dev).manual_seed(24)
    ws = torch.randn((*proposals.shape[:2], 2), generator=weigh, device=dev)
    wb = torch.randn(proposals.shape, generator=weigh, device=dev) * 1e-2
    spans = []
    with k2, k2b:
        reset_counts(m)
        for _ in range(3):
            for f in feats.values():
                f.grad = None
            cascade.zero_grad()
            ev[0].record()
            scores, boxes = cascade(feats, proposals, m.fpn.FPN_STRIDES, (HEADS_HW, HEADS_HW))
            ev[1].record()
            ((scores * ws).sum() + (boxes * wb).sum()).backward()
            ev[2].record()
            sync()
            spans.append([ev[i].elapsed_time(ev[i + 1]) for i in range(2)])
        launches = read_counts(m)
    finite = bool(torch.isfinite(scores).all() and torch.isfinite(boxes).all()) and all(
        bool(torch.isfinite(f.grad).all()) for f in feats.values())
    log(f"heads: CascadeROIHeads on {card} (3 stages, fc {cascade.config.base.fc_dim}, bf16 levels of the X101 "
        f"pyramid, {r} proposals): forward / backward ms {[[round(v, 4) for v in sp] for sp in spans]}; scores "
        f"{tuple(scores.shape)}, boxes {tuple(boxes.shape)}, outputs and gradients finite {finite}; launches "
        f"{json.dumps(launches)}")
    if not finite or tuple(boxes.shape) != tuple(proposals.shape):
        raise RuntimeError("heads: the cascade's outputs or gradients are not finite")
    for key in ("K2 gather", "K2b gather"):
        if launches[key] != 9:
            raise RuntimeError(f"heads: {launches[key]} launches of {key} in 3 cascade passes, not 9")
    rows = [pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (heads: CascadeROIHeads stage, {r} proposals, "
                                               "gather read, P 7)", count="K2 gather"),
            pooler_backward_row(torch, m, k2b.calls[-1], f"roi_align_multilevel_backward (heads: CascadeROIHeads "
                                                         f"stage, {r} proposals, gather read, P 7, bf16 gradient)",
                                count="K2b gather")]
    return rows, launches


def heads_rows_fcos(torch, m, dev, card):
    """FCOS at full width: ``FCOSConfig()`` (R50, FPN 256, 4-conv towers, one
    class) in bf16 at 800^2, batch 4, the seeded trunk's FrozenBN calibrated
    on the training batch (``calibrate_frozen_bn``); FCOS_STEPS SGD steps
    (config_1's solver), then one evaluation on HEADS_EVAL_FRAMES frames: K4
    on 8 problems of 2,843 candidates (counters reset just before, read just
    after) and box AP; then the step's split and a profiled step. Returns
    K4's rows and the launches: the evaluation's call as scored (the seeded
    regression gives boxes that may suppress nothing) and, on its shape and
    valid mask, boxes jittered around the GT boxes, which must suppress."""
    cfg = m.fcos.FCOSConfig()
    model = m.fcos.FCOS(cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(29))
    train = {k: v for k, v in heads_scene(torch, m, dev, HEADS_BATCH, 61).items() if k in BOX_KEYS}
    val = heads_scene(torch, m, dev, HEADS_EVAL_FRAMES, 62)
    calibrate_frozen_bn(torch, m, model, train["image"])
    levels = {lvl: math.ceil(HEADS_HW / s) for lvl, s in m.retinanet.RETINA_STRIDES.items()}
    want_n = sum(min(cfg.topk_candidates, s * s * cfg.num_classes) for s in levels.values())
    log(f"heads: FCOS (FCOSConfig(): R50, FPN {cfg.fpn_channels}, {cfg.num_convs}-conv towers, {cfg.num_classes} "
        f"class, top {cfg.topk_candidates} a level, NMS {cfg.nms_thresh}) in bf16 over float32 at {HEADS_HW}^2, batch "
        f"{HEADS_BATCH}, SGD {HEADS_LR} momentum 0.9 weight decay 1e-4, seeded weights with FrozenBN calibrated on "
        f"the training batch; {FCOS_STEPS} steps, one evaluation on {HEADS_EVAL_FRAMES} frames (levels {levels}: "
        f"{want_n} candidates an image)")
    opt = m.optim.build_optimizer("sgd", model.parameters(), HEADS_LR, weight_decay=1e-4, momentum=0.9)
    state = m.detection_state.DetTrainState(model, opt)
    step = m.detection_state.make_detection_train_step(needs_sampling_rng=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    k4 = Capture(m.nms, "nms_mask_sorted", keep=lambda a: a[0].shape[0] == HEADS_EVAL_FRAMES)
    mets, ms = [], []
    with k4:
        reset_counts(m)
        for _ in range(FCOS_STEPS):
            sync()
            t0 = time.perf_counter()
            mets.append({k: v.item() for k, v in step(state, train).items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            dets = model(val["image"])
            sync()
            eval_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(m)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (boxes, valid, thresh), _ = k4.calls[-1]
    kept = int(m.nms.nms_mask_sorted_plain(boxes, valid, thresh).sum())
    gts = [{"boxes": val["gt_boxes"][b][val["gt_valid"][b]].cpu().numpy()} for b in range(HEADS_EVAL_FRAMES)]
    ap = m.coco_eval.evaluate_detections(m.coco_eval.padded_detections_to_list(dets), gts)
    log(f"heads: FCOS train steps on {card}: {[round(v, 4) for v in ms]} ms; peak memory {peak_gb:.4f} GB "
        f"({held_gb:.4f} GB held before); losses {json.dumps([{k: round(v, 5) for k, v in met.items()} for met in mets])}"
        f"; evaluation of {HEADS_EVAL_FRAMES} frames {eval_ms:.4f} ms: K4 on {tuple(boxes.shape[:2])}, "
        f"{int(valid.sum())} valid, {kept} kept; {int(dets['valid'].sum())} detections; box AP {json.dumps(ap)}; "
        f"launches {json.dumps(launches)}")
    if not all(math.isfinite(v) for met in mets for v in met.values()):
        raise RuntimeError(f"heads: an FCOS loss is not finite: {mets}")
    if launches["K4"] == 0:
        raise RuntimeError("kernel K4 was not launched by FCOS's evaluation")
    if tuple(boxes.shape[:2]) != (HEADS_EVAL_FRAMES, want_n):
        raise RuntimeError(f"FCOS's NMS ran on {tuple(boxes.shape[:2])}, not {HEADS_EVAL_FRAMES}x{want_n}")
    det_step_split(torch, m, state, train, card)
    label = f"heads: FCOS evaluation {HEADS_EVAL_FRAMES}x{want_n}"
    jittered = jittered_gt_boxes(torch, val, boxes.shape[1], 63)
    rows = [nms_row(torch, m, dev, (boxes, valid, thresh), f"nms_mask_sorted ({label}, as scored)"),
            nms_row(torch, m, dev, (jittered, valid, thresh),
                    f"nms_mask_sorted ({label}, coverage, not a path call: its valid mask, boxes jittered around "
                    f"each frame's GT boxes)")]
    cover = rows[1]["extra"]
    log(f"heads: K4 on FCOS's {HEADS_EVAL_FRAMES}x{want_n} with boxes jittered around the GT boxes: "
        f"{cover['valid']} valid, {cover['kept']} kept")
    if not cover["kept"] < cover["valid"]:
        raise RuntimeError(f"K4's FCOS coverage problem suppressed nothing: {cover}")
    return rows, launches


def jittered_gt_boxes(torch, scene, n: int, seed: int):
    """(B, n, 4) float32 boxes for a K4 problem of FCOS's shape that has to
    suppress: candidate i of frame b is that frame's valid GT box i mod G,
    each corner moved by a normal draw of 10% of the box's side, clipped to
    the image."""
    gen = torch.Generator(device=scene["gt_boxes"].device).manual_seed(seed)
    out = []
    for b in range(scene["gt_boxes"].shape[0]):
        gt = scene["gt_boxes"][b][scene["gt_valid"][b]]
        base = gt[torch.arange(n, device=gt.device) % gt.shape[0]]
        side = (base[:, 2:] - base[:, :2]).repeat(1, 2)
        noise = torch.randn(base.shape, generator=gen, device=gt.device)
        out.append((base + 0.1 * side * noise).clamp(0.0, float(HEADS_HW)))
    return torch.stack(out)


def heads_phase(torch, m, dev, card):
    """The heads' paths at full width on the card, each driven with the
    launch counters reset just before it and read just after: Mask and
    Keypoint R-CNN training and inference, Cascade R-CNN's ROI heads on its
    pyramid, FCOS training and evaluation; first their tiny paths against
    the CPU. Yields each path's (rows, launches)."""
    t0 = time.perf_counter()
    check_heads_tiny_against_cpu(torch, m)
    rows, launches, model, batch = heads_rows_train(torch, m, dev, card)
    yield rows, launches
    del rows  # its captured calls and yardsticks, before the next path runs
    yield heads_rows_cascade(torch, m, dev, card, model, batch)
    del model, batch
    torch.cuda.empty_cache()
    yield heads_rows_fcos(torch, m, dev, card)
    log(f"heads phase: {time.perf_counter() - t0:.1f} s")


RETINA_TRAIN_FRAMES, RETINA_VAL_FRAMES, RETINA_STEPS, RETINA_REPEATS = 20, 10, 6, 8
# a sweep of 1e-6 to 3e-5 on the card: from 3e-5 the loss climbs again after the second update
RETINA_REPEAT_LR = 1e-5


def calibrate_frozen_bn(torch, m, model, images, run=None) -> None:
    """Set every FrozenBN's statistics to those of its input on ``images``
    (scale 1, bias 0), in forward order in one pass of ``run`` (default
    ``model.pyramid``), so the seeded trunk keeps its activations at about
    unit scale as a pretrained trunk's folded BN does. Without it the random
    R101's features put RetinaNet's logits in the thousands: loss_cls ~1e5
    at the first step and NaN by the fourth, even at the warmup's lr of 1e-7
    (H100, config_20)."""
    def pre(mod, inputs):
        x = inputs[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
        mod.scale.fill_(1.0)
        mod.bias.zero_()

    hooks = [mod.register_forward_pre_hook(pre) for mod in model.modules()
             if isinstance(mod, m.resnet_backbone.FrozenBN)]
    try:
        with torch.no_grad():
            (run or model.pyramid)(images)
    finally:
        for h in hooks:
            h.remove()


def check_retina_train_tiny_against_cpu(torch, m) -> None:
    """``RETINANET_TINY`` in float32 (TF32 off) on the card against the CPU:
    3 EMA SGD updates (lr 1e-3, momentum 0.9, weight decay 1e-4) from the
    same weights on the same batch. The losses, ``num_fg``, the loss
    normalizer and the grad norms within 1e-4 relative; the parameters
    within 1 lr, at most 1% of them beyond 1e-3 lr (the tiny detector
    check's bars)."""
    data = tiny_det_batch(torch)
    runs = {}
    for device in ("cpu", "cuda"):
        model = m.retinanet.RetinaNet(m.retinanet.RETINANET_TINY, device=device,
                                      generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # tests/test_torch_retinanet.py's conditioning: a small stem, tame heads
            model.backbone.stem.conv.weight.mul_(1e-2)
            gen = torch.Generator().manual_seed(7)
            for conv in (model.head.cls_score, model.head.bbox_pred):
                conv.weight.copy_(0.05 * torch.randn(conv.weight.shape, generator=gen))
        opt = m.optim.build_optimizer("sgd", model.parameters(), m.optim.multistep_schedule(DET_TINY_LR, [2]),
                                      weight_decay=1e-4, momentum=0.9)
        state = m.detection_state.DetTrainState(model, opt)
        step = m.detection_state.make_detection_train_step(needs_sampling_rng=False, ema_loss_normalizer=True)
        batch = {k: v.to(device) for k, v in data.items()}
        mets = [{k: v.item() for k, v in step(state, batch).items()} for _ in range(3)]
        runs[device] = (mets, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (mc, sc), (mg, sg) = runs["cpu"], runs["cuda"]
    rel = lambda k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-6) for a, b in zip(mc, mg))
    loss_err = max(rel(k) for k in mc[0] if k.startswith("loss") or k == "num_fg")
    gn_err = rel("grad_norm")
    dp = torch.cat([((sg[k] - v).abs() / DET_TINY_LR).flatten() for k, v in sc.items()])
    share = (dp > 1e-3).float().mean().item()
    log(f"tiny RetinaNet train steps, card vs CPU (RETINANET_TINY, 3 EMA SGD updates, f32): loss_total "
        f"{[round(a['loss_total'], 6) for a in mg]}, loss_normalizer {[round(a['loss_normalizer'], 6) for a in mg]}, "
        f"num_fg {[a['num_fg'] for a in mg]}; losses relative err {loss_err:.3g} (limit 1e-4), grad norms "
        f"{gn_err:.3g} (limit 1e-4), parameters max {dp.max().item():.3g} lr (limit 1), share beyond 1e-3 lr "
        f"{share:.3g} (limit 0.01) of {dp.numel()}")
    if not (loss_err <= 1e-4 and gn_err <= 1e-4 and dp.max().item() <= 1.0 and share <= 0.01):
        raise RuntimeError(f"tiny RetinaNet train steps differ between the card and the CPU: loss {loss_err}, grad "
                           f"norm {gn_err}, parameters {dp.max().item()} lr, share {share}")


def retina_nms_rows(torch, m, dev, call, label):
    """K4's rows on RetinaNet's evaluation call: as the model scored it, and
    on the same sorted candidate boxes with every candidate valid (the
    coverage set: a model that scores few candidates above
    ``score_thresh`` leaves most rows out of phase 1). The second is no
    call of the path: its name says so, and its ``launches`` is, as on
    every row, K4's count in the path's run."""
    (boxes, valid, thresh), _ = call
    p, n = valid.shape
    return [nms_row(torch, m, dev, (boxes, v, thresh), f"nms_mask_sorted ({label} {p}x{n}, {what})")
            for what, v in (("as scored", valid),
                            ("coverage, not a path call: every candidate valid", torch.ones_like(valid)))]


def retina_repeated_batch(torch, m, dev, args, batch, card) -> None:
    """RETINA_REPEATS updates of a fresh config_20 model (its FrozenBN
    calibrated on the batch) on one augmented batch of 10, SGD at a constant RETINA_REPEAT_LR (momentum 0.9, weight
    decay 1e-4), the EMA step: the mean loss_total of the last 3 must be
    below that after the first update (not only below the first, which the
    first update's drop from the random heads' loss would pass alone). Then
    the step's split and a profiled step."""
    model = m.train_detector.build_model(args, dev)
    calibrate_frozen_bn(torch, m, model, batch["image"])
    opt = m.optim.build_optimizer("sgd", model.parameters(), RETINA_REPEAT_LR, weight_decay=1e-4, momentum=0.9)
    state = m.detection_state.DetTrainState(model, opt)
    step = m.detection_state.make_detection_train_step(needs_sampling_rng=False, ema_loss_normalizer=True)
    losses, ms = [], []
    for _ in range(RETINA_REPEATS):
        sync()
        t0 = time.perf_counter()
        losses.append(step(state, batch)["loss_total"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    last = sum(losses[-3:]) / 3
    log(f"RetinaNet train step on one repeated batch of {args.batch_size} (config_20 R101 800^2, bf16, SGD at a "
        f"constant {RETINA_REPEAT_LR}) on {card}: loss_total {[round(v, 6) for v in losses]}; after the first "
        f"update {losses[1]:.6f}, mean of the last 3 {last:.6f} (must be lower); step {median(ms[2:]):.4f} ms (median "
        f"of steps 3-{RETINA_REPEATS})")
    if not (all(math.isfinite(v) for v in losses) and last < losses[1]):
        raise RuntimeError(f"{RETINA_REPEATS} RetinaNet updates on one batch did not lower loss_total: {losses}")
    det_step_split(torch, m, state, batch, card)


def retina_phase(torch, m, dev, card):
    """``tools.train_detector.train`` with ``--preset config_20`` at full
    width on the card; returns K4's rows on its evaluation's call and the
    run's launch counts."""
    import os
    import tempfile

    t0 = time.perf_counter()
    check_retina_train_tiny_against_cpu(torch, m)
    with tempfile.TemporaryDirectory() as out_dir:
        train_json, train_ex = detection_scene(torch, m, dev, RETINA_TRAIN_FRAMES, 41, out_dir, "retina_train")
        val_json, val_ex = detection_scene(torch, m, dev, RETINA_VAL_FRAMES, 42, out_dir, "retina_val")
        args = m.train_detector.parse_args([
            "--preset", "config_20", "--train-json", train_json, "--val-json", val_json, "--image-dir", out_dir,
            "--output", os.path.join(out_dir, "run"), "--max-iter", str(RETINA_STEPS)])
        cfg = m.train_detector.model_config(args)
        log(f"train_detector config: --preset config_20 (R101 RetinaNet, depth {cfg.backbone.depth}, "
            f"{args.input_size}^2, batch {args.batch_size}, {cfg.num_convs}-conv towers, top {cfg.topk_candidates} "
            f"a level, NMS {cfg.nms_thresh}, flip {args.flip}), SGD lr {args.lr} warmup {args.solver.warmup_iters} "
            f"momentum 0.9 weight decay 1e-4, the EMA loss normalizer, bf16 over float32, seeded weights with FrozenBN "
            f"calibrated on a training batch; {RETINA_TRAIN_FRAMES} "
            f"training and {RETINA_VAL_FRAMES} validation frames of {FRAME_HW[1]}x{FRAME_HW[0]}, {RETINA_STEPS} steps "
            f"(cut from {args.solver.max_iter}), one evaluation at the end")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        steps = Timed(m.train_detector, "make_detection_train_step", factory=True, keep=True)
        k4 = Capture(m.nms, "nms_mask_sorted", keep=lambda a: a[0].shape[0] == args.batch_size)
        calib = next(m.detection_dataset.detection_batches(train_ex, args.batch_size, (args.input_size,) * 2,
                                                           flip=True, num_workers=0))["image"]
        build = m.train_detector.build_model

        def calibrated(a, device):  # the trainer's seeded model, its FrozenBN calibrated on a training batch
            model = build(a, device)
            calibrate_frozen_bn(torch, m, model, calib)
            return model

        m.train_detector.build_model = calibrated
        try:
            with steps, k4:
                reset_counts(m)
                t1 = time.perf_counter()
                trainer = m.train_detector.train(args, train_ex, val_ex, dev)
                sync()
                wall = time.perf_counter() - t1
                launches = read_counts(m)
        finally:
            m.train_detector.build_model = build
        del calib
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state = trainer.state
        mets = [{k: float(v) for k, v in met.items()} for met in steps.results]
        losses = [met["loss_total"] for met in mets]
        finite = all(math.isfinite(v) for met in mets for v in met.values()) and all(
            bool(torch.isfinite(v).all()) for v in state.model.state_dict().values())
        ap = {k: v[0] for k, v in trainer.storage.latest().items() if k.startswith("bbox/")}
        step_ms = median(steps.ms[2:])
        log(f"train_detector (config_20 on {card}): {wall:.4f} s in all; train step {step_ms:.4f} ms (median of "
            f"steps 3-{RETINA_STEPS}; all {[round(v, 4) for v in steps.ms]}) = "
            f"{args.batch_size / step_ms * 1e3:.3f} images/s; peak memory {peak_gb:.4f} GB "
            f"(torch.cuda.max_memory_allocated; {held_gb:.4f} GB of it held before the run); loss_total "
            f"{[round(v, 5) for v in losses]}; num_fg {[met['num_fg'] for met in mets]}; loss_normalizer "
            f"{[round(met['loss_normalizer'], 4) for met in mets]}; grad_norm {[round(met['grad_norm'], 4) for met in mets]}; "
            f"EvalHook box AP at one detection an image {json.dumps(ap)}; launches {json.dumps(launches)}")
        if not finite or len(losses) != RETINA_STEPS:
            raise RuntimeError(f"train_detector config_20: a metric or a parameter is not finite: {mets}")
        if launches["K4"] == 0:
            raise RuntimeError("kernel K4 was not launched by the RetinaNet trainer's evaluation")
        if "bbox/AP" not in ap:
            raise RuntimeError(f"the RetinaNet trainer's EvalHook reported no AP: {ap}")
        (boxes, valid, _), _ = k4.calls[-1]
        levels = {lvl: math.ceil(args.input_size / st) for lvl, st in m.retinanet.RETINA_STRIDES.items()}
        want_n = sum(min(cfg.topk_candidates, s * s * 9) for s in levels.values())
        log(f"RetinaNet evaluation's NMS: K4 on {tuple(boxes.shape[:2])} (levels {levels}: {want_n} candidates an "
            f"image), {int(valid.sum())} above score_thresh {cfg.score_thresh}")
        if tuple(boxes.shape[:2]) != (args.batch_size, want_n):
            raise RuntimeError(f"RetinaNet's NMS ran on {tuple(boxes.shape[:2])}, not {args.batch_size}x{want_n}")
        # the final checkpoint's .npz, loaded into a fresh RetinaNet
        npz = os.path.join(args.output, "checkpoints", str(state.step), "model.npz")
        loaded = m.retinanet.RetinaNet(cfg, dtype=torch.bfloat16, device=dev)
        loaded.load_state_dict(m.convert.flax_to_state_dict({"params": m.evaluate.load_npz_variables(npz)["params"]}))
        trained = state.model.state_dict()
        params_equal = all(torch.equal(v, trained[k]) for k, v in loaded.state_dict().items())
        batch = next(m.detection_dataset.detection_batches(val_ex, args.batch_size, (args.input_size,) * 2,
                                                           train=False, augment=False, num_workers=0))
        with torch.no_grad():
            a, b = loaded(batch["image"]), state.model(batch["image"])
        box_err = (a["boxes"] - b["boxes"]).abs().max().item()
        log(f"train_detector config_20: the final .npz ({os.path.getsize(npz)} bytes) into a RetinaNet: parameters "
            f"equal {params_equal}; detections on {args.batch_size} validation frames {box_err} px from the trained "
            f"model's (limit 0), valid equal {torch.equal(a['valid'], b['valid'])}, "
            f"{int(b['valid'].sum())} valid; the state's loss_normalizer {float(state.loss_normalizer):.4f}")
        if not params_equal or box_err != 0 or not torch.equal(a["valid"], b["valid"]):
            raise RuntimeError(f"the trained RetinaNet's .npz gives other detections: {box_err}")
        del loaded, a, b
        rows = retina_nms_rows(torch, m, dev, k4.calls[-1], "train_detector config_20 evaluation:")
        train_batch = next(m.detection_dataset.detection_batches(train_ex, args.batch_size, (args.input_size,) * 2,
                                                                 flip=True, num_workers=0))
        del trainer, state, k4
        torch.cuda.empty_cache()
        retina_repeated_batch(torch, m, dev, args, train_batch, card)
    log(f"RetinaNet training phase: {time.perf_counter() - t0:.1f} s")
    return rows, launches


# ---------------------------------------------------------------------------
# the event-camera half: v2e at 1280x720 and the event evaluation at 346x260
# ---------------------------------------------------------------------------

EV_TINY_HW, EV_TINY_FRAMES = (48, 64), 8
EV_FLIP_SHARE = 1e-4  # card vs CPU: flipped (iteration, pixel) entries of the event maps
EV_HW, EV_SOURCE_FRAMES, EV_SOURCE_FPS, EV_UPSAMPLE, EV_EXPOSURE = (720, 1280), 33, 30.0, 4, 0.01
DAVIS_HW, DAVIS_FPS, DAVIS_FRAMES = (260, 346), 1000.0, 241  # 0.24 s: 24 windows of 10 ms
EV_EVAL_FRAMES = 24


def textured_frames(h: int, w: int, n: int, seed: int, travel: float):
    """(n, h, w) float32 frames in [0, 255]: a disc of smooth seeded texture
    (sums of sinusoids) moving ``travel`` of the width left to right, its
    texture moving with it, over a faint textured background."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def waves(amp, period):
        return [(amp / 4, rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi), period * rng.uniform(0.7, 1.3))
                for _ in range(4)]

    def texture(params, dx):
        return sum(np.float32(a) * np.sin(((xs - dx) * np.cos(ang) + ys * np.sin(ang)) * np.float32(2 * np.pi / p) + ph)
                   for a, ang, ph, p in params)

    background = 40.0 + texture(waves(10.0, 0.08 * w), 0.0)
    obj = waves(80.0, 0.1 * w)
    radius, frames = 0.3 * h, []
    for i in range(n):
        shift = travel * w * i / max(n - 1, 1)
        cx, cy = 0.5 * w - travel * w / 2 + shift, 0.5 * h
        inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= radius ** 2
        frames.append(np.where(inside, 150.0 + texture(obj, shift), background))
    return np.clip(np.stack(frames), 0, 255).astype(np.float32)


class TexturedObject1280:
    """v2e's synthetic input of the 1280x720 leg: 33 source frames at 30 fps."""

    frame_rate = EV_SOURCE_FPS

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height

    def frames_array(self):
        import numpy as np

        frames = textured_frames(self.height, self.width, EV_SOURCE_FRAMES, 41, 0.5)
        return frames, (np.arange(len(frames)) / self.frame_rate).astype(np.float32)


class TexturedObjectDavis(TexturedObject1280):
    """v2e's synthetic input of the DAVIS346 leg: 241 frames at 1000 fps."""

    frame_rate = DAVIS_FPS

    def frames_array(self):
        import numpy as np

        frames = textured_frames(self.height, self.width, DAVIS_FRAMES, 42, 0.3)
        return frames, (np.arange(len(frames)) / self.frame_rate).astype(np.float32)


def check_events_tiny_against_cpu(torch, m) -> None:
    """The ``noisy`` emulator (cutoff, leak, shot noise, refractory period)
    at 48x64 over 8 frames on the card against the CPU on the same draws
    (made on the CPU): at most EV_FLIP_SHARE of the (iteration, pixel)
    entries flipped, the event counts within that share of the entries;
    chunks of 3 against one run on the card with the card's own draws:
    bit-equal; SuperSloMo at 64x96 (2 pairs, 3 times) card against CPU
    within 1e-4."""
    E, S = m.emulator, m.slomo
    cfg = E.EmulatorConfig.preset("noisy")
    h, w = EV_TINY_HW
    frames = torch.from_numpy(textured_frames(h, w, EV_TINY_FRAMES + 1, 7, 0.5))
    times = torch.arange(EV_TINY_FRAMES + 1, dtype=torch.float32) * 0.002
    gen = torch.Generator().manual_seed(8)
    init = {k: torch.randn(h, w, generator=gen) for k in ("pos", "neg", "noise")}
    draws = {"leak": torch.randn(EV_TINY_FRAMES, h, w, generator=gen),
             "shot": torch.rand(EV_TINY_FRAMES, cfg.max_iters, h, w, generator=gen)}
    outs = {}
    for d in ("cpu", "cuda"):
        st = E.init_state(frames[0].to(d), cfg, draws={k: v.to(d) for k, v in init.items()})
        _, outs[d] = E.emulate_sequence(st, frames[1:].to(d), times[1:].to(d), cfg,
                                        {k: v.to(d) for k, v in draws.items()})
    entries = outs["cpu"]["pos"].numel() * 2
    flips = sum(int((outs["cuda"][k].cpu() != outs["cpu"][k]).sum()) for k in ("pos", "neg"))
    events = {d: int(o["num_events"].sum()) for d, o in outs.items()}
    ts_equal = bool(torch.equal(outs["cuda"]["ts"].cpu(), outs["cpu"]["ts"]))
    st1 = E.init_state(frames[0].cuda(), cfg, seed=3)
    _, one = E.emulate_sequence(st1, frames[1:].cuda(), times[1:].cuda(), cfg)
    st2, parts = E.init_state(frames[0].cuda(), cfg, seed=3), []
    for i in range(1, EV_TINY_FRAMES + 1, 3):
        st2, out = E.emulate_sequence(st2, frames[i:i + 3].cuda(), times[i:i + 3].cuda(), cfg)
        parts.append(out)
    chunked_equal = all(torch.equal(torch.cat([p[k] for p in parts]), one[k]) for k in one)
    gen = torch.Generator().manual_seed(9)
    model = S.SuperSloMo(1, device="cpu", generator=gen)
    pair = torch.from_numpy(textured_frames(64, 96, 3, 10, 0.2) / 255.0)[..., None]
    sl = {}
    for d in ("cpu", "cuda"):
        model = model.to(d)
        with torch.inference_mode():
            sl[d] = model.interpolate(pair[:2].to(d), pair[1:].to(d), S.midpoint_times(3, d))
    sl_err = (sl["cuda"].cpu() - sl["cpu"]).abs().max().item()
    log(f"tiny events, card vs CPU (noisy at {w}x{h}, {EV_TINY_FRAMES} frames, max_iters {cfg.max_iters}, CPU draws "
        f"on both): {flips} of {entries} (iteration, pixel) entries flipped = {flips / entries:.3g} (limit "
        f"{EV_FLIP_SHARE}); events card {events['cuda']}, CPU {events['cpu']}; timestamps equal {ts_equal}; chunks "
        f"of 3 vs one run on the card (its own draws) bit-equal {chunked_equal}, {int(one['num_events'].sum())} "
        f"events; SuperSloMo at 96x64 (2 pairs x 3 times) max |card - CPU| {sl_err:.3g} (limit 1e-4)")
    if not (flips <= EV_FLIP_SHARE * entries and abs(events["cuda"] - events["cpu"]) <= EV_FLIP_SHARE * entries
            and events["cpu"] > 0 and chunked_equal and sl_err <= 1e-4):
        raise RuntimeError("the tiny event check failed (see the line above)")


def profile_launches(torch, fn) -> tuple[int, float]:
    """Kernel launches and device-busy us of one call of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in kernels), sum(e.self_device_time_total for e in kernels)


def slomo_warm(torch, m, dev, argv, upsampled) -> dict:
    """SuperSloMo of leg A once more, after the command's run (which made
    cuDNN's first calls at these shapes): the command's weights
    (``v2e.load_slomo``) on its source frames. The first call is held to the
    command's frames (``upsampled``) within 1e-3 grey; a second is timed
    with CUDA events. Also the conv FLOPs of one pair (multiply-adds x 2)."""
    import numpy as np

    args = m.v2e.build_parser().parse_args(argv)
    model = m.v2e.load_slomo(args, dev)
    src = torch.from_numpy(np.asarray(TexturedObject1280(EV_HW[1], EV_HW[0]).frames_array()[0], np.float32)).to(dev)
    out, _ = m.v2e.upsample_frames(src, model, EV_UPSAMPLE, False, args.batch_size)
    err = float((out - upsampled).abs().max())
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    m.v2e.upsample_frames(src, model, EV_UPSAMPLE, False, args.batch_size)
    end.record()
    sync()
    flops_pair = conv_flops(torch, m, [model], lambda: m.v2e.upsample_frames(src[:2], model, EV_UPSAMPLE, False, 1))
    return {"ms": start.elapsed_time(end), "err": err, "flops_pair": flops_pair}


def v2e_phase(torch, m, dev, card) -> None:
    """Leg A: ``tools.v2e`` at 1280x720 on 33 seeded source frames at 30 fps
    (``TexturedObject1280``), SuperSloMo x4 with random weights (4 pairs a
    call) -> 128 frames, the ``clean`` preset, max_iters 8, chunks of 64,
    duration exposure 0.01 s. Gates: events > 0, every event frame finite and
    in [0, 1], the events sorted on t."""
    import os
    import tempfile

    import numpy as np

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--synthetic_input", f"{__name__}:TexturedObject1280", "--output_width", str(EV_HW[1]),
                "--output_height", str(EV_HW[0]), "--slomo_upsample", str(EV_UPSAMPLE), "--batch_size", "4",
                "--dvs_params", "clean", "--dvs_max_iters", "8", "--dvs_frame_chunk", "64", "--dvs_exposure",
                "duration", str(EV_EXPOSURE), "--dvs_numpy", "events.npy", "--skip_video_output", "--no_preview",
                "-o", os.path.join(out_dir, "v2e")]
        t0 = time.perf_counter()
        res = m.v2e.main(argv)
        wall = time.perf_counter() - t0
        n_bmp = len(os.listdir(os.path.join(res.output_folder, "event-frames")))
        saved = np.load(os.path.join(res.output_folder, "events.npy"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sec, n_frames, pairs = res.seconds, res.num_frames, res.num_pairs
    stream_s = n_frames / (EV_SOURCE_FPS * res.upsample)
    imgs = res.event_frames
    ev = res.events
    sorted_t = bool(np.all(np.diff(ev[:, 0]) >= 0)) if len(ev) else False
    in_range = bool(torch.isfinite(imgs).all() and imgs.min() >= 0 and imgs.max() <= 1)
    cfg = res.config
    st = res.state
    last = res.frames[-1]
    t_next = torch.tensor(float(res.timestamps[-1]) + 1.0 / (EV_SOURCE_FPS * res.upsample), device=dev)
    launches, busy_us = profile_launches(torch, lambda: m.emulator.emulate_frame(st, last, t_next, cfg))
    sync()
    t1 = time.perf_counter()
    for _ in range(10):
        m.emulator.emulate_frame(st, last, t_next, cfg)
    sync()
    frame_ms = (time.perf_counter() - t1) * 100
    log(f"v2e 1280x720 on {card}: {EV_SOURCE_FRAMES} source frames at {EV_SOURCE_FPS:g} fps -> SuperSloMo x"
        f"{res.upsample} (random weights, 4 pairs a call, frames padded to 1280x736) -> {n_frames} frames; the "
        f"clean preset, max_iters {cfg.max_iters}, chunks of 64, duration exposure {EV_EXPOSURE} s")
    slomo = slomo_warm(torch, m, dev, argv, res.frames)
    log(f"v2e SloMo in the command: weights {sec['slomo_load']:.4f} s (two UNets drawn on the CPU, copied to the "
        f"card); the first call over {pairs} pairs {sec['slomo']:.4f} s = {sec['slomo'] * 1e3 / pairs:.4f} ms a pair "
        f"(cuDNN's first calls at these shapes included)")
    log(f"v2e SloMo warm (the same weights and source frames again, CUDA events): {slomo['ms']:.4f} ms = "
        f"{slomo['ms'] / pairs:.4f} ms a pair, {n_frames / (slomo['ms'] * 1e-3):.2f} frames/s; "
        f"{slomo['flops_pair'] / 1e12:.4f} TFLOP a pair (a hook count of its convs) = "
        f"{slomo['flops_pair'] * pairs / (slomo['ms'] * 1e-3) / 1e12:.2f} TFLOP/s; max |warm - command| "
        f"{slomo['err']:.3g} grey (limit 1e-3)")
    log(f"v2e emulator: {sec['emulate']:.4f} s for {n_frames - 1} frame steps = "
        f"{sec['emulate'] * 1e3 / (n_frames - 1):.4f} ms a frame, {(n_frames - 1) / sec['emulate']:.2f} frames/s, "
        f"{stream_s / sec['emulate']:.4f} x real time ({stream_s:.4f} s of stream); one more frame step alone "
        f"{frame_ms:.4f} ms")
    log(f"v2e launches a frame (one profiled clean frame step at 1280x720): {launches} kernel launches, device busy "
        f"{busy_us:.0f} us")
    log(f"v2e events: {res.num_events} ({len(ev)} in the list, .npy equal {bool(np.array_equal(saved, ev))}), "
        f"overflow {res.overflow}; dense-to-sparse {sec['dense_to_events'] * 1e3:.4f} ms, render "
        f"{sec['render'] * 1e3:.4f} ms, event writes {sec['write_events'] * 1e3:.4f} ms, frame writes "
        f"{sec['write_frames'] * 1e3:.4f} ms; {imgs.shape[0]} event frames ({n_bmp} .bmp), finite and in [0, 1] "
        f"{in_range}; events sorted on t {sorted_t}; peak {peak_gb:.4f} GB (torch.cuda.max_memory_allocated; "
        f"{held_gb:.4f} held before); the command {wall:.4f} s")
    if not (res.num_events > 0 and len(ev) == res.num_events and in_range and sorted_t and n_bmp == imgs.shape[0]
            and imgs.shape[0] > 0 and slomo["err"] <= 1e-3):
        raise RuntimeError("v2e 1280x720 failed its gates (see the lines above)")
    noisy = m.emulator.EmulatorConfig.preset("noisy")
    f = res.frames[-1, :DAVIS_HW[0], :DAVIS_HW[1]].contiguous()
    st = m.emulator.init_state(res.frames[-2, :DAVIS_HW[0], :DAVIS_HW[1]], noisy, seed=1)
    launches, busy_us = profile_launches(torch, lambda: m.emulator.emulate_frame(st, f, torch.tensor(0.001, device=dev),
                                                                                noisy))
    log(f"v2e launches a frame (one profiled noisy frame step at 346x260: refractory period, {noisy.max_iters} "
        f"iterations in a loop): {launches} kernel launches, device busy {busy_us:.0f} us")
    del res


def davis_recordings(m, out_dir: str):
    """A seeded 346x260 stream under ``noisy`` through ``tools.v2e``, written
    as AEDAT2 and CSV recordings, and a seeded calibration JSON. Returns
    the recordings' folder, the calibration's path and the events."""
    import os

    import numpy as np

    rec_dir = os.path.join(out_dir, "recordings")
    res = m.v2e.main([
        "--synthetic_input", f"{__name__}:TexturedObjectDavis", "--dvs346", "--dvs_params", "noisy",
        "--no_frames", "--dvs_aedat2", "rec_aedat2.aedat", "--dvs_text", "rec_csv.csv", "--skip_video_output",
        "--no_preview", "--seed", "5", "-o", rec_dir, "--overwrite"])
    rng = np.random.default_rng(6)
    fx = 320.0 * rng.uniform(0.95, 1.05)
    calib = {"intrinsics": {"camera_matrix": [[fx, 0.0, 173.0 + rng.uniform(-3, 3)],
                                              [0.0, fx * rng.uniform(0.99, 1.01), 130.0 + rng.uniform(-3, 3)],
                                              [0.0, 0.0, 1.0]],
                            "distortion_coefficients": [-0.25, 0.09, 5e-4, -3e-4, -0.01]}}
    calib_path = os.path.join(out_dir, "calibration.json")
    with open(calib_path, "w") as f:
        json.dump(calib, f)
    log(f"event evaluation: {DAVIS_FRAMES} source frames of {DAVIS_HW[1]}x{DAVIS_HW[0]} at {DAVIS_FPS:g} fps under "
        f"noisy -> {res.num_events} events (overflow {res.overflow}), emulator {res.seconds['emulate']:.4f} s, "
        f"written as AEDAT2 and CSV in {res.seconds['write_events']:.4f} s")
    return rec_dir, calib_path, res.events


def recordings_agree(torch, m, dev, scenes, rec_dir, calib_path, events):
    """The two recordings of one v2e stream against the stream itself: the
    AEDAT2 scene's frames equal the stream's with timestamps truncated to
    whole microseconds, as the AEDAT2 writer truncates them (coordinates
    flipped and back, polarity); the CSV file's events equal the stream's
    within 5e-10 s; and the two scenes' frames are equal in every window
    that no event enters or leaves under the truncation. Returns (the
    first two hold, events whose window moves, (equal frames, frames no
    event moved into or out of, all equal frames))."""
    import os

    import cv2
    import numpy as np

    cam = m.camera.CameraModel.from_calibration_json(calib_path)

    def frames(ev):
        return [cv2.undistort((img * 255).to(torch.uint8).cpu().numpy(), cam.K, cam.dist)
                for img, _ in m.ev_io.accumulate_exposure_frames(ev, DAVIS_HW[1], DAVIS_HW[0], 0.01, device=dev)]

    read = {scene: [cv2.imread(path, cv2.IMREAD_GRAYSCALE) for _, path in files] for scene, files in scenes.items()}
    trunc = events.copy()
    trunc[:, 0] = (1e6 * events[:, 0]).astype(np.int32) / 1e6
    aedat = read["rec_aedat2"]
    redo = frames(trunc)
    csv = m.ev_io.read_events_csv(os.path.join(rec_dir, "rec_csv.csv"), force_pos_polarity=False)
    same = (len(redo) == len(aedat) and all(np.array_equal(a, b) for a, b in zip(redo, aedat))
            and csv.shape == events.shape and np.array_equal(csv[:, 1:], events[:, 1:])
            and float(np.abs(csv[:, 0] - events[:, 0]).max()) <= 5e-10)
    bins = [np.floor((ev[:, 0] - ev[0, 0]) / 0.01).astype(np.int64) for ev in (csv, trunc)]
    moved = bins[0] != bins[1]
    touched = set(bins[0][moved].tolist()) | set(bins[1][moved].tolist())
    pairs = list(zip(read["rec_aedat2"], read["rec_csv"]))
    untouched = [i for i in range(len(pairs)) if i not in touched]
    equal = (sum(np.array_equal(*pairs[i]) for i in untouched), len(untouched),
             sum(np.array_equal(a, b) for a, b in pairs))
    return same, int(moved.sum()), equal


def event_eval_phase(torch, m, dev, card):
    """Leg B: ``tools.evaluate_event_pipeline`` on the two recordings:
    ``convert_aedats`` (undistorted frames, 24 a scene) then ``evaluate``
    at its defaults (X101-32x8d bf16 at 768, batch 8, HRNet-W32 at 512,
    RANSAC 256) from ``.npz`` weights made from seeds. Checks the artifacts,
    poses finite, the AEDAT2 scene's frames equal to the CSV stream's after
    microsecond truncation, and that K1, K2 and K4 launched (counters reset
    just before, read just after). Returns their rows on this phase's
    inputs and the launch counts."""
    import os
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        rec_dir, calib_path, events = davis_recordings(m, out_dir)
        det = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_X101_SPACECRAFT, dtype=torch.bfloat16, device=dev,
                                     generator=torch.Generator().manual_seed(0))
        hr = m.models.build_landmark_model("pose_hrnet", NUM_JOINTS, device=dev, dtype=torch.bfloat16,
                                           generator=torch.Generator().manual_seed(1))
        paths = {}
        for name, model in (("det", det), ("hrnet", hr)):
            paths[name] = os.path.join(out_dir, f"{name}.npz")
            np.savez(paths[name], **m.convert.flatten_variables(m.convert.module_to_flax(model)))
        del det, hr
        lm3d = np.random.default_rng(2).normal(0, 0.8, (NUM_JOINTS, 3))
        lm_path = os.path.join(out_dir, "landmarks.csv")
        with open(lm_path, "w") as f:
            f.write("x,y,z\n" + "".join(f"{x!r},{y!r},{z!r}\n" for x, y, z in lm3d.tolist()))
        torch.cuda.empty_cache()
        captures = {key: Capture(*m.kernels[key][:2]) for key in ("K1", "K2", "K4")}
        timers = {"convert": Timed(m.convert_aedats, "main"), "evaluate": Timed(m.evaluate, "main"),
                  "scene": Timed(m.evaluate, "run_scene")}
        out = os.path.join(out_dir, "eval")
        with contextlib.ExitStack() as stack:
            for c in list(captures.values()) + list(timers.values()):
                stack.enter_context(c)
            reset_counts(m)
            t0 = time.perf_counter()
            scenes = m.evaluate_event_pipeline.main([
                "--recordings-dir", rec_dir, "--calibration-file", calib_path, "--landmarks-file", lm_path,
                "--detector-checkpoint", paths["det"], "--landmark-checkpoint", paths["hrnet"], "--output-dir", out])
            wall = time.perf_counter() - t0
            launches = read_counts(m)
        counts = {s: len(v) for s, v in scenes.items()}
        log(f"event evaluation (tools.evaluate_event_pipeline: convert_aedats, then evaluate with X101-32x8d bf16 at "
            f"{EVAL_SIZE}, batch {EVAL_BATCH}, HRNet-W32 at 512, RANSAC 256) on {card}: scenes {json.dumps(counts)}; "
            f"{wall:.4f} s in all: convert {timers['convert'].ms[0] / 1e3:.4f} s, evaluate "
            f"{timers['evaluate'].ms[0] / 1e3:.4f} s (model loads included), run_scene per scene "
            f"{[round(v / 1e3, 4) for v in timers['scene'].ms]} s = "
            f"{[round(n / (v / 1e3), 2) for n, v in zip(counts.values(), timers['scene'].ms)]} frames/s (first scene "
            f"with the warm-up batch; frame reads and artifact writes included); launches {json.dumps(launches)}")
        if sorted(counts) != ["rec_aedat2", "rec_csv"] or set(counts.values()) != {EV_EVAL_FRAMES}:
            raise RuntimeError(f"event evaluation: scenes {counts}, not two of {EV_EVAL_FRAMES} frames")
        for scene in counts:
            check_artifacts(torch, os.path.join(out, "results", scene), EV_EVAL_FRAMES)
        same, moved, equal = recordings_agree(torch, m, dev, scenes, rec_dir, calib_path, events)
        log(f"event evaluation: the AEDAT2 scene equals the v2e stream truncated to whole microseconds (as the "
            f"AEDAT2 writer truncates) and the CSV scene's events equal the stream within 5e-10 s: {same}; "
            f"{moved} events change window under the truncation; the two scenes' frames equal wherever no event "
            f"moved: {equal[0]} of {equal[1]} such frames ({equal[2]} of {EV_EVAL_FRAMES} frames equal in all)")
        if not same or equal[0] != equal[1]:
            raise RuntimeError("the AEDAT2 and CSV recordings disagree beyond microsecond truncation")
        for key in ("K1", "K2", "K4"):
            if launches[key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the event evaluation")
        boxes = captures["K2"].calls[-1][0][1]
        label = f"event evaluation: {DAVIS_HW[1]}x{DAVIS_HW[0]} -> {EVAL_SIZE}"
        rows = [crop_row(torch, m, dev, captures["K1"].calls[-1], f"crop_bilinear ({label}, batch {EVAL_BATCH})")]
        rows.append(pooler_row(torch, m, captures["K2"].calls[-1],
                               f"roi_align_multilevel ({label}, batch {EVAL_BATCH}, {boxes.shape[0]} ROIs)"))
        rows += nms_rows(torch, m, dev, captures["K4"].calls[-2:], f"{label}: X101 ")
    log(f"event evaluation phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, launches


def events_phase(torch, m, dev, card):
    """The event-camera half: the tiny card-vs-CPU check, leg A (v2e at
    1280x720) and leg B (the event evaluation at 346x260). Returns leg B's
    kernel rows and launch counts."""
    t0 = time.perf_counter()
    check_events_tiny_against_cpu(torch, m)
    v2e_phase(torch, m, dev, card)
    torch.cuda.empty_cache()
    rows, launches = event_eval_phase(torch, m, dev, card)
    log(f"events phase: {time.perf_counter() - t0:.1f} s")
    return rows, launches


# ---------------------------------------------------------------------------
# training on event frames: the DVS training pipeline and the photometric stacks
# ---------------------------------------------------------------------------

DVS_FRAMES, DVS_EXPOSURE, DVS_DET_ITERS, DVS_LM_EPOCHS, DVS_AUG_ITERS = 48, 0.02, 4, 1, 2
DVS_LANDMARKS = 12  # craft_geometry: 8 body corners and 2 on each panel
STACK_BATCH, STACK_SIZE = 2, 768
STACK_TOL, STACK_FLIP_BAR = 1e-3, 1e-3  # the tests' bars: grey, and flipped threshold pixels (a share)
# each threshold stage: its pre-threshold field, the threshold, and how far a flip reaches in the output
STACK_THRESHOLDS = {"random_stars": ("star_field", lambda d: 160.0, 6),
                    "random_haze": ("haze_field", lambda d: d["thresh"], None),
                    "random_streaks": ("streak_field", lambda d: d["thresh"], None)}


def check_coco_dicts(m, dicts_dir: str, split_dir: str) -> dict[str, int]:
    """Each split's COCO json: one image a frame of its split folder, one
    annotation an image with a finite box of positive size and 12 finite
    keypoints of visibility 1 or 2. Returns the images a split."""
    import os

    counts = {}
    for split in ("train", "validation", "test"):
        coco = m.coco_io.load_coco(os.path.join(dicts_dir, f"synthetic_{split}.json"))
        names = sorted(im["file_name"] for im in coco["images"])
        if names != sorted(os.listdir(os.path.join(split_dir, split))) or not names:
            raise RuntimeError(f"dvs: synthetic_{split}.json names {len(names)} images, not its split's frames")
        if len(coco["annotations"]) != len(names):
            raise RuntimeError(f"dvs: synthetic_{split}.json has {len(coco['annotations'])} annotations")
        for ann in coco["annotations"]:
            kps = [ann["keypoints"][i:i + 3] for i in range(0, len(ann["keypoints"]), 3)]
            box = ann["bbox"]
            if (len(kps) != DVS_LANDMARKS or not all(math.isfinite(v) for v in box + ann["keypoints"])
                    or box[2] <= 0 or box[3] <= 0 or any(k[2] not in (1.0, 2.0) for k in kps)):
                raise RuntimeError(f"dvs: an invalid annotation in synthetic_{split}.json: {ann}")
        counts[split] = len(names)
    return counts


def check_stacks_against_cpu(torch, m, images) -> None:
    """``EVENT_STACK`` and ``SPEEDPLUS_STACK`` on a batch of event frames at
    768^2, the card against the CPU on the card's draws, stage by stage on
    the same input: the event stages exact; the others within 1e-3 grey,
    the threshold stages' flipped pixels counted against 1e-3 of the field
    and the output held away from their reach (a whole image where the
    later warps and blurs spread a flip over the frame); a stage fails
    where every image holds a flip. Then each whole stack card against CPU
    (the event stack exact, SPEED+ within 1e-3 grey on the images that no
    stage flipped) and timed on the card (CUDA events), SPEED+ also at the
    detector's batch of 8."""
    aug = m.augment
    b, h, w = images.shape[:3]
    for names in (aug.EVENT_STACK, aug.SPEEDPLUS_STACK):
        draws = aug.sample_stack(aug.stack_generator(42, 0, images.device), b, h, w, names)
        draws_cpu = [{k: v.cpu() for k, v in d.items()} for d in draws]
        x = images.cpu()
        clean = torch.ones(b, dtype=torch.bool)  # images with no flipped threshold pixel in any stage
        for name, d, dc in zip(names, draws, draws_cpu):
            fn = aug._REGISTRY[name][0]
            t0 = time.perf_counter()
            got = fn(x.cuda(), d)
            sync()
            card_s = time.perf_counter() - t0
            want = fn(x, dc)
            diff = (got.cpu() - want).abs()
            flips, keep = 0, torch.ones(diff.shape[:3], dtype=torch.bool)
            if name in STACK_THRESHOLDS:
                field, thresh, reach = STACK_THRESHOLDS[name]
                th = torch.as_tensor(thresh(dc), dtype=torch.float32).reshape(-1, 1, 1)
                on_card = getattr(aug, field)(x.cuda(), d)[..., 0].cpu()
                flipped = (on_card < th) != (getattr(aug, field)(x, dc)[..., 0] < th)
                flips = int(flipped.sum())
                clean &= ~flipped.flatten(1).any(1)
                if reach is None:  # the flip reaches its whole image
                    keep &= ~flipped.flatten(1).any(1)[:, None, None]
                else:  # away from each flip by more than its reach
                    keep = torch.nn.functional.max_pool2d(flipped[:, None].float(), 2 * reach + 1, 1, reach)[:, 0] == 0
            if not keep.any():
                raise RuntimeError(f"the photometric stage {name}: every image holds a flipped threshold pixel")
            err = diff[keep].max().item()
            exact = name in ("event_noise", "event_lines", "fill_black")
            log(f"stack {name} at {b}x{h}x{w}: card vs CPU max |err| {err:.3g} (limit {0.0 if exact else STACK_TOL}; "
                f"{flips} flipped threshold pixels, limit {STACK_FLIP_BAR} of {b * h * w}; {int(keep.sum())} pixels "
                f"compared); card {card_s * 1e3:.2f} ms with its first calls")
            if err > (0.0 if exact else STACK_TOL) or flips > STACK_FLIP_BAR * b * h * w:
                raise RuntimeError(f"the photometric stage {name} on the card disagrees with the CPU: {err}, {flips}")
            x = want
        if not clean.any():
            raise RuntimeError(f"the stack {'+'.join(names)}: every image holds a flipped threshold pixel")
        whole_err = (aug.apply_stack(images, names, draws).cpu() - x)[clean].abs().max().item()
        limit = 0.0 if names == aug.EVENT_STACK else STACK_TOL
        ms = time_ms(lambda: aug.apply_stack(images, names, draws), 3)
        msg = (f"stack {'+'.join(names)}: {ms:.3f} ms a batch of {b} at {h}x{w} on the card (CUDA events, draws "
               f"given); the whole stack card vs CPU max |err| {whole_err:.3g} on {int(clean.sum())} of {b} images "
               f"(limit {limit})")
        if names == aug.SPEEDPLUS_STACK:
            big = images.repeat(8 // b, 1, 1, 1)
            draws8 = aug.sample_stack(aug.stack_generator(42, 1, images.device), big.shape[0], h, w, names)
            msg += f"; {time_ms(lambda: aug.apply_stack(big, names, draws8), 3):.3f} ms a batch of {big.shape[0]}"
        log(msg)
        if whole_err > limit:
            raise RuntimeError(f"the stack {'+'.join(names)} on the card differs from the CPU's: {whole_err}")


def dvs_scene(m, root: str, exposure: float, num_frames: int | None = None):
    """The DVS pipeline's inputs under ``root``: ``make_synthetic_scene
    render`` (1280x720, its defaults; ``num_frames`` frames when given) into
    ``root/scene``, then its GT into ``root/gt``: ``make_synthetic_scene gt``
    on the event frames of a ``tools.v2e`` probe at the pipeline's settings
    (``clean``, a duration exposure of ``exposure``, no SloMo), whose stems
    the pipeline's own v2e run repeats. The probe's output is deleted.
    Returns (paths, seconds a stage, the probe's event frames)."""
    import os
    import shutil

    scene = os.path.join(root, "scene")
    paths = {"scene": scene, "frames": os.path.join(scene, "frames"), "gt": os.path.join(root, "gt"),
             "landmarks": os.path.join(scene, "landmarks.csv"),
             "calibration": os.path.join(scene, "calibration.json")}
    seconds = {}
    t0 = time.perf_counter()
    m.make_synthetic_scene.main(["render", "--output-dir", scene]
                                + ([] if num_frames is None else ["--num-frames", str(num_frames)]))
    seconds["render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = m.v2e.main(["-i", paths["frames"], "-o", os.path.join(root, "probe"), "--dvs_params", "clean",
                        "--dvs_exposure", "duration", str(exposure)])
    seconds["v2e probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.make_synthetic_scene.main(["gt", "--scene-dir", scene, "--event-frames-dir",
                                 os.path.join(probe.output_folder, "event-frames"), "--gt-dir", paths["gt"]])
    seconds["gt"] = time.perf_counter() - t0
    shutil.rmtree(probe.output_folder)
    return paths, seconds, probe.frame_times.shape[0]


def dvs_phase(torch, m, dev, card):
    """The DVS training pipeline on the card: a rendered 1280x720 scene, its
    GT from a v2e probe, then ``tools.train_pipeline_dvs`` in process (v2e
    at one exposure, the split, the COCO conversion, the no-preset X101
    detector at 768 and batch 8, the events-preset HRNet); the photometric
    stacks card against CPU at 768^2 and 2 detector updates with the event
    stack. Returns the K1, K2, K2b and K4 rows on the pipeline's own inputs
    and its launch counts."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        paths, seconds, n_event_frames = dvs_scene(m, root, DVS_EXPOSURE, DVS_FRAMES)
        work = os.path.join(root, "work")

        cfg = m.rcnn.FASTER_RCNN_X101_SPACECRAFT
        batch = 8
        n_train, n_nms = batch * cfg.roi.batch_size_per_image, cfg.rpn.pre_nms_topk_train
        k1 = Capture(*m.kernels["K1"][:2])
        k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[1].shape[0] == n_train)
        k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[3].shape[0] == n_train)
        k4 = Capture(m.nms, "nms_mask_sorted", keep=lambda a: a[0].shape[1] == n_nms)
        det_steps = Timed(m.train_detector, "make_detection_train_step", factory=True, keep=True)
        lm_steps = Timed(m.train_landmarks, "make_train_step", factory=True, keep=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with k1, k2, k2b, k4, det_steps, lm_steps:
            reset_counts(m)
            out = m.train_pipeline_dvs.main([
                "--frames-dir", paths["frames"], "--gt-dir", paths["gt"], "--landmarks-file", paths["landmarks"],
                "--work-dir", work, "--exposures", str(DVS_EXPOSURE), "--detector-iters", str(DVS_DET_ITERS),
                "--landmark-epochs", str(DVS_LM_EPOCHS)])
            sync()
            launches = read_counts(m)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        seconds.update(out.seconds)
        det_losses = [r["loss_total"].item() for r in det_steps.results]
        lm_losses = [r["loss"].item() for r in lm_steps.results]
        split_dir = out.event_dirs[0] + "_split"
        counts = check_coco_dicts(m, out.dict_dirs[0], split_dir)
        ckpts = {name: sorted(os.listdir(os.path.join(d, "checkpoints")))
                 for name, d in (("detector", out.detector_dir), ("landmarks", out.landmarks_dir))}
        log(f"dvs pipeline (train_pipeline_dvs on {card}): {DVS_FRAMES} rendered 1280x720 frames, exposure "
            f"{DVS_EXPOSURE} s -> {n_event_frames} event frames, split {json.dumps(counts)}; the "
            f"no-preset detector (X101-32x8d FPN, 768^2, batch {batch}, ROI batch {cfg.roi.batch_size_per_image}, "
            f"pooler {cfg.roi.pooler_impl}) for {DVS_DET_ITERS} steps: {[round(v, 4) for v in det_steps.ms]} ms, "
            f"loss_total {[round(v, 5) for v in det_losses]}; the events preset for {DVS_LM_EPOCHS} epoch: steps "
            f"{[round(v, 4) for v in lm_steps.ms]} ms, loss {[round(v, 6) for v in lm_losses]}; checkpoints "
            f"{json.dumps(ckpts)}; stage seconds {json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
            f"peak memory {peak_gb:.4f} GB; launches {json.dumps(launches)}")
        if len(det_losses) != DVS_DET_ITERS or not all(math.isfinite(v) for v in det_losses + lm_losses) \
                or not lm_losses:
            raise RuntimeError(f"dvs: a loss is not finite or a step is missing: {det_losses} {lm_losses}")
        for key in ("K1", "K2", "K2b", "K4"):
            if launches[key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the DVS training pipeline")
        for name, d in (("detector", out.detector_dir), ("landmarks", out.landmarks_dir)):
            if not any(os.path.exists(os.path.join(d, "checkpoints", c, "model.npz")) for c in ckpts[name]):
                raise RuntimeError(f"dvs: the {name} trainer wrote no model.npz")
        rows = [crop_row(torch, m, dev, k1.calls[-1], "crop_bilinear (dvs pipeline: train_landmarks validate, "
                                                      "event frames)"),
                pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (dvs pipeline: train_detector no preset, "
                                                   f"{n_train} ROIs, {cfg.roi.pooler_impl} read window)"),
                pooler_backward_row(torch, m, k2b.calls[-1], f"roi_align_multilevel_backward (dvs pipeline: "
                                                             f"{n_train} ROIs, bf16 gradient)")]
        rows += nms_rows(torch, m, dev, [k4.calls[-1]], "dvs pipeline: ")
        del k1, k2, k2b, k4, det_steps, lm_steps

        # the photometric stacks on two of the pipeline's training frames, letterboxed as the trainer feeds them
        t0 = time.perf_counter()
        examples = m.detection_dataset.DetectionExamples(os.path.join(out.dict_dirs[0], "synthetic_train.json"),
                                                         os.path.join(split_dir, "train"))
        images = next(m.detection_dataset.detection_batches(examples, STACK_BATCH, (STACK_SIZE, STACK_SIZE),
                                                            train=False, augment=False, device=dev,
                                                            num_workers=0))["image"]
        check_stacks_against_cpu(torch, m, images)
        seconds["stacks check"] = time.perf_counter() - t0
        # two detector updates with the event stack on the pipeline's training split
        t0 = time.perf_counter()
        aug_steps = Timed(m.train_detector, "make_detection_train_step", factory=True, keep=True)
        with aug_steps:
            m.train_detector.main(["--train-json", os.path.join(out.dict_dirs[0], "synthetic_train.json"),
                                   "--image-dir", os.path.join(split_dir, "train"), "--output",
                                   os.path.join(root, "det_event_augs"), "--max-iter", str(DVS_AUG_ITERS),
                                   "--batch-size", str(batch), "--photometric-augs", "event"])
        aug_losses = [r["loss_total"].item() for r in aug_steps.results]
        seconds["train_detector --photometric-augs event"] = time.perf_counter() - t0
        log(f"train_detector --photometric-augs event ({DVS_AUG_ITERS} steps, no preset, batch {batch}): steps "
            f"{[round(v, 4) for v in aug_steps.ms]} ms, loss_total {[round(v, 5) for v in aug_losses]}")
        if len(aug_losses) != DVS_AUG_ITERS or not all(math.isfinite(v) for v in aug_losses):
            raise RuntimeError(f"dvs: the event-stack detector steps failed: {aug_losses}")
        del examples, images
    log(f"dvs phase: {time.perf_counter() - t_phase:.1f} s (stage seconds "
        f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})})")
    return rows, launches


LIB_TTA_BATCH, LIB_TTA_HW, LIB_TTA_SCALES, LIB_TTA_MAX_DETS = 8, 800, (1.0, 0.8), 100
LIB_REGNET_BATCH, LIB_REGNET_HW = 4, 800
LIB_DEFORM_SHAPE = (4, 100, 100, 256)  # (B, H, W, C): C 256 -> 256, 3x3, stride 1
LIB_ROT_N, LIB_ROT_THRESH, LIB_ROT_EVAL_IMAGES = 2000, 0.7, 8
LIB_ASPP_SHAPE = (2, 64, 128, 2048)  # (B, H, W, C): DeepLabV3's 2048 -> 256 at dilations 6, 12, 18
LIB_TRACK_FRAMES = 16
LIB_HOOK_STEPS, LIB_HOOK_SCORES = 6, (0.2, 0.5, 0.3, 0.5, 0.4)  # the EvalHook's metric by iteration: best at 1
LIB_PBN_BATCHES, LIB_PBN_BATCH = 4, 4
LIB_TRACE_KERNELS = ("roi_align_ml_kernel", "nms_mask_sorted_kernel")  # K2's and K4's __global__ functions


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, the same over max(1, |want|.max()))."""
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def library_tta(torch, m, dev, card):
    """TTA around ``config_1``'s X101-32x8d Faster R-CNN (bf16, seeded
    weights, 100 detections an image) on 8 seeded uint8 800^2 frames, scales
    1.0 and 0.8 with the flip: four detector calls (800^2, its flip, 640^2
    float32, its flip), then one class-aware NMS over 8 x 400 candidates
    (K4). Counters reset just before the timed call and read just after;
    returns the rows of K2 on the 640^2 view's box head and K4 on the
    merge, the launches and the merged detections."""
    cfg = m.zoo.DETECTOR_PRESETS["config_1"].config
    det = m.rcnn.GeneralizedRCNN(cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(71))
    gen = torch.Generator(device=dev).manual_seed(71)
    frames = torch.randint(0, 256, (LIB_TTA_BATCH, LIB_TTA_HW, LIB_TTA_HW, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    view_ms = []

    def infer(images):
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = det(images)
        sync()
        view_ms.append(((time.perf_counter() - t0) * 1e3, tuple(images.shape[1:3]), str(images.dtype)))
        return out

    run = m.tta.make_tta_inference(infer, scales=LIB_TTA_SCALES, flip=True, max_dets=LIB_TTA_MAX_DETS)
    with torch.no_grad():
        run(frames)  # cuDNN's first calls at both sizes
    view_ms.clear()
    side = int(round(LIB_TTA_HW * LIB_TTA_SCALES[1]))
    n_merge = 2 * len(LIB_TTA_SCALES) * cfg.roi.detections_per_image
    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[0][0].shape[1] == side // 4)
    k4 = Capture(m.nms, "nms_mask_sorted", keep=lambda a: tuple(a[0].shape[:2]) == (LIB_TTA_BATCH, n_merge))
    with k2, k4, torch.no_grad():
        reset_counts(m)
        sync()
        t0 = time.perf_counter()
        out = run(frames)
        sync()
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(m)
    views = sum(v[0] for v in view_ms)
    valid = out["valid"]
    insts = m.structures.instances_from_detections(out)
    counts = [int(i.num_instances()) for i in insts]
    log(f"library: TTA on {card}: config_1's X101-32x8d FPN (bf16 over float32, seeded) on {LIB_TTA_BATCH} uint8 "
        f"{LIB_TTA_HW}^2 frames, scales {LIB_TTA_SCALES} with the flip: {total_ms:.4f} ms the call; the detector "
        f"calls {[(round(ms, 4), hw, dt) for ms, hw, dt in view_ms]} ms ({views:.4f} in all = "
        f"{total_ms / view_ms[0][0]:.3f} x the first view's batch); resizes, flips and the merge of "
        f"{LIB_TTA_BATCH}x{n_merge} candidates {total_ms - views:.4f} ms; kept a frame {valid.sum(1).tolist()}; "
        f"Instances counts {counts}; launches {json.dumps(launches)}")
    boxes = out["boxes"][valid]
    if len(view_ms) != 4 or [v[1] for v in view_ms] != [(LIB_TTA_HW,) * 2] * 2 + [(side, side)] * 2:
        raise RuntimeError(f"TTA ran other views: {view_ms}")
    if not (bool(torch.isfinite(out["boxes"]).all()) and valid.any() and boxes.min() >= 0
            and boxes.max() <= LIB_TTA_HW):
        raise RuntimeError("TTA's merged boxes are not finite boxes in the frame")
    if counts != valid.sum(1).tolist() or any(len(i.to_numpy()["boxes"]) != c for i, c in zip(insts, counts)):
        raise RuntimeError(f"Instances disagree with valid: {counts}")
    scores = torch.where(valid, out["scores"], torch.full_like(out["scores"], -1.0))
    if bool((scores[:, 1:] > scores[:, :-1]).any()):
        raise RuntimeError("TTA's merged scores are not in descending order")
    for key in ("K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by TTA")
    (k4_args, _), = k4.calls
    rows = [pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (library: TTA's {side}^2 flipped view's box "
                                               f"head, {k2.calls[-1][0][1].shape[0]} ROIs, windowed read window)"),
            nms_row(torch, m, dev, k4_args, f"nms_mask_sorted (library: TTA merge {LIB_TTA_BATCH}x{n_merge})")]
    return rows, launches, out


def library_regnet(torch, m, dev, card):
    """RegNetX-400MF and RegNetY-400MF: at 800^2, batch 4, bf16, the
    forward timed and its peak memory read; in float32 at 224^2, batch 2,
    the card against the CPU within 1e-4 of each feature's scale."""
    for name, cfg in (("RegNetX-400MF", m.regnet.REGNETX_400MF), ("RegNetY-400MF", m.regnet.REGNETY_400MF)):
        model = m.regnet.RegNet(cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(72))
        x = torch.randn(LIB_REGNET_BATCH, LIB_REGNET_HW, LIB_REGNET_HW, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(72)) * 50
        with torch.no_grad():
            model(x)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            feats = model(x)
            sync()
            peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
            ms = time_ms(lambda: model(x), 10)
        flops = conv_flops(torch, m, [model], lambda: model(x))
        finite = all(bool(torch.isfinite(f).all()) for f in feats.values())
        cpu = m.regnet.RegNet(cfg, device="cpu", generator=torch.Generator().manual_seed(72))
        card32 = m.regnet.RegNet(cfg, device=dev, generator=torch.Generator().manual_seed(72))
        x32 = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(73)) * 50
        with torch.no_grad():
            want, got = cpu(x32), card32(x32.to(dev))
        errs = {k: rel_err(got[k], want[k]) for k in want}
        log(f"library: {name} (depths {cfg.depths}, widths {cfg.widths}, group width {cfg.group_width}, SE "
            f"{cfg.se_ratio}) on {card}: bf16 at {LIB_REGNET_HW}^2, batch {LIB_REGNET_BATCH}: {ms:.4f} ms a forward "
            f"({flops / 1e12:.4f} TFLOP = {flops / ms / 1e9:.2f} TFLOP/s), peak {peak_gb:.4f} GB above the "
            f"{held / 1e9:.4f} held; features {({k: tuple(v.shape) for k, v in feats.items()})} finite {finite}; "
            f"float32 224^2 batch 2 card vs CPU (max abs, over scale; bar 1e-4 of scale): "
            f"{json.dumps({k: [round(e, 9) for e in v] for k, v in errs.items()})}")
        if not finite or any(r > 1e-4 for _, r in errs.values()):
            raise RuntimeError(f"{name}: features not finite or card vs CPU off: {errs}")
        with torch.no_grad():
            profile_call(torch, lambda: model(x), f"{name} forward (bf16 {LIB_REGNET_HW}^2, batch {LIB_REGNET_BATCH})")
        del model, feats, cpu, card32


def library_deform(torch, m, dev, card):
    """``deform_conv2d`` v2, C 256 -> 256, 3x3, stride 1, on (4, 100, 100,
    256) float32 with seeded offsets of up to +-3 px (taps across the
    edges) and masks in (0, 2): the card against the CPU within 1e-4 of
    the output's scale, timed, the sampled tensor's bytes and the peak."""
    b, h, w, c = LIB_DEFORM_SHAPE
    gen = torch.Generator().manual_seed(74)
    x = torch.randn(b, h, w, c, generator=gen)
    off = torch.rand(b, h, w, 18, generator=gen) * 6 - 3
    mask = torch.rand(b, h, w, 9, generator=gen) * 2
    kernel = torch.randn(3, 3, c, c, generator=gen) / math.sqrt(9 * c)
    want = m.deform_conv.deform_conv2d(x, off, kernel, mask)
    args = [a.to(dev) for a in (x, off, kernel, mask)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = m.deform_conv.deform_conv2d(*args)
    sync()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    err, rel = rel_err(got, want)
    ms = time_ms(lambda: m.deform_conv.deform_conv2d(*args), 10)
    sampled = b * h * w * 9 * c * 4
    flops = 2.0 * b * h * w * 9 * c * c
    tap_y = torch.arange(h, dtype=torch.float32)[:, None, None] + torch.tensor([-1.0, 0.0, 1.0]).repeat_interleave(3)
    edge = float((off.reshape(b, h, w, 9, 2)[..., 0] + tap_y < 0).float().mean())
    log(f"library: deform_conv2d v2 on {card}: {tuple(x.shape)} float32, C {c} -> {c}, 3x3, stride 1, offsets "
        f"U(-3, 3) px ({edge:.4f} of the taps above row 0), masks U(0, 2): {ms:.4f} ms ({flops / ms / 1e9:.2f} "
        f"TFLOP/s of the product), the sampled (B, H, W, 9, C) tensor {sampled} bytes ({sampled / 1e6:.1f} MB), "
        f"peak {peak_gb:.4f} GB above the inputs; card vs CPU max abs {err:.3g} = {rel:.3g} of scale (bar 1e-4)")
    if rel > 1e-4 or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"deform_conv2d: card vs CPU {rel} of scale")


def clustered_rboxes_t(torch, n: int, seed: int, hw: float = 800.0):
    """``n`` rotated boxes (cx, cy, w, h, angle_deg) in 8-box clusters:
    the cluster's box moved by N(0, 3) px, scaled by U(0.8, 1.2) a side,
    turned by N(0, 10) degrees; and U(0, 1) scores."""
    g = torch.Generator().manual_seed(seed)
    k = n // 8
    centres = torch.stack([torch.rand(k, generator=g) * hw, torch.rand(k, generator=g) * hw,
                           10 + torch.rand(k, generator=g) * 70, 10 + torch.rand(k, generator=g) * 70,
                           torch.rand(k, generator=g) * 180 - 90], 1)
    boxes = centres.repeat_interleave(8, 0)
    boxes[:, :2] += torch.randn(n, 2, generator=g) * 3
    boxes[:, 2:4] *= 0.8 + torch.rand(n, 2, generator=g) * 0.4
    boxes[:, 4] += torch.randn(n, generator=g) * 10
    return boxes, torch.rand(n, generator=g)


def library_rotated(torch, m, dev, card):
    """``pairwise_iou_rotated`` and ``nms_rotated_mask`` (0.7) on 2,000
    clustered rotated boxes, the card against the CPU (IoU within 1e-5;
    keep-masks equal but for boxes whose IoU lies within 1e-6 of the
    threshold), timed; then ``evaluate_rotated_detections`` on 8 images,
    the card against the CPU (every entry within 1e-9)."""
    rb = m.rotated_boxes
    boxes, scores = clustered_rboxes_t(torch, LIB_ROT_N, 75)
    bc, sc = boxes.to(dev), scores.to(dev)
    t0 = time.perf_counter()
    iou_cpu = rb.pairwise_iou_rotated(boxes, boxes)
    cpu_s = time.perf_counter() - t0
    iou_card = rb.pairwise_iou_rotated(bc, bc)
    err = (iou_card.cpu() - iou_cpu).abs().max().item()
    iou_ms = time_ms(lambda: rb.pairwise_iou_rotated(bc, bc), 3)
    keep_cpu = rb.nms_rotated_mask(boxes, scores, LIB_ROT_THRESH)
    keep_card = rb.nms_rotated_mask(bc, sc, LIB_ROT_THRESH)
    nms_ms = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        rb.nms_rotated_mask(bc, sc, LIB_ROT_THRESH)
        sync()
        nms_ms.append((time.perf_counter() - t1) * 1e3)
    near = int(((iou_cpu - LIB_ROT_THRESH).abs() <= 1e-6).sum())
    differ = int((keep_card.cpu() != keep_cpu).sum())
    kept = int(keep_card.sum())
    log(f"library: rotated boxes on {card}: {LIB_ROT_N} clustered float32 boxes; pairwise_iou_rotated "
        f"{LIB_ROT_N}^2 {iou_ms:.4f} ms on the card ({cpu_s:.3f} s on the CPU), card vs CPU max abs {err:.3g} (bar "
        f"1e-5); nms_rotated_mask at {LIB_ROT_THRESH}: {[round(v, 4) for v in nms_ms]} ms (the IoU on the card, "
        f"one copy of the {LIB_ROT_N}^2 overlap matrix, the greedy walk on the host: "
        f"{min(nms_ms) - iou_ms:.4f} ms past the IoU), {kept} of {LIB_ROT_N} kept; keep-masks card vs CPU differ on "
        f"{differ} boxes; IoUs within 1e-6 of the threshold: {near}")
    if err > 1e-5 or (differ and not near) or not 0 < kept < LIB_ROT_N:
        raise RuntimeError(f"rotated boxes: IoU off by {err}, keep-masks differ on {differ} ({near} near), "
                           f"{kept} kept")
    g = torch.Generator().manual_seed(76)
    dets, gts = [], []
    per = LIB_ROT_N // LIB_ROT_EVAL_IMAGES
    for i in range(LIB_ROT_EVAL_IMAGES):
        gt = boxes[i * per:(i + 1) * per:8]  # one box a cluster: 32 GT boxes an image
        src = gt.repeat(3, 1)
        d = src + torch.randn(src.shape, generator=g) * torch.tensor([4.0, 4.0, 3.0, 3.0, 8.0])
        dets.append({"boxes": d.numpy(), "scores": torch.rand(len(d), generator=g).numpy()})
        gts.append({"boxes": gt.numpy()})
    want = m.coco_eval.evaluate_rotated_detections(dets, gts, device="cpu")
    sync()
    t1 = time.perf_counter()
    got = m.coco_eval.evaluate_rotated_detections(dets, gts, device=dev)
    sync()
    eval_ms = (time.perf_counter() - t1) * 1e3
    diff = max(abs(got[k] - want[k]) for k in want if not (math.isnan(got[k]) and math.isnan(want[k])))
    log(f"library: evaluate_rotated_detections on {card}: {LIB_ROT_EVAL_IMAGES} images of 32 GT and 96 jittered "
        f"detections, {eval_ms:.4f} ms (IoU on the card, matching on the host): "
        f"{json.dumps({k: round(v, 6) for k, v in got.items()})}; card vs CPU max difference {diff:.3g} (bar 1e-9)")
    if diff > 1e-9 or not 0 < got["AP50"] <= 100:
        raise RuntimeError(f"evaluate_rotated_detections: card vs CPU {diff}, {got}")


def library_aspp(torch, m, dev, card):
    """ASPP at DeepLabV3's widths (2048 -> 256, dilations 6, 12, 18) on
    (2, 64, 128, 2048) float32: the card against the CPU within 1e-4 of the
    output's scale, timed."""
    b, h, w, c = LIB_ASPP_SHAPE
    x = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(77))
    cpu = m.extra_layers.ASPP(c, 256, (6, 12, 18), device="cpu", generator=torch.Generator().manual_seed(77))
    card_m = m.extra_layers.ASPP(c, 256, (6, 12, 18), device=dev, generator=torch.Generator().manual_seed(77))
    xc = x.to(dev)
    with torch.no_grad():
        want, got = cpu(x), card_m(xc)
        ms = time_ms(lambda: card_m(xc), 10)
    flops = conv_flops(torch, m, [card_m], lambda: card_m(xc))
    err, rel = rel_err(got, want)
    log(f"library: ASPP on {card}: {tuple(x.shape)} float32 -> {tuple(got.shape)}, dilations 6, 12, 18: {ms:.4f} "
        f"ms ({flops / 1e12:.4f} TFLOP = {flops / ms / 1e9:.2f} TFLOP/s, no TF32); card vs CPU max abs {err:.3g} = "
        f"{rel:.3g} of scale (bar 1e-4)")
    if rel > 1e-4:
        raise RuntimeError(f"ASPP: card vs CPU {rel} of scale")


def library_tracker(torch, m, dev, card, dets):
    """``IouTracker`` over 16 frames of the TTA output's first frame's boxes,
    jittered by N(0, 3) px and drifting 2 px a frame, a tenth dropped a
    frame: the ids on the card equal those of the same run on the CPU."""
    import numpy as np

    base = dets["boxes"][0][dets["valid"][0]].float().cpu().numpy()
    rng = np.random.default_rng(78)
    card_t = m.extra_layers.IouTracker(0.5, 3, device=dev)
    cpu_t = m.extra_layers.IouTracker(0.5, 3, device="cpu")
    ids, ms = [], []
    for f in range(LIB_TRACK_FRAMES):
        boxes = (base + rng.normal(0, 3, base.shape) + 2.0 * f)[rng.uniform(size=len(base)) > 0.1]
        sync()
        t0 = time.perf_counter()
        got = card_t.update(boxes)
        ms.append((time.perf_counter() - t0) * 1e3)
        want = cpu_t.update(boxes)
        if got != want:
            raise RuntimeError(f"IouTracker: frame {f}'s ids on the card differ from the CPU's")
        ids.append(got)
    log(f"library: IouTracker on {card}: {LIB_TRACK_FRAMES} frames of {len(base)} TTA boxes jittered: ids equal to "
        f"the CPU's; {card_t._next_id} track ids issued, {len(card_t.tracks)} live at the end; "
        f"{median(ms):.4f} ms a frame (median)")


def library_hooks(torch, m, dev, card):
    """A ``Trainer`` of 6 ``config_1`` steps (X101-32x8d FPN bf16 at 800^2,
    batch 4, SGD) with ``TraceProfiler`` over steps 2-3, ``MemoryStats``
    every step, an ``EvalHook`` putting a metric each step and a
    ``BestCheckpointer`` on it; counters reset just before, read just
    after. Checks the trace (K2's and K4's kernels in it),
    ``device_mem_gb`` against ``memory_allocated`` at each step and the
    best step in ``best/``."""
    import os
    import tempfile

    tr = m.trainer
    with tempfile.TemporaryDirectory() as out_dir:
        path, examples = detection_scene(torch, m, dev, 4 * LIB_HOOK_STEPS, 79, out_dir, "lib_train")
        args = m.train_detector.parse_args(["--preset", "config_1", "--train-json", path, "--image-dir", out_dir,
                                            "--output", os.path.join(out_dir, "run"),
                                            "--max-iter", str(LIB_HOOK_STEPS)])
        model = m.train_detector.build_model(args, dev)
        opt = m.optim.build_optimizer("sgd", model.parameters(), m.train_detector.build_schedule(args),
                                      weight_decay=1e-4, momentum=0.9)
        state = m.detection_state.DetTrainState(model, opt)
        size = args.input_size
        data = m.detection_dataset.detection_batches(examples, args.batch_size, (size, size), train=True,
                                                     flip=args.flip, device=dev)
        raw = m.detection_state.make_detection_train_step()

        def step_fn(s, batch):
            return raw(s, batch, generator=m.landmark_loop.step_generator(m.train_detector.SAMPLING_SEED, s.step))

        probes = []

        class MemoryProbe(tr.Hook):
            def after_step(self, trainer):
                probes.append((trainer.iteration, torch.cuda.memory_allocated(),
                               trainer.storage.latest().get("device_mem_gb")))

        mgr = m.checkpoint.CheckpointManager(os.path.join(out_dir, "ck"), max_to_keep=1)
        prof = tr.TraceProfiler(os.path.join(out_dir, "trace"), 2, 3)
        hooks = [tr.IterationTimer(), prof, tr.MemoryStats(period=1), MemoryProbe(),
                 tr.EvalHook(1, lambda t: {"score": LIB_HOOK_SCORES[t.iteration]} if t.iteration < len(
                     LIB_HOOK_SCORES) else {}),
                 tr.BestCheckpointer(mgr, "score")]
        trainer = tr.Trainer(step_fn, state, data, hooks, m.metrics.MetricStorage())
        reset_counts(m)
        sync()
        t0 = time.perf_counter()
        trainer.train(0, LIB_HOOK_STEPS)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts(m)
        with open(prof.path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        trace_mb = os.path.getsize(prof.path) / 1e6
        kernels = {k: any(k in nm for nm in names) for k in LIB_TRACE_KERNELS}
        mem_ok = all(gb is not None and gb[0] * 2**30 == alloc and gb[1] == it for it, alloc, gb in probes)
        with open(os.path.join(out_dir, "ck", "best.json")) as f:
            best = json.load(f)
        best_steps = m.checkpoint.CheckpointManager(os.path.join(out_dir, "ck", "best")).steps()
        # the hook sees the scores of iterations 0-4 (the last iteration's evaluation belongs to after_train);
        # a tie is not better, and it saves at the updates done, the iteration + 1
        want_step = 1 + max(range(len(LIB_HOOK_SCORES)), key=lambda i: (LIB_HOOK_SCORES[i], -i))
        log(f"library: Trainer hooks on {card}: {LIB_HOOK_STEPS} config_1 steps (X101-32x8d FPN bf16 {size}^2, batch "
            f"{args.batch_size}) in {wall:.3f} s with TraceProfiler over steps 2-3 ({trace_mb:.1f} MB Chrome trace, "
            f"{len(names)} event names, K2 / K4 kernels in it: {kernels}), MemoryStats every step (device_mem_gb "
            f"{[round(gb[0], 4) for _, _, gb in probes]} GB, equal to memory_allocated / 2^30 at each step: "
            f"{mem_ok}), BestCheckpointer on the EvalHook's score {LIB_HOOK_SCORES}: best.json {best}, best/ "
            f"{best_steps} (want step {want_step}); step ms {trainer.storage.latest()['time'][0] * 1e3:.2f} (the "
            f"last); launches {json.dumps(launches)}")
        if not all(kernels.values()) or not mem_ok or best["step"] != want_step or best_steps != [want_step]:
            raise RuntimeError(f"the trainer's hooks: kernels {kernels}, memory {mem_ok}, best {best} {best_steps}")
        for key in ("K2", "K2b", "K4"):
            if launches[key] == 0:
                raise RuntimeError(f"kernel {key} was not launched by the hooks' trainer")
        del trainer, state, model, opt


def bn_stats(m, model) -> dict:
    """Every ``BatchNorm``'s running mean and var, copied to the host."""
    return {f"{name}.{leaf}": getattr(mod, leaf).detach().cpu().clone() for name, mod in model.named_modules()
            if isinstance(mod, m.layers.BatchNorm) for leaf in ("mean", "var")}


def library_precise_bn(torch, m, dev, card):
    """``recompute_batch_stats`` on the ``events`` HRNet-W32 (float32) at its
    512^2 input over 4 seeded batches of 4: the card against the CPU within
    1e-3 of each statistic's scale, and a second recompute on the card from
    the new state within JAX's own bar (rtol 1e-4, atol 1e-5) of the first."""
    cfg = m.config.get_preset("events")
    hw = tuple(cfg.model.image_size)
    gen = torch.Generator().manual_seed(80)
    batches = [torch.randn(LIB_PBN_BATCH, *hw, 3, generator=gen) for _ in range(LIB_PBN_BATCHES)]
    states = {}
    for where in ("cpu", dev):
        model = m.models.build_landmark_model(cfg.model.name, cfg.model.num_joints, device=where,
                                              generator=torch.Generator().manual_seed(80))
        states[str(where)] = m.train_state.TrainState(model, m.optim.build_optimizer("adam", model.parameters(), 1e-3))
    t0 = time.perf_counter()
    m.trainer.recompute_batch_stats(states["cpu"], [{"image": b} for b in batches])
    cpu_s = time.perf_counter() - t0
    card_batches = [{"image": b.to(dev)} for b in batches]
    state = states[str(dev)]
    sync()
    t0 = time.perf_counter()
    m.trainer.recompute_batch_stats(state, card_batches)
    sync()
    card_ms = (time.perf_counter() - t0) * 1e3
    want, got = bn_stats(m, states["cpu"].model), bn_stats(m, state.model)
    worst = max((rel_err(got[k], want[k])[1], k) for k in want)
    m.trainer.recompute_batch_stats(state, card_batches)
    again = bn_stats(m, state.model)
    repro = all(torch.allclose(again[k], got[k], rtol=1e-4, atol=1e-5) for k in got)
    repro_err = max((again[k] - got[k]).abs().max().item() for k in got)
    log(f"library: PreciseBN on {card}: the events preset's {cfg.model.name} (float32) at {hw}, "
        f"{LIB_PBN_BATCHES} batches of {LIB_PBN_BATCH}: {len(got) // 2} BN layers recomputed in {card_ms:.2f} ms "
        f"({cpu_s:.2f} s on the CPU); card vs CPU worst {worst[0]:.3g} of scale at {worst[1]} (bar 1e-3); a second "
        f"recompute from the new state max abs {repro_err:.3g} off the first, within rtol 1e-4 atol 1e-5: {repro}")
    if worst[0] > 1e-3 or not repro:
        raise RuntimeError(f"PreciseBN: card vs CPU {worst}, reproduced {repro}")
    del states, state


def library_phase(torch, m, dev, card):
    """The rest of the detection library and the trainer's hooks on the
    card: TTA around config_1's detector (K2, K4; its rows), RegNet,
    deformable conv, rotated boxes, ASPP, the tracker, the hooks in a
    config_1 Trainer (K2, K2b, K4 counted) and PreciseBN. Yields TTA's
    (rows, launches)."""
    t0 = time.perf_counter()
    rows, launches, dets = library_tta(torch, m, dev, card)
    yield rows, launches
    del rows
    torch.cuda.empty_cache()
    library_tracker(torch, m, dev, card, dets)
    library_regnet(torch, m, dev, card)
    torch.cuda.empty_cache()
    library_deform(torch, m, dev, card)
    torch.cuda.empty_cache()
    library_rotated(torch, m, dev, card)
    library_aspp(torch, m, dev, card)
    torch.cuda.empty_cache()
    library_hooks(torch, m, dev, card)
    torch.cuda.empty_cache()
    library_precise_bn(torch, m, dev, card)
    log(f"library phase: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------- int8 options

# bench.py's int8 R101 form under the JAX package's int8 HRNet options (build_int8_server's flags)
OPTION_FORMS = (
    ("O1 s2d", dict(s2d=True)),
    ("O2 s2d + fused_even3", dict(s2d=True, fused_blocks=True, fused_even3=True)),
    ("O3 merge_fuse", dict(s2d=False, merge_fuse=True)),
    ("O4 fold=2", dict(s2d=False, fold=2)),
)
OPTION_CLIPS = 2
OPTION_DET_SIZE = 768
# the route counters that each option's run must raise above 0, beside K1, K2, K4 and K5a
OPTION_COUNTS = {"O1 s2d": ("K5a padded 4x4", "K5a padded 2x2", "K5a padded 3x3"),
                 "O2 s2d + fused_even3": ("K5a padded 4x4", "K5a padded 2x2", "K5"),
                 "O3 merge_fuse": ("K5a clipped",), "O4 fold=2": ("K5a f32",)}
FOLD_SCALE_ERR, FOLD_CORR = 0.1, 0.995  # the JAX package's fold bars (tests/test_hrnet_int8.py:249-253)
LAZY_SIZE, LAZY_HEATMAP, LAZY_BATCH, LAZY_ITERS = 512, 128, 8, 10
LAZY_CONFIG = """
from spacecraft_pose_estimation_tpu_torch.config import LazyCall as L
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNet, POSE_HRNET_W32
from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer

model = L(HRNet)(config=POSE_HRNET_W32.with_joints({joints}))
optimizer = L(build_optimizer)(name="adam", learning_rate=1e-3)
train = dict(max_iter={iters}, batch_size={batch}, image_size={size}, heatmap_size={heatmap},
             num_joints={joints}, log_period=5, seed=0, out_dir={out_dir!r})
"""


def option_rows(torch, m, label, cap, hrnet):
    """K5a's and K5's rows on the new routes of one option's served clip:
    every call of the route captured in its warm-up, replayed (K5's even3
    calls are those on the chain operands ``hrnet`` packed from ``convs_s2d``)."""
    calls = [cap["K5a"].bound(i) for i in range(len(cap["K5a"].calls))]
    routes = {
        "O1 s2d": [(f"K5a padded {k}x{k}", f"s2d {kind}: every {k}x{k} call of an O1 clip",
                    [a for a in calls if a["padding"] is not None and a["w"].shape[0] == k])
                   for k, kind in ((4, "entry, 256 -> 4x32 channels at stride 2"),
                                   (2, "fuse downs from the even-packed branch 0, padding (1, 0)"),
                                   (3, "even3 3x3 on the packed 64x64x128 map, per op"))],
        "O3 merge_fuse": [("K5a clipped", "merged fuse convs with the per-channel clip: every call of an O3 clip",
                           [a for a in calls if a["lo"] is not None])],
        "O4 fold=2": [("K5a f32", "the f32 epilogue: every fold site of the R101 backbone and the HRNet, and the "
                       "head, in an O4 clip", [a for a in calls if a["out_f32"]])],
    }.get(label, [])
    rows = [dict(conv_sites_row(torch, m, sel, count, f"{name} ({label})"),
                 replaces="spacecraft_pose_estimation_tpu/models/hrnet_int8.py:394") for count, name, sel in routes]
    if label.startswith("O2"):  # K5 on branch 0's even3 chains (4C = 128 channels on the packed map)
        chains = [cap["K5"].bound(i) for i in range(len(cap["K5"].calls))]
        packed = [p[0] for key, p in hrnet._packed.items() if key[0] == "chain_even3" and p is not None]
        even3 = [a for a in chains if any(a["w"] is w for w in packed)]
        run_k = [lambda a=a: m.int8_blocks.basic_block_chain(**a) for a in even3]
        run_p = [lambda a={k: v for k, v in a.items() if k != "wk"}: m.int8_blocks.basic_block_chain_plain(**a)
                 for a in even3]
        totals = [chain_numbers(a) for a in even3]
        shape = tuple(even3[0]["x"].shape)
        rows.append(dict(id="K5", name=f"basic_block_chain (branch 0's even3-packed chains, {shape}: {len(even3)} of "
                         f"the {len(chains)} K5 calls of an O2 clip; launches: every K5 launch)",
                         source="spacecraft_pose_estimation_tpu_torch/csrc/basic_block_chain.cu",
                         replaces="spacecraft_pose_estimation_tpu/ops/pallas_blocks.py:126",
                         run_k=lambda: [f() for f in run_k], run_p=lambda: [f() for f in run_p], run_lib=None,
                         tol="int8", peak=INT8_OPS, numbers=(sum(b for b, _ in totals), sum(o for _, o in totals)),
                         calls=len(even3)))
    return rows


def check_option_heatmaps(torch, m, label, server, per_op, landmarks, crops) -> None:
    """O1-O3 bit-equal to the per-op int8 walk on the served crops; O4 within
    the JAX package's fold bars of it (scale: the float model's heatmaps)."""
    with torch.inference_mode():
        got, walk = server.landmarks(crops), per_op(crops)
        ref = landmarks(m.pipeline.normalize_crops(crops)).float()
    sync()
    err = (got - walk).abs().max().item()
    if not label.startswith("O4"):
        log(f"int8 options {label}: heatmaps on {crops.shape[0]} served crops vs the per-op walk: max_abs_err {err} "
            f"(limit 0, torch.equal)")
        if not torch.equal(got, walk):
            raise RuntimeError(f"int8 options {label}: the heatmaps differ from the per-op walk by {err}")
        return
    scale = ref.abs().max().item() + 1e-9
    corr = torch.corrcoef(torch.stack([got.flatten(), walk.flatten()]))[0, 1].item()
    log(f"int8 options {label}: heatmaps vs the per-op walk: max |fold - walk| / scale {err / scale:.6g} (limit "
        f"{FOLD_SCALE_ERR}), correlation {corr:.6f} (limit {FOLD_CORR}); vs the bf16 model: max |fold - f32| / scale "
        f"{(got - ref).abs().max().item() / scale:.6g}, walk {(walk - ref).abs().max().item() / scale:.6g}")
    if not (err / scale < FOLD_SCALE_ERR and corr > FOLD_CORR):
        raise RuntimeError(f"int8 options {label}: fold outside the JAX bars: {err / scale}, correlation {corr}")


def option_times(torch, label, models, crops) -> dict[str, float]:
    """Device ms (CUDA events, 5 calls after a warm one) of each int8 HRNet in
    ``models`` on the served crops, timed in turns (a, b, b, a ...): the
    option's, the per-op walk's and, with O1, the served form's (FUSED)."""
    times: dict[str, list] = {name: [] for name in models}
    with torch.inference_mode():
        for name in list(models) + list(models)[::-1]:
            times[name].append(time_ms(lambda f=models[name]: f(crops), 5))
    out = {name: min(v) for name, v in times.items()}
    log(f"int8 options {label}: HRNet-W32 on {crops.shape[0]} served 512^2 crops, ms by CUDA events (the lesser "
        f"of two turns of 5 calls): " + ", ".join(f"{name} {v:.4f}" for name, v in out.items()))
    return out


def lazy_train(torch, m, dev, card) -> None:
    """``tools.lazyconfig_train`` at full width: a config file naming HRNet-W32
    (11 joints), 512^2 -> 128^2 synthetic batches of 8, Adam 1e-3, 10
    iterations; finite losses, and the checkpoint's .npz through
    ``evaluate.load_landmark_model`` giving the trained model's heatmaps."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "lazy")
        path = os.path.join(tmp, "lazy_config.py")
        with open(path, "w") as f:
            f.write(LAZY_CONFIG.format(joints=NUM_JOINTS, iters=LAZY_ITERS, batch=LAZY_BATCH, size=LAZY_SIZE,
                                       heatmap=LAZY_HEATMAP, out_dir=out_dir))
        lct = m.lazyconfig_train
        ns = lct.load_lazy_config(path)
        train_cfg = lct.apply_overrides(dict(ns["train"]), ["max_iter", str(LAZY_ITERS)])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loader = lct.build(ns, train_cfg, dev)
        losses = lct.run(state, loader, train_cfg)
        sync()
        wall = time.perf_counter() - t0
        log(f"lazyconfig_train (HRNet-W32, {NUM_JOINTS} joints, {LAZY_SIZE}^2 -> {LAZY_HEATMAP}^2, batch {LAZY_BATCH}, "
            f"float32, Adam 1e-3, {LAZY_ITERS} iterations) on {card}: {wall:.4f} s with the build and the checkpoint; "
            f"losses {[round(v, 6) for v in losses]}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.4f} GB")
        if len(losses) != LAZY_ITERS or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"lazyconfig_train: losses {losses}")
        npz = os.path.join(out_dir, str(LAZY_ITERS), "model.npz")
        loaded = m.evaluate.load_landmark_model(npz, "pose_hrnet", NUM_JOINTS, torch.float32, dev)
        images = loader(LAZY_ITERS)["image"]
        state.model.eval()
        with torch.inference_mode():
            err = (loaded(images) - state.model(images)).abs().max().item()
        log(f"lazyconfig_train: the checkpoint's .npz ({os.path.getsize(npz)} bytes) through "
            f"evaluate.load_landmark_model: heatmaps on {images.shape[0]} images {err} from the trained model's "
            f"(limit 0)")
        if err != 0:
            raise RuntimeError(f"lazyconfig_train: the checkpoint gives other heatmaps: {err}")


def options_phase(torch, m, dev, card):
    """``bench.py``'s int8 R101 form at full width under each of the int8
    HRNet's options O1-O4 (``OPTION_FORMS``; O1 calibrates its own trees with
    s2d, the others serve them): 2 clips each, counters reset just before
    and read just after; the heatmaps on the served crops held to the card's
    per-op walk; the new routes' rows. Then ``tools.lazyconfig_train``.
    Yields (rows, launches) per option."""
    t_phase = time.perf_counter()
    det_cfg, hr_cfg, config = m.rcnn.FASTER_RCNN_R101_SERVING_1OBJ, m.hrnet.POSE_HRNET_W32, m.serving.SERVING_PIPELINE
    detector = m.rcnn.GeneralizedRCNN(det_cfg, dtype=torch.bfloat16, device=dev,
                                      generator=torch.Generator().manual_seed(0))
    landmarks = m.hrnet.HRNet(hr_cfg.with_joints(NUM_JOINTS), dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(1))
    lm3d = torch.randn(NUM_JOINTS, 3, generator=torch.Generator().manual_seed(2))
    K = torch.tensor([[2988.6, 0, 960.0], [0, 2988.3, 600.0], [0, 0, 1]])
    clip = DET_BATCH * DET_EVERY
    gd = torch.Generator(device=dev).manual_seed(3)
    clips = [torch.randint(0, 256, (clip, *FRAME_HW, 3), dtype=torch.uint8, device=dev, generator=gd)
             for _ in range(OPTION_CLIPS + 1)]
    trees = {}
    for label, flags in OPTION_FORMS:
        t0 = time.perf_counter()
        server = m.serving.build_int8_server(detector, landmarks, lm3d, K, torch.zeros(5), config, det_every=DET_EVERY,
                                             det_size=OPTION_DET_SIZE, **trees, **flags)
        sync()
        if not trees:
            trees = dict(backbone_q=server.backbone_q, hrnet_q=server.landmarks.q)
            log(f"int8 options: build_int8_server calibrated the backbone and the HRNet with s2d on the card in "
                f"{time.perf_counter() - t0:.2f} s; {len(server.landmarks.q['convs_s2d'])} packed sites")
        cap = {key: Capture(*m.kernels[key][:2]) for key in ("K1", "K5a", "K5")}
        with contextlib.ExitStack() as stack:
            for c in cap.values():
                stack.enter_context(c)
            server(clips[0])  # warm-up, and the kernels' inputs
            sync()
        reset_counts(m)
        t0 = time.perf_counter()
        outs = [server(frames) for frames in clips[1:]]
        sync()
        seconds = time.perf_counter() - t0
        launches = read_counts(m)
        log(f"int8 options {label} ({json.dumps(flags)}): {OPTION_CLIPS} clips x {clip} frames of {FRAME_HW[1]}x"
            f"{FRAME_HW[0]} in {seconds:.4f} s = {OPTION_CLIPS * clip / seconds:.2f} frames/s; launches "
            f"{json.dumps(launches)}")
        for key in ("K1", "K2", "K4", "K5a") + OPTION_COUNTS[label]:
            if launches[key] == 0:
                raise RuntimeError(f"int8 options {label}: {key} was not launched by the serving run")
        for out in outs:
            for key in ("R", "t", "quat", "keypoints"):
                if not torch.isfinite(out[key]).all():
                    raise RuntimeError(f"int8 options {label}: served {key} is not finite")
        crops = m.warp.crop_bilinear(*cap["K1"].calls[0][0])
        per_op = m.hrnet_int8.HRNetInt8(server.landmarks.config, server.landmarks.q, fold_normalize=True, device=dev,
                                        s2d=False)
        check_option_heatmaps(torch, m, label, server, per_op, landmarks, crops)
        models = {"option": server.landmarks, "per-op walk": per_op}
        if label.startswith("O1"):  # the served int8 form's HRNet on the same crops
            models["served fused form"] = m.hrnet_int8.HRNetInt8(server.landmarks.config, server.landmarks.q,
                                                                 fold_normalize=True, device=dev, s2d=False, **FUSED)
        option_times(torch, label, models, crops)
        del models
        rows = option_rows(torch, m, label, cap, server.landmarks)
        del server, per_op, crops, outs
        yield rows, launches
        del rows, cap
        torch.cuda.empty_cache()
    del trees, detector, landmarks
    torch.cuda.empty_cache()
    lazy_train(torch, m, dev, card)
    log(f"int8 options phase: {time.perf_counter() - t_phase:.1f} s")


TOOLS_OOM_ROW_GIB = 12  # retry_if_oom's probe: 12 GiB a row of a lead of 8, 96 GiB in all, more than the card holds
TOOLS_OOM_LEAD = 8
TOOLS_BENCH_FRAMES = 32  # the data task's json: one batch of 32 at least (the iterator drops a short tail)
TOOLS_DP_BATCH, TOOLS_DP_LR = 16, 1e-2  # tests/test_scaling.py's DP step: HRNET_TINY, 3 joints, SGD, 32^2
TOOLS_FLOPS_SIZE = 768  # the served letterbox, as the serving run's conv_flops count


class printed_lines(contextlib.AbstractContextManager):
    """Collect what is printed to standard output while active, as ``lines``."""

    def __enter__(self):
        import io

        self.buf, self.lines = io.StringIO(), []
        self.redirect = contextlib.redirect_stdout(self.buf)
        self.redirect.__enter__()
        return self

    def __exit__(self, *exc):
        self.redirect.__exit__(*exc)
        self.lines = self.buf.getvalue().splitlines()


def tools_oom(torch, m, dev) -> None:
    """``utils.memory.retry_if_oom`` on a real out-of-memory error: the
    function wants 12 GiB a row of its lead; the full call must raise
    ``torch.OutOfMemoryError``, the retry succeed at 2 or 4 parts, and the
    result equal a direct call on chunks of that size."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"tools: retry_if_oom: the card's free memory {free / 2**30:.2f} of {total / 2**30:.2f} GiB; the probe "
        f"wants {TOOLS_OOM_ROW_GIB} GiB a row of {TOOLS_OOM_LEAD}")
    row = TOOLS_OOM_ROW_GIB * 2**30 // 4
    calls, ooms = [], []

    def fill(x):
        calls.append(x.shape[0])
        try:
            buf = torch.empty((x.shape[0], row), dtype=torch.float32, device=dev)
        except torch.OutOfMemoryError:
            ooms.append(x.shape[0])
            raise
        buf.copy_(x[:, :1].expand_as(buf))
        out = buf[:, ::2**20].sum(1) + x.sum(1)
        del buf
        return out

    x = torch.arange(TOOLS_OOM_LEAD * 4, dtype=torch.float32, device=dev).reshape(TOOLS_OOM_LEAD, 4)
    t0 = time.perf_counter()
    got = m.memory.retry_if_oom(fill)(x)
    sync()
    seconds = time.perf_counter() - t0
    chunk = calls[-1]
    log(f"tools: retry_if_oom calls by lead {calls}, out-of-memory at {ooms}, {TOOLS_OOM_LEAD // chunk} parts "
        f"in {seconds:.3f} s")
    if not ooms or ooms[0] != TOOLS_OOM_LEAD or chunk not in (TOOLS_OOM_LEAD // 2, TOOLS_OOM_LEAD // 4):
        raise RuntimeError(f"retry_if_oom: expected one OOM of the full call, then 2 or 4 parts: {calls}, {ooms}")
    want = torch.cat([fill(x[i:i + chunk]) for i in range(0, TOOLS_OOM_LEAD, chunk)])
    if not torch.equal(got, want):
        raise RuntimeError(f"retry_if_oom's result differs from the direct call on chunks of {chunk}")
    del got, want
    torch.cuda.empty_cache()


def demo_scene(torch, m, out_dir: str):
    """One seeded 1920x1200 BGR PNG (dim noise, the 11 landmarks of a
    random body drawn as 9x9 white squares at their projections), its
    ``landmarks.csv`` and ``calibration.json`` (the evaluation's camera),
    and the landmarks' box, x y w h."""
    import os

    import cv2
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(20)
    lm3d = rng.normal(0, 0.5, (NUM_JOINTS, 3))
    h, w = FRAME_HW
    K = np.array([[2988.6, 0, w / 2], [0, 2988.3, h / 2], [0, 0, 1]])
    dist = np.array(EVAL_DIST)
    q = np.array([0.9, 0.2, -0.3, 0.1])
    R = m.geometry.quat_to_dcm(torch.tensor(q / np.linalg.norm(q), dtype=torch.float32)).double().numpy()
    uv = m.coco_io.project_landmarks(lm3d, R, np.array([0.2, -0.1, 9.0]), K, dist)
    frame = rng.integers(0, 48, (h, w, 3)).astype(np.uint8)
    for x, y in np.rint(uv).astype(int):
        frame[max(y - 4, 0):max(y + 5, 0), max(x - 4, 0):max(x + 5, 0)] = 255
    lo, hi = uv.min(0) - 40, uv.max(0) + 40
    paths = {name: os.path.join(out_dir, name) for name in ("frame.png", "landmarks.csv", "calibration.json")}
    cv2.imwrite(paths["frame.png"], frame)
    pd.DataFrame(lm3d, columns=["x", "y", "z"]).to_csv(paths["landmarks.csv"], index=False)
    with open(paths["calibration.json"], "w") as f:
        json.dump({"intrinsics": {"camera_matrix": K.tolist(), "distortion_coefficients": dist.tolist()}}, f)
    return frame, paths, [float(lo[0]), float(lo[1]), float(hi[0] - lo[0]), float(hi[1] - lo[1])]


def tools_demo(torch, m, dev, card, out_dir: str):
    """``tools.demo`` at ``pose_hrnet`` 512^2 (random weights saved through
    the port's ``CheckpointManager``) on one 1920x1200 PNG with landmarks
    and calibration: the command and ``demo.run``, each launching K1 once;
    the keypoints within 1e-3 px of ``make_pose_pipeline`` called directly
    (same frame, weights and generator), R and t finite and equal to it;
    then ``utils.vis.save_debug_images`` on the demo's heatmaps. Returns
    K1's row on the demo's crop and the command's launches."""
    import os

    import cv2
    import numpy as np

    frame, paths, box = demo_scene(torch, m, out_dir)
    model = m.models.build_landmark_model("pose_hrnet", NUM_JOINTS, device=dev, dtype=torch.bfloat16,
                                          generator=torch.Generator().manual_seed(0))
    ck = os.path.join(out_dir, "checkpoints")
    m.checkpoint.CheckpointManager(ck).save(
        1, m.train_state.TrainState(model, m.optim.build_optimizer("adam", model.parameters(), 1e-3)))
    del model
    overlay = os.path.join(out_dir, "demo_out.jpg")
    argv = ["--image", paths["frame.png"], "--checkpoint", ck, "--box", *map(str, box), "--landmarks-file",
            paths["landmarks.csv"], "--calibration-file", paths["calibration.json"], "--output", overlay]
    reset_counts(m)
    sync()
    t0 = time.perf_counter()
    with printed_lines() as printed:
        out_main = m.demo.main(argv)
    sync()
    seconds = time.perf_counter() - t0
    launches = read_counts(m)
    for line in printed.lines:
        log(f"tools: demo printed: {line}")
    drawn = cv2.imread(overlay)
    if drawn is None or drawn.shape != frame.shape:
        raise RuntimeError(f"tools.demo's overlay {overlay} does not decode to a {frame.shape} image")
    model = m.demo.load_model(ck, "pose_hrnet", NUM_JOINTS, dev)
    lm3d = m.coco_io.load_landmarks_csv(paths["landmarks.csv"])
    cam = m.camera.CameraModel.from_calibration_json(paths["calibration.json"], FRAME_HW[1], FRAME_HW[0])
    reset_counts(m)
    with Capture(*m.kernels["K1"][:2]) as cap:
        out_run, drawn_run = m.demo.run(frame, model, box, lm3d, cam, (512, 512))
    sync()
    run_launches = read_counts(m)
    direct = m.pipeline.make_pose_pipeline(
        model, lm3d.astype(np.float32), cam.K.astype(np.float32), cam.dist.astype(np.float32),
        m.pipeline.PipelineConfig(image_size=(512, 512), solver="ransac"))(
        torch.from_numpy(np.ascontiguousarray(frame[..., ::-1]))[None].to(dev),
        torch.tensor([box], device=dev), generator=torch.Generator(device=dev).manual_seed(0))
    kp_err = max(float((o["keypoints"] - direct["keypoints"]).abs().max()) for o in (out_main, out_run))
    pose_err = max(float((o[k] - direct[k]).abs().max()) for o in (out_main, out_run) for k in ("R", "t"))
    log(f"tools: demo (pose_hrnet 512^2 bf16, RANSAC 256) on a {FRAME_HW[1]}x{FRAME_HW[0]} PNG in {seconds:.2f} s "
        f"(the command, the weights' restore and the first call included) on {card}: K1 launches {launches['K1']} "
        f"(command), {run_launches['K1']} (demo.run); keypoints {kp_err:.3g} px from make_pose_pipeline's, R and t "
        f"{pose_err:.3g} apart; mean confidence {float(out_run['confidence'].mean()):.4f}")
    if launches["K1"] != 1 or run_launches["K1"] != 1:
        raise RuntimeError(f"tools.demo: K1 launched {launches['K1']} / {run_launches['K1']} times, not once a call")
    if kp_err > 1e-3 or pose_err > 1e-3:
        raise RuntimeError(f"tools.demo differs from make_pose_pipeline: keypoints {kp_err}, pose {pose_err}")
    for o in (out_main, out_run):
        if not (torch.isfinite(o["R"]).all() and torch.isfinite(o["t"]).all()):
            raise RuntimeError("tools.demo: R or t is not finite")
    if drawn_run.shape != frame.shape or not (drawn_run != frame).any():
        raise RuntimeError("demo.run drew nothing")
    crops = m.warp.crop_bilinear(*cap.calls[0][0]).float()
    hm = out_run["heatmaps"].float()
    joints = m.heatmap.get_max_preds(hm)[0] * (crops.shape[1] / hm.shape[1])
    debug = SimpleNamespace(save_batch_images_gt=True, save_batch_images_pred=True, save_heatmaps_gt=True,
                            save_heatmaps_pred=True)
    prefix = os.path.join(out_dir, "debug", "demo")
    m.vis.save_debug_images(debug, crops, hm, hm, joints, torch.ones(joints.shape[:2]), prefix)
    sizes = {}
    for suffix in ("gt", "pred", "hm_gt", "hm_pred"):
        img = cv2.imread(f"{prefix}_{suffix}.jpg")
        if img is None:
            raise RuntimeError(f"utils.vis.save_debug_images: {prefix}_{suffix}.jpg does not decode")
        sizes[suffix] = list(img.shape)
    log(f"tools: utils.vis.save_debug_images on the demo's crop and heatmaps ({tuple(hm.shape)}): {json.dumps(sizes)}")
    row = crop_row(torch, m, dev, cap.calls[0], "crop_bilinear (tools.demo: one 512^2 crop of a 1920x1200 frame)")
    return row, launches


def tools_benchmark(torch, m, dev, card, out_dir: str) -> None:
    """``tools.benchmark`` on every task at the JAX tool's defaults (train and
    eval: ``pose_hrnet`` 512^2, batch 32; train-det: ``config_1`` at 800^2,
    batch 4, whose run must launch K2, K2b and K4; data: 32 seeded 1280x720
    PNGs of the landmark scene)."""
    import os

    import cv2

    for task in ("train", "eval"):
        with printed_lines() as printed:
            res = m.benchmark.main(["--task", task])
        log(f"tools: benchmark --task {task} on {card}: {printed.lines[-1]} ({json.dumps(res)})")
    reset_counts(m)
    with printed_lines() as printed:
        res = m.benchmark.main(["--task", "train-det", "--model", "config_1", "--input-size", "800", "--batch-size", "4"])
    sync()
    launches = read_counts(m)
    log(f"tools: benchmark --task train-det on {card}: {printed.lines[-1]}; the detector phase's trainer step on one "
        f"repeated batch read {PHASE_READINGS.get('config_1 repeated-batch step ms')} ms; launches "
        f"{json.dumps(launches)}")
    for key in ("K2", "K2b", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"benchmark --task train-det did not launch {key}")
    examples = landmark_scene(torch, m, dev, TOOLS_BENCH_FRAMES, 31, out_dir, "bench")
    for name, img in examples.frames.items():
        cv2.imwrite(os.path.join(out_dir, name), img.cpu().numpy())
    with printed_lines() as printed:
        res = m.benchmark.main(["--task", "data", "--train-json", os.path.join(out_dir, "bench.json"),
                                "--image-dir", out_dir])
    log(f"tools: benchmark --task data ({TOOLS_BENCH_FRAMES} PNGs of {TRAIN_HW[1]}x{TRAIN_HW[0]}, batch 32): "
        f"{printed.lines[-1]}")


def tools_analysis(torch, m, dev) -> None:
    """``model_summary`` of HRNet-W32 at 512^2, and ``flops_of`` of the R101
    backbone + FPN at 768^2, which must equal ``conv_flops`` of the same call."""
    hr = m.models.build_landmark_model("pose_hrnet", NUM_JOINTS, device=dev, dtype=torch.bfloat16,
                                       generator=torch.Generator().manual_seed(0))
    log(f"tools: model_summary(HRNet-W32): {m.analysis.model_summary(hr, torch.zeros(1, 512, 512, 3, device=dev))}")
    del hr
    det = m.rcnn.GeneralizedRCNN(m.rcnn.FASTER_RCNN_R101_SERVING_1OBJ, dtype=torch.bfloat16, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    frame = torch.randint(0, 256, (1, *FRAME_HW, 3), dtype=torch.uint8, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5))
    lb = m.serving.letterbox(frame, TOOLS_FLOPS_SIZE)[0]
    with torch.inference_mode():
        counted = m.analysis.flops_of(det.pyramid, lb)["flops"]
    hooked = conv_flops(torch, m, [det.backbone, det.fpn], lambda: det.pyramid(lb))
    log(f"tools: flops_of(R101 backbone + FPN, {TOOLS_FLOPS_SIZE}^2) {counted:.0f}, conv_flops {hooked:.0f}")
    if counted != hooked:
        raise RuntimeError(f"flops_of {counted} != conv_flops {hooked} on the R101 backbone + FPN")


def tools_parallel(torch, m, dev, card):
    """``parallel`` on the card, NCCL at world size 1: the mesh; a
    ``data_parallel`` train step of ``HRNET_TINY`` equal to the plain step
    within 1e-6 (loss and parameters); a sharded ``RCNN_TINY`` forward
    through ``data_parallel`` equal to the unsharded one (boxes 1e-3,
    ``valid`` equal), K2 and K4 launched; the world-1 gathers; the group
    destroyed. Returns the forward's launches."""
    import dataclasses

    import torch.distributed as dist

    mesh = m.parallel.make_mesh("cuda")
    log(f"tools: make_mesh('cuda'): {mesh}, backend {dist.get_backend()}, world {dist.get_world_size()}")
    g = torch.Generator(device=dev).manual_seed(6)
    batch = {"image": torch.randn(TOOLS_DP_BATCH, 32, 32, 3, device=dev, generator=g),
             "target": torch.rand(TOOLS_DP_BATCH, 8, 8, 3, device=dev, generator=g),
             "target_weight": torch.ones(TOOLS_DP_BATCH, 3, device=dev)}
    cfg = dataclasses.replace(m.hrnet.HRNET_TINY, num_joints=3)
    models, metrics = [], []
    for parallel in (False, True):
        model = m.hrnet.HRNet(cfg, device=dev, generator=torch.Generator().manual_seed(7))
        run = m.parallel.data_parallel(model, mesh) if parallel else model
        state = m.train_state.TrainState(run, m.optim.build_optimizer("sgd", model.parameters(), TOOLS_DP_LR))
        metrics.append(m.train_state.make_train_step()(state, m.parallel.shard_batch(batch, mesh) if parallel else batch))
        models.append(model)
    loss_err = abs(float(metrics[1]["loss"]) - float(metrics[0]["loss"]))
    sd = [mod.state_dict() for mod in models]
    param_err = max(float((sd[1][k] - sd[0][k]).abs().max()) for k in sd[0])
    log(f"tools: data_parallel train step (HRNET_TINY, 3 joints, SGD {TOOLS_DP_LR}, batch {TOOLS_DP_BATCH} at 32^2, "
        f"{dist.get_backend()} world {dist.get_world_size()}) against the plain step: loss {float(metrics[0]['loss']):.6g}, off {loss_err:.3g}; "
        f"parameters and statistics off {param_err:.3g} (bar 1e-6)")
    if loss_err > 1e-6 or param_err > 1e-6:
        raise RuntimeError(f"the data-parallel step differs from the plain step: loss {loss_err}, params {param_err}")
    det, _ = tiny_models(torch, m, dev, torch.float32)
    images = torch.rand(8, 64, 64, 3, device=dev, generator=g) * 255
    with torch.no_grad():
        ref = det(images)
        reset_counts(m)
        out = m.parallel.data_parallel(det, mesh)(m.parallel.shard_batch(images, mesh))
        sync()
    launches = read_counts(m)
    box_err = float((out["boxes"] - ref["boxes"]).abs().max())
    log(f"tools: data_parallel RCNN_TINY forward on 8 sharded 64^2 images: boxes {box_err:.3g} from the unsharded "
        f"forward's, valid equal {bool(torch.equal(out['valid'], ref['valid']))} ({int(ref['valid'].sum())} valid); "
        f"launches {json.dumps(launches)}")
    if box_err > 1e-3 or not torch.equal(out["valid"], ref["valid"]):
        raise RuntimeError(f"the data-parallel detection forward differs: boxes {box_err}")
    for key in ("K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"the data-parallel detection forward did not launch {key}")
    gathered = m.multihost.all_gather_objects({"rank": m.multihost.get_rank()})
    reduced = m.multihost.reduce_dict({"loss": 2.5, "acc": 0.5})
    log(f"tools: all_gather_objects {gathered}, reduce_dict {reduced}")
    if gathered != [{"rank": 0}] or reduced != {"loss": 2.5, "acc": 0.5}:
        raise RuntimeError("the world-1 gathers differ from their no-op results")
    dist.destroy_process_group()


def tools_phase(torch, m, dev, card):
    """The tools, the utils and data parallelism on the card; returns (the
    demo's K1 row, the demo command's launches)."""
    import tempfile

    t_phase = time.perf_counter()
    tools_oom(torch, m, dev)
    with tempfile.TemporaryDirectory() as out_dir:
        row, launches = tools_demo(torch, m, dev, card, out_dir)
        tools_benchmark(torch, m, dev, card, out_dir)
    torch.cuda.empty_cache()
    tools_analysis(torch, m, dev)
    tools_parallel(torch, m, dev, card)
    info = m.collect_env.collect_env_info()
    for line in info.splitlines():
        log(f"tools: collect_env: {line}")
    devices = next(line for line in info.splitlines() if line.startswith("devices "))
    if card.split(",")[0].strip() not in devices:
        raise RuntimeError(f"collect_env_info's device row {devices!r} does not name the card {card!r}")
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s")
    return [row], launches


# --------------------------------------------------------------------------- projects

PROJ_STEPS = 3  # updates of each training path (the first warms cuDNN)
PROJ_POINTS = 10  # PointSup: annotated points an instance
PROJ_CROP, PROJ_FRAME = (512, 1024), (1024, 2048)  # the Cityscapes configs' crops, Cityscapes frames
PROJ_DL_BATCH, PROJ_PD_BATCH = 2, 4  # the configs' 16 (DeepLabV3+ R103) and 32 (Panoptic-DeepLab R52) over 8 cards
PROJ_CLASSES, PROJ_THINGS, PROJ_IGNORE = 19, tuple(range(11, 19)), 255  # Cityscapes: 11 stuff classes, 8 things
PROJ_DL_LR = (0.01, 90000, 1000, 0.001, 0.9)  # warmup_poly_schedule: base lr, max iter, warmup iters, factor, power
PROJ_PD_LR = 1e-3  # Adam, under warmup_poly_schedule(1e-3, 90000)
PIXEL_MEAN, PIXEL_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)  # ImageNet RGB, as the DeepLab configs
# PROJ_P2_RMS: the PointRend heads read the seeded detector's P2 divided by its RMS over the batch (a smoke-only
# step, as the FrozenBN calibration): even calibrated, the random X101 + FPN's P2 is several units in scale, and the
# implicit head's dynamic MLP, whose four layers each scale with the features, then started at a point loss of 90
# and reached NaN at its third SGD step (H100, PR 21)


class FedSelection(contextlib.AbstractContextManager):
    """Patch ``point_rend.top_k_indices`` (every index top-k of the PointRend
    heads). Without ``feed``: record each call's indices. With another run's
    record: compute this run's own, count the calls whose indices differ
    from the record, and return the recorded ones, so that a top-k over
    card-computed values that ranks near-equal values otherwise than the
    CPU does not fork the comparison."""

    def __init__(self, torch, m, feed=None):
        self.torch, self.pr, self.feed, self.record, self.differ = torch, m.point_rend, feed, [], 0

    def __enter__(self):
        self.orig = orig = self.pr.top_k_indices

        def top_k(x, k):
            own = orig(x, k)
            self.record.append(own.cpu())
            if self.feed is None:
                return own
            want = self.feed[len(self.record) - 1]
            self.differ += int(not self.torch.equal(own.cpu(), want))
            return want.to(own.device)

        self.pr.top_k_indices = top_k
        return self

    def __exit__(self, *exc):
        self.pr.top_k_indices = self.orig


def scaled_errors(got: dict, want: dict) -> dict[str, float]:
    """Each entry's max abs error over its own scale (max |want|, at least 1e-6)."""
    return {k: (got[k].float() - w.float()).abs().max().item() / max(w.float().abs().max().item(), 1e-6)
            for k, w in want.items()}


def panoptic_scene(rng, h: int, w: int):
    """A seeded panoptic id map (h, w) and its segments: four horizontal stuff
    bands (classes 0-10) under 12 thing ellipses (classes 11-18) from 4 px
    to a fifth of the frame, so some are under the target generator's small
    area, some occluded or cut by the border; the first is a crowd."""
    import numpy as np

    pan = np.zeros((h, w), np.int64)
    segs = []
    bounds = [0, *np.sort(rng.choice(np.arange(1, h), 3, replace=False)).tolist(), h]
    for i in range(4):
        pan[bounds[i]:bounds[i + 1]] = i + 1
        segs.append({"id": i + 1, "category_id": int(rng.integers(0, 11)), "iscrowd": 0})
    yy, xx = np.ogrid[:h, :w]
    for j in range(12):
        cy, cx, ry, rx = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(4, h / 5), rng.uniform(4, w / 8)
        pan[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 5 + j
        segs.append({"id": 5 + j, "category_id": int(rng.integers(11, 19)), "iscrowd": int(j == 0)})
    return pan, segs


def seg_images(torch, dev, sem_maps, rng):
    """(N, H, W) class maps -> (N, H, W, 3) float32 images on ``dev``: a
    colour a class plus noise, normalized by PIXEL_MEAN and PIXEL_STD."""
    import numpy as np

    palette = rng.uniform(0, 255, (256, 3))
    img = palette[np.asarray(sem_maps)] + rng.normal(0, 20, (*np.shape(sem_maps), 3))
    img = (np.clip(img, 0, 255) - np.array(PIXEL_MEAN)) / np.array(PIXEL_STD)
    return torch.from_numpy(img.astype(np.float32)).to(dev)


def split_step(torch, forward, opt, count: int):
    """One update: ``forward()`` -> loss, zero_grad + backward, ``opt.step``;
    CUDA events around each. Returns (loss, [forward, backward, step] ms)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = forward()
    ev[1].record()
    opt.zero_grad()
    loss.backward()
    ev[2].record()
    opt.step(count)
    ev[3].record()
    sync()
    return loss.item(), [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def train_path(torch, label: str, forward, opt, images: int, card) -> None:
    """PROJ_STEPS updates (``split_step``), their wall ms and images/s (over
    the median of the steps after the first), the last step's split, the
    peak memory, then torch.profiler over one more step: its busy share and
    kernel launches. Raises on a loss that is not finite."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ms, splits, losses = [], [], []
    for i in range(PROJ_STEPS):
        sync()
        t0 = time.perf_counter()
        loss, split = split_step(torch, forward, opt, i)
        ms.append((time.perf_counter() - t0) * 1e3)
        splits.append(split)
        losses.append(loss)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_counts(torch, lambda: split_step(torch, forward, opt, PROJ_STEPS))
    log(f"projects: {label} on {card}: steps {[round(v, 4) for v in ms]} ms (the first with cuDNN's warm-up), "
        f"{images / median(ms[1:]) * 1e3:.2f} images/s; forward / backward / step {[round(v, 4) for v in splits[-1]]} "
        f"ms (CUDA events, the last step); peak memory {peak_gb:.4f} GB ({held_gb:.4f} GB held before); a profiled "
        f"step busy {prof['busy_us']:.0f} of {prof['wall_us']:.0f} us = {prof['busy_us'] / prof['wall_us']:.4f}, "
        f"{prof['kernel_launches']} kernel launches; losses {[round(v, 6) for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"projects: {label}: a loss is not finite: {losses}")


def timed_steps(torch, module, name: str):
    """Wrap ``module.<name>`` (a subdivision step) with CUDA events; returns
    (the list that collects each call's ms after a sync, a restore callable)."""
    spans, orig = [], getattr(module, name)

    def step(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    setattr(module, name, step)
    return spans, lambda: delattr(module, name)


def check_projects_tiny_against_cpu(torch, m) -> None:
    """The projects' tiny paths in float32 (TF32 off) on the card against the
    CPU, from the same seeded parameters on the same inputs and draws:
    PointRend's mask head (training: coarse and point logits, point labels,
    the point loss and its gradients; subdivision inference), the implicit
    head (the same, with its l2), the semantic-segmentation head (the point
    loss, its gradients, inference), PointSup's loss on ``cascade.MaskHead``
    pooled by K2's gather read (and its gradients through K2b's), DeepLabV3+
    on DEEPLAB_TINY (loss, gradients, logits) and both Panoptic-DeepLab heads
    (weighted losses, gradients, outputs): each within 1e-3 of its scale.
    The PointRend heads' top-k selections are the CPU's, fed to the card
    (``FedSelection``; the card's own are counted against them). Then the
    post-processing on the CPU's outputs, given to the card: panoptic map,
    centres and validity equal."""
    import numpy as np

    pr, ps, dl, pd = m.point_rend, m.pointsup, m.deeplab, m.panoptic_deeplab
    rng = np.random.default_rng(91)
    fmap = torch.from_numpy(rng.normal(size=(32, 32, 16)).astype(np.float32))
    boxes = torch.tensor([[8.0, 8.0, 72.0, 96.0], [0.0, 0.0, 128.0, 128.0], [30.0, 50.0, 60.0, 58.0]])
    gt = torch.zeros(3, 128, 128)
    gt[:, 20:90, 20:60] = 1.0
    valid = torch.tensor([1.0, 1.0, 0.0])
    cfg = pr.PointRendConfig(train_num_points=24, subdivision_steps=2, subdivision_num_points=64, fc_dim=32, num_fc=2)
    icfg = pr.PointRendConfig(train_num_points=16, subdivision_steps=2, subdivision_num_points=16, fc_dim=8, num_fc=1)
    draws = pr.point_draws(3, cfg.train_num_points, cfg.oversample_ratio, cfg.importance_sample_ratio, "cpu",
                           torch.Generator().manual_seed(92))
    idraws = {"coords": torch.rand((3, icfg.train_num_points, 2), generator=torch.Generator().manual_seed(93))}
    coarse_seg = torch.from_numpy(rng.normal(size=(2, 16, 16, 5)).astype(np.float32))
    fine_seg = torch.from_numpy(rng.normal(size=(2, 32, 32, 8)).astype(np.float32))
    seg_tgt = torch.from_numpy(rng.integers(0, 5, (2, 64, 64)))
    seg_tgt[0, :8] = 255
    sdraws = pr.point_draws(2, 32, 3.0, 0.75, "cpu", torch.Generator().manual_seed(94))
    levels = {f"p{i + 2}": torch.randn(2, 32 >> i, 48 >> i, 16, generator=torch.Generator().manual_seed(95 + i))
              for i in range(4)}
    sup_boxes = coverage_boxes(torch, 6, 192, torch.Generator().manual_seed(99)).reshape(2, 3, 4)
    sup_boxes[..., 2:] = torch.maximum(sup_boxes[..., 2:], sup_boxes[..., :2] + 4.0)
    sup_pts = sup_boxes[:, :, None, :2] + torch.rand((2, 3, PROJ_POINTS, 2), generator=torch.Generator().manual_seed(
        100)) * 1.2 * (sup_boxes[:, :, None, 2:] - sup_boxes[:, :, None, :2])
    sup_lab = (torch.rand((2, 3, PROJ_POINTS), generator=torch.Generator().manual_seed(101)) > 0.5).float()
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, 5, (2, 64, 64)))
    tgt[0, :8] = PROJ_IGNORE
    wts = torch.from_numpy(rng.uniform(0.5, 3.0, (2, 64, 64)).astype(np.float32))
    ct, cw = torch.rand(2, 64, 64, generator=torch.Generator().manual_seed(102)), (torch.rand(2, 64, 64) > 0.5).float()
    ot = 8 * torch.randn(2, 64, 64, 2, generator=torch.Generator().manual_seed(103))
    ow = (torch.rand(2, 64, 64, generator=torch.Generator().manual_seed(104)) > 0.3).float()
    roi = m.roi_heads.ROIHeadsConfig(num_classes=1)
    out, record, differ = {}, None, 0
    for device in ("cpu", "cuda"):
        to = lambda v: v.to(device)  # noqa: E731
        gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
        res = {}

        def grads(prefix, module):
            res.update({f"{prefix} grad {k}": p.grad for k, p in module.named_parameters() if p.grad is not None})

        with FedSelection(torch, m, record) as sel:
            head = pr.PointRendMaskHead(cfg, 16, device=device, generator=gen(105))
            coarse, pl, lab = head([to(fmap)], to(boxes), gt_masks=to(gt), valid=to(valid), train=True,
                                   draws={k: to(v) for k, v in draws.items()})
            loss = pr.roi_mask_point_loss(pl, lab, None, to(valid))
            loss.backward()
            res.update({"mask head coarse": coarse, "mask head points": pl, "mask head labels": lab,
                        "mask head loss": loss})
            grads("mask head", head)
            ihead = pr.ImplicitPointRendMaskHead(icfg, 16, device=device, generator=gen(106))
            ilog, ilab, il2 = ihead([to(fmap)], to(boxes), gt_masks=to(gt), train=True,
                                    draws={"coords": to(idraws["coords"])})
            iloss = pr.roi_mask_point_loss(ilog, ilab, None, to(valid)) + il2
            iloss.backward()
            res.update({"implicit points": ilog, "implicit labels": ilab, "implicit loss": iloss})
            grads("implicit", ihead)
            shead = pr.PointRendSemSegHead(5, 8, train_num_points=32, subdivision_steps=2, subdivision_num_points=64,
                                           fc_dim=16, num_fc=2, device=device, generator=gen(107))
            _, sloss = shead(to(coarse_seg), [to(fine_seg)], targets=to(seg_tgt), train=True,
                             draws={k: to(v) for k, v in sdraws.items()})
            sloss.backward()
            res["semseg loss"] = sloss
            grads("semseg", shead)
            with torch.no_grad():
                res["mask head inference"] = head([to(fmap)], to(boxes))
                res["implicit inference"] = ihead([to(fmap)], to(boxes))
                res["semseg inference"] = shead(to(coarse_seg), [to(fine_seg)])[0]
        record, differ = (sel.record, differ) if device == "cpu" else (record, sel.differ)
        # PointSup on the cascade's mask head, pooled by K2's gather read (K2b in its backward)
        mhead = m.cascade.MaskHead(16, 1, conv_dim=16, num_convs=2)
        m.layers.init_params(mhead, gen(108))
        mhead.to(device)
        feats = {k: to(v).detach().requires_grad_() for k, v in levels.items()}
        logits = mhead(m.cascade.pool_gather(feats, to(sup_boxes), roi, m.fpn.FPN_STRIDES, 14))
        ploss = ps.mask_rcnn_point_sup_loss(logits, to(sup_boxes).reshape(-1, 4),
                                            to(sup_pts).reshape(-1, PROJ_POINTS, 2),
                                            to(sup_lab).reshape(-1, PROJ_POINTS), None)
        ploss.backward()
        # a level no box pools from gets no gradient from CPU autograd, zeros from K2b
        res.update({"pointsup logits": logits, "pointsup loss": ploss,
                    **{f"pointsup grad {k}": torch.zeros_like(v) if v.grad is None else v.grad
                       for k, v in feats.items()}})
        grads("pointsup", mhead)
        # DeepLabV3+ and the Panoptic-DeepLab heads on DEEPLAB_TINY
        trunk = dl.DeepLabResNet(dl.DEEPLAB_TINY, device=device, generator=gen(109))
        v3p = dl.DeepLabV3PlusHead(5, (16, 128), project_channels=(8,), aspp_channels=16, decoder_channels=(16, 16),
                                   ignore_value=PROJ_IGNORE, device=device, generator=gen(110))
        sem_h = pd.PanopticDeepLabSemSegHead(5, (16, 128), decoder_channels=(16, 16), head_channels=8,
                                             ignore_value=PROJ_IGNORE, device=device, generator=gen(111))
        ins_h = pd.PanopticDeepLabInsEmbedHead((16, 128), decoder_channels=(16, 16), head_channels=8, device=device,
                                               generator=gen(112))
        feats = trunk(to(x))
        _, dls = v3p(feats, to(tgt), train=True)
        _, sls = sem_h(feats, to(tgt), to(wts), train=True)
        _, _, cls_, ols = ins_h(feats, to(ct), to(cw), to(ot), to(ow), train=True)
        for name, value, modules in (("v3+", dls["loss_sem_seg"], (trunk, v3p)),
                                     ("panoptic", sls["loss_sem_seg"] + cls_["loss_center"] + ols["loss_offset"],
                                      (trunk, sem_h, ins_h))):
            for mod in modules:
                mod.zero_grad()
            value.backward(retain_graph=True)
            res[f"{name} loss"] = value
            for i, mod in enumerate(modules):
                grads(f"{name} {i}", mod)
        with torch.no_grad():
            feats = trunk(to(x))
            res["v3+ logits"] = v3p(feats)[0]
            res["panoptic sem"] = sem_h(feats)[0]
            res["panoptic center"], res["panoptic offset"] = ins_h(feats)[:2]
        out[device] = {k: v.detach().cpu() for k, v in res.items()}
    errs = scaled_errors(out["cuda"], out["cpu"])
    worst = max(errs, key=errs.get)
    log(f"tiny projects, card vs CPU (f32): {len(errs)} outputs, losses and gradients, max error {errs[worst]:.3g} of "
        f"scale ({worst}; bar 1e-3); the card's own top-k selections differed from the CPU's in {differ} of "
        f"{len(record)} calls (the CPU's were fed)")
    if errs[worst] > 1e-3:
        raise RuntimeError(f"tiny projects differ between the card and the CPU: {json.dumps(errs)}")
    # the post-processing on the CPU's outputs: on a seeded scene and on the tiny heads' outputs
    h, w = 96, 128
    center = torch.from_numpy(rng.uniform(0, 0.05, (h, w)).astype(np.float32))
    for cy, cx, v in ((20, 30, 0.9), (60, 90, 0.7), (80, 20, 0.5), (60, 91, 0.7)):
        center[cy, cx] = v
    offsets = torch.from_numpy(rng.normal(0, 30, (h, w, 2)).astype(np.float32))
    sem = torch.from_numpy(rng.integers(0, 5, (h, w)))
    sem[:, :40] = 3
    thing = torch.tensor([False, False, True, True, True])
    cases = [("seeded scene", sem, center, offsets, dict(stuff_area=64)),
             ("tiny heads", out["cpu"]["panoptic sem"][0].argmax(-1), out["cpu"]["panoptic center"][0, ..., 0],
              out["cpu"]["panoptic offset"][0], dict(stuff_area=64))]
    for name, s, c, o, kw in cases:
        want = pd.get_panoptic_segmentation(s, c, o, thing, 5, **kw)
        got = pd.get_panoptic_segmentation(s.cuda(), c.cuda(), o.cuda(), thing.cuda(), 5, **kw)
        same = [torch.equal(g.cpu(), w_) for g, w_ in zip(got, want)]
        log(f"tiny projects, card vs CPU: get_panoptic_segmentation on the {name}' {tuple(s.shape)} outputs: "
            f"panoptic map, centres, validity equal {same}; {int(want[2].sum())} centres, "
            f"{len(torch.unique(want[0]))} panoptic ids")
        if not all(same):
            raise RuntimeError(f"get_panoptic_segmentation differs between the card and the CPU on the {name}")


def projects_pointrend(torch, m, dev, card):
    """PointRend on ``config_1``'s X101-32x8d FPN (bf16 over float32, seeded,
    100 detections an image) at 800^2, batch 4, on ``heads_scene`` frames:
    the detections (K2 on the box head, K4 in RPN and box head), then
    ``PointRendMaskHead(PointRendConfig())`` and the implicit head on each
    image's P2 and detections, counters reset just before and read just
    after; PROJ_STEPS SGD steps (config_1's solver) of each head's point loss
    (plus the implicit head's l2) on the scene's GT boxes and masks, on the
    frozen pyramid; the heads read P2 over its RMS (PROJ_P2_RMS). Returns the rows of K2 and K4 on the inference, the
    launches, the detector and the scene."""
    pr = m.point_rend
    cfg = m.zoo.DETECTOR_PRESETS["config_1"].config
    det = m.rcnn.GeneralizedRCNN(cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(121))
    scene = heads_scene(torch, m, dev, HEADS_BATCH, 122)
    prc = pr.PointRendConfig()
    head = pr.PointRendMaskHead(prc, cfg.fpn_channels, device=dev, generator=torch.Generator().manual_seed(123))
    ihead = pr.ImplicitPointRendMaskHead(prc, cfg.fpn_channels, device=dev,
                                         generator=torch.Generator().manual_seed(124))
    log(f"projects: PointRend (PointRendConfig(): coarse {prc.coarse_resolution} -> {prc.coarse_output_side}, start "
        f"{prc.init_resolution}, {prc.effective_steps} steps of {prc.subdivision_num_points} points; implicit: "
        f"{ihead.point_head.num_params} parameters an instance, start {math.isqrt(prc.subdivision_num_points)}, "
        f"{prc.subdivision_steps} steps) on config_1's X101-32x8d FPN (bf16 over float32, seeded, "
        f"{cfg.roi.detections_per_image} detections an image, FrozenBN calibrated on the batch) at {HEADS_HW}^2, batch "
        f"{HEADS_BATCH}")
    calibrate_frozen_bn(torch, m, det, scene["image"])  # the implicit head's point loss diverges on raw seeded features
    with torch.no_grad():
        det(scene["image"])  # cuDNN's first calls at this size
    kept, orig_pyramid = {}, det.pyramid

    def pyramid(images, precomputed_feats=None):
        kept["p"] = orig_pyramid(images, precomputed_feats)
        return kept["p"]

    k2, k4 = Capture(m.roi_align, "roi_align_multilevel"), Capture(m.nms, "nms_mask_sorted")
    spans, restore = timed_steps(torch, head, "subdivision_step")
    ispans, irestore = timed_steps(torch, ihead, "subdivision_step")
    det.pyramid = pyramid
    try:
        with k2, k4, torch.no_grad():
            reset_counts(m)
            sync()
            t0 = time.perf_counter()
            dets = det(scene["image"])
            sync()
            det_ms = (time.perf_counter() - t0) * 1e3
            raw = kept["p"]["p2"].permute(0, 2, 3, 1)
            p2_rms = raw.float().square().mean().sqrt().item()
            p2 = (raw / p2_rms).to(raw.dtype)  # see PROJ_P2_RMS
            masks, shapes = [], set()
            for _ in range(2):  # the first call warms the heads' kernels
                spans.clear()
                sync()
                t0 = time.perf_counter()
                masks = [head([p2[b]], dets["boxes"][b]) for b in range(HEADS_BATCH)]
                sync()
                pr_ms = (time.perf_counter() - t0) * 1e3
            ispans.clear()
            sync()
            t0 = time.perf_counter()
            finite_i = True
            for b in range(HEADS_BATCH):
                imask = ihead([p2[b]], dets["boxes"][b])
                shapes.add(tuple(imask.shape))
                finite_i &= bool(torch.isfinite(imask).all())
            sync()
            ipr_ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts(m)
    finally:
        del det.pyramid
        restore()
        irestore()
    by_step = lambda sp, n: [round(sum(s.elapsed_time(e) for s, e in sp[i::n]) / HEADS_BATCH, 4)  # noqa: E731
                             for i in range(n)]  # each step's mean over the images
    step_ms, istep_ms = by_step(spans, prc.effective_steps), by_step(ispans, prc.subdivision_steps)
    side = prc.init_resolution * 2 ** prc.effective_steps
    finite = all(bool(torch.isfinite(x).all()) for x in masks)
    log(f"projects: PointRend inference on {card}: the seeded P2's RMS {p2_rms:.4f}, divided out for both heads; "
        f"the detector {det_ms:.4f} ms a batch of {HEADS_BATCH} "
        f"({int(dets['valid'].sum())} valid of {tuple(dets['boxes'].shape[:2])}); PointRendMaskHead {pr_ms:.4f} ms "
        f"for the {HEADS_BATCH} images' {dets['boxes'].shape[1]} boxes each -> {tuple(masks[0].shape)}, its "
        f"subdivision steps {step_ms} ms an image (CUDA events); implicit {ipr_ms:.4f} ms -> {sorted(shapes)}, its "
        f"steps {istep_ms} ms an image; finite {finite} / {finite_i}; launches {json.dumps(launches)}")
    if tuple(masks[0].shape) != (cfg.roi.detections_per_image, side, side, 1) or not finite or not finite_i:
        raise RuntimeError(f"projects: PointRend's masks are {tuple(masks[0].shape)} or not finite")
    if shapes != {(cfg.roi.detections_per_image, 896, 896, 1)}:
        raise RuntimeError(f"projects: the implicit head's masks are {shapes}, not 896^2")
    for key in ("K2", "K4"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by PointRend's detector")
    # training on the frozen pyramid: the scene's GT boxes and masks
    with torch.no_grad():
        p2 = (det.pyramid(scene["image"])["p2"].permute(0, 2, 3, 1) / p2_rms).to(torch.bfloat16)
    valid = scene["gt_valid"].float()
    for label, module in (("PointRendMaskHead", head), ("ImplicitPointRendMaskHead", ihead)):
        opt = m.optim.build_optimizer("sgd", list(module.parameters()), HEADS_LR, weight_decay=1e-4, momentum=0.9)
        gen = torch.Generator(device=dev).manual_seed(125)

        def forward(module=module):
            loss = 0.0
            for b in range(HEADS_BATCH):
                args = ([p2[b]], scene["gt_boxes"][b])
                kw = dict(gt_masks=scene["gt_masks"][b], valid=valid[b], train=True, generator=gen)
                if module is head:
                    _, logits, labels = module(*args, **kw)
                    extra = 0.0
                else:
                    logits, labels, extra = module(*args, **kw)
                loss = loss + (pr.roi_mask_point_loss(logits, labels, None, valid[b]) + extra) / HEADS_BATCH
            return loss

        train_path(torch, f"{label} training (config_1's P2, {HEADS_BATCH} images, SGD {HEADS_LR})", forward, opt,
                   HEADS_BATCH, card)
    rows = [pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (projects: PointRend's config_1 detector, box "
                                               f"head, {k2.calls[-1][0][1].shape[0]} ROIs, windowed read window)"),
            *nms_rows(torch, m, dev, k4.calls[:2], "projects: PointRend's config_1 detector ")]
    return rows, launches, det, scene


def annotation_points(torch, scene, n: int, seed: int):
    """PointSup's annotation: n points an instance drawn uniformly from its GT
    box grown by a tenth a side (some fall outside: label -1 in the loss),
    each labelled by the GT mask at its pixel; padded instances get the
    frame as their box. Returns (boxes (B*G, 4), points (B*G, n, 2), labels
    (B*G, n), valid (B*G,))."""
    dev = scene["gt_boxes"].device
    b, g = scene["gt_valid"].shape
    valid = scene["gt_valid"].reshape(-1)
    frame = torch.tensor([0.0, 0.0, HEADS_HW, HEADS_HW], device=dev)
    boxes = torch.where(valid[:, None], scene["gt_boxes"].reshape(-1, 4), frame)
    wh = boxes[:, 2:] - boxes[:, :2]
    u = torch.rand((b * g, n, 2), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    pts = boxes[:, None, :2] - 0.1 * wh[:, None] + 1.2 * wh[:, None] * u
    xy = pts.long().clamp(0, HEADS_HW - 1)
    masks = scene["gt_masks"].reshape(b * g, HEADS_HW, HEADS_HW)
    labels = masks[torch.arange(b * g, device=dev)[:, None], xy[..., 1], xy[..., 0]].float()
    return boxes, pts, labels, valid


def projects_pointsup(torch, m, dev, card, det, scene):
    """PointSup on the PointRend path's X101 pyramid: ``cascade.MaskHead`` on
    the scene's GT boxes, pooled by ``cascade.pool_gather`` at P 14 (K2's
    gather read), PROJ_STEPS SGD steps of ``mask_rcnn_point_sup_loss`` on
    PROJ_POINTS annotated points an instance, the pyramid's levels taking
    the gradient through K2b's gather read; counters reset just before and
    read just after. Returns the rows of K2 and K2b in the gather read and
    the launches."""
    cfg = det.config
    with torch.no_grad():
        pyr = det.pyramid(scene["image"])
    feats = {lvl: pyr[lvl].permute(0, 2, 3, 1).detach().requires_grad_() for lvl in cfg.roi.in_levels}
    head = m.cascade.MaskHead(cfg.fpn_channels, cfg.roi.num_classes)
    m.layers.init_params(head, torch.Generator().manual_seed(131))
    head.to(dev)
    boxes, pts, labels, valid = annotation_points(torch, scene, PROJ_POINTS, 132)
    g = scene["gt_valid"].shape[1]
    log(f"projects: PointSup (cascade.MaskHead, {cfg.fpn_channels} channels, pooled by K2's gather read at P 14 "
        f"from {cfg.roi.in_levels}) on the X101 pyramid of {HEADS_BATCH} frames: {int(valid.sum())} instances of "
        f"{HEADS_BATCH}x{g} slots, {PROJ_POINTS} points each ({int((labels > 0).sum())} on the mask)")
    opt = m.optim.build_optimizer("sgd", list(head.parameters()), HEADS_LR, weight_decay=1e-4, momentum=0.9)

    def forward():
        for f in feats.values():
            f.grad = None
        pooled = m.cascade.pool_gather(feats, boxes.reshape(HEADS_BATCH, g, 4), cfg.roi, m.fpn.FPN_STRIDES, 14)
        logits = head(pooled, torch.bfloat16)
        return m.pointsup.mask_rcnn_point_sup_loss(logits, boxes, pts, labels, None, valid.float())

    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == 14)
    k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[5] == 14)
    with k2, k2b:
        reset_counts(m)
        train_path(torch, f"PointSup training (cascade.MaskHead, {HEADS_BATCH} images, SGD {HEADS_LR})", forward,
                   opt, HEADS_BATCH, card)
        launches = read_counts(m)
    log(f"projects: PointSup launches {json.dumps(launches)}; the levels' gradients finite "
        f"{all(f.grad is None or bool(torch.isfinite(f.grad).all()) for f in feats.values())}")
    for key in ("K2 gather", "K2b gather"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by PointSup's training")
    r = k2.calls[-1][0][1].shape[0]
    rows = [pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (projects: PointSup's mask head, {r} GT "
                                               f"boxes, gather read, P 14)", count="K2 gather"),
            pooler_backward_row(torch, m, k2b.calls[-1], f"roi_align_multilevel_backward (projects: PointSup's mask "
                                                         f"head, {r} GT boxes, gather read, P 14, bf16 gradient)",
                                count="K2b gather")]
    return rows, launches


def projects_deeplab(torch, m, dev, card):
    """DeepLabV3+ on R103 at output stride 16 (detectron2
    ``deeplab_v3_plus_R_103_os16_mg124_poly_90k_bs16.yaml``: the deep stem,
    multi-grid (1, 2, 4), 19 classes), bf16 over float32, seeded: PROJ_STEPS
    SGD steps (momentum 0.9, weight decay 1e-4, ``warmup_poly_schedule``
    PROJ_DL_LR, hard-pixel mining at 0.2) on PROJ_DL_BATCH 512x1024 crops,
    inference at 1024x2048; then ``PointRendSemSegHead`` at its defaults on
    V3+'s logits brought to stride 4 (``interpolate_bilinear``) and res2: one
    training step and one inference back to 1024x2048."""
    import numpy as np

    dl, pr = m.deeplab, m.point_rend
    tcfg = dl.DeepLabResNetConfig(resnet=m.resnet_backbone.ResNetConfig(depth=101))
    trunk = dl.DeepLabResNet(tcfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(141))
    ch = trunk.out_channels
    head = dl.DeepLabV3PlusHead(PROJ_CLASSES, (ch["res2"], ch["res5"]), ignore_value=PROJ_IGNORE,
                                dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(142))
    rng = np.random.default_rng(143)
    gen = m.panoptic_deeplab.PanopticTargetGenerator(ignore_label=PROJ_IGNORE, thing_ids=frozenset(PROJ_THINGS))
    sems = []
    for _ in range(PROJ_DL_BATCH):
        sem = gen(*panoptic_scene(rng, *PROJ_CROP))["sem_seg"]
        vh, vw = PROJ_CROP[0] // 8, PROJ_CROP[1] // 8
        y, x = rng.integers(0, PROJ_CROP[0] - vh), rng.integers(0, PROJ_CROP[1] - vw)
        sem[y:y + vh, x:x + vw] = PROJ_IGNORE  # a void region
        sems.append(sem)
    labels = torch.from_numpy(np.stack(sems)).to(dev)
    images = seg_images(torch, dev, np.where(labels.cpu().numpy() == PROJ_IGNORE, 0, labels.cpu().numpy()), rng)
    frames = seg_images(torch, dev, np.stack([gen(*panoptic_scene(rng, *PROJ_FRAME))["sem_seg"]
                                              for _ in range(PROJ_DL_BATCH)]), rng)
    calibrate_frozen_bn(torch, m, trunk, images, trunk)
    sched = dl.warmup_poly_schedule(*PROJ_DL_LR)
    n_params = sum(p.numel() for p in trunk.parameters()) + sum(p.numel() for p in head.parameters())
    log(f"projects: DeepLabV3+ R103-OS16 (deep stem {tcfg.stem_channels}, res4 dilation {tcfg.res4_dilation}, res5 "
        f"{tcfg.res5_dilation} x multi-grid {tcfg.res5_multi_grid}, ASPP 256 at (6, 12, 18), project 48, decoder 256, "
        f"{PROJ_CLASSES} classes; {n_params} parameters) in bf16 over float32, seeded, FrozenBN calibrated on the "
        f"batch; {PROJ_DL_BATCH} crops of "
        f"{PROJ_CROP[0]}x{PROJ_CROP[1]}, SGD momentum 0.9 under warmup_poly_schedule{PROJ_DL_LR}, hard-pixel "
        f"mining 0.2, ignore {PROJ_IGNORE} ({int((labels == PROJ_IGNORE).sum())} px)")
    opt = m.optim.build_optimizer("sgd", list(trunk.parameters()) + list(head.parameters()),
                                  lambda s: float(sched(s)), weight_decay=1e-4, momentum=0.9)
    train_path(torch, "DeepLabV3+ R103-OS16 training", lambda: head(trunk(images), labels, train=True)[1][
        "loss_sem_seg"], opt, PROJ_DL_BATCH, card)
    with torch.no_grad():
        for _ in range(2):  # the first warms cuDNN at this size
            sync()
            t0 = time.perf_counter()
            full_feats = trunk(frames)
            logits, _ = head(full_feats)
            sync()
            inf_ms = (time.perf_counter() - t0) * 1e3
    log(f"projects: DeepLabV3+ inference on {card}: {inf_ms:.4f} ms a batch of {PROJ_DL_BATCH} frames of "
        f"{PROJ_FRAME[0]}x{PROJ_FRAME[1]} -> {tuple(logits.shape)} float32, finite "
        f"{bool(torch.isfinite(logits).all())}")
    if tuple(logits.shape) != (PROJ_DL_BATCH, *PROJ_FRAME, PROJ_CLASSES) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError("projects: DeepLabV3+'s logits are not finite logits of the frame")
    # PointRend's semantic-segmentation head on V3+'s logits at stride 4 and res2
    seg = pr.PointRendSemSegHead(PROJ_CLASSES, ch["res2"], ignore_value=PROJ_IGNORE, device=dev,
                                 generator=torch.Generator().manual_seed(144))
    with torch.no_grad():
        crop_feats = trunk(images)
        coarse = pr.interpolate_bilinear(head(crop_feats)[0], (PROJ_CROP[0] // 4, PROJ_CROP[1] // 4))
    opt = m.optim.build_optimizer("sgd", list(seg.parameters()), lambda s: float(sched(s)), weight_decay=1e-4,
                                  momentum=0.9)
    sgen = torch.Generator(device=dev).manual_seed(145)
    train_path(torch, f"PointRendSemSegHead training (V3+'s stride-4 logits, res2; {seg.train_num_points} points)",
               lambda: seg(coarse, [crop_feats["res2"]], targets=labels, train=True, generator=sgen)[1], opt,
               PROJ_DL_BATCH, card)
    spans, restore = timed_steps(torch, seg, "subdivision_step")
    try:
        with torch.no_grad():
            coarse = pr.interpolate_bilinear(logits, (PROJ_FRAME[0] // 4, PROJ_FRAME[1] // 4))
            for _ in range(2):
                spans.clear()
                sync()
                t0 = time.perf_counter()
                sem, _ = seg(coarse, [full_feats["res2"]])
                sync()
                seg_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    step_ms = [s.elapsed_time(e) for s, e in spans]
    changed = float((sem.argmax(-1) != pr.upsample_bilinear(coarse, 4).argmax(-1)).float().mean())
    log(f"projects: PointRendSemSegHead inference on {card}: {seg_ms:.4f} ms for {PROJ_DL_BATCH} frames, "
        f"{tuple(coarse.shape)} -> {tuple(sem.shape)}, subdivision steps {[round(v, 4) for v in step_ms]} ms "
        f"({seg.subdivision_num_points} points each); labels changed against the plain x4 upsample: {changed:.6f} of "
        f"the pixels; finite {bool(torch.isfinite(sem).all())}")
    if tuple(sem.shape) != (PROJ_DL_BATCH, *PROJ_FRAME, PROJ_CLASSES) or not bool(torch.isfinite(sem).all()):
        raise RuntimeError("projects: PointRend's semantic logits are not finite logits of the frame")


def projects_panoptic(torch, m, dev, card):
    """Panoptic-DeepLab on R52 at output stride 16 (detectron2
    ``panoptic_deeplab_R_52_os16_mg124_poly_90k_bs32_crop_512_1024.yaml``:
    ``DEEPLAB_R50``'s deep-stem trunk, the semantic head at 256, the
    instance head at 128 / 32), bf16 over float32, seeded: PROJ_STEPS Adam
    steps (PROJ_PD_LR under ``warmup_poly_schedule``) of the weighted
    semantic, centre and offset losses on PROJ_PD_BATCH 512x1024 crops whose
    targets ``PanopticTargetGenerator`` makes from seeded panoptic maps;
    then inference at 1024x2048 and ``get_panoptic_segmentation`` at its
    defaults, held exactly to the CPU's on the card's head outputs."""
    import numpy as np

    dl, pd = m.deeplab, m.panoptic_deeplab
    trunk = dl.DeepLabResNet(dl.DEEPLAB_R50, dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(151))
    ch = (trunk.out_channels["res2"], trunk.out_channels["res5"])
    sem_h = pd.PanopticDeepLabSemSegHead(PROJ_CLASSES, ch, ignore_value=PROJ_IGNORE, dtype=torch.bfloat16,
                                         device=dev, generator=torch.Generator().manual_seed(152))
    ins_h = pd.PanopticDeepLabInsEmbedHead(ch, dtype=torch.bfloat16, device=dev,
                                           generator=torch.Generator().manual_seed(153))
    rng = np.random.default_rng(154)
    gen = pd.PanopticTargetGenerator(ignore_label=PROJ_IGNORE, thing_ids=frozenset(PROJ_THINGS))
    t0 = time.perf_counter()
    targets = [gen(*panoptic_scene(rng, *PROJ_CROP)) for _ in range(PROJ_PD_BATCH)]
    gen_s = time.perf_counter() - t0
    tg = {k: torch.from_numpy(np.stack([t_[k] for t_ in targets])).to(dev)
          for k in ("sem_seg", "center", "offset", "sem_seg_weights", "center_weights", "offset_weights")}
    images = seg_images(torch, dev, np.where(tg["sem_seg"].cpu().numpy() == PROJ_IGNORE, 0,
                                             tg["sem_seg"].cpu().numpy()), rng)
    frame_pan, frame_segs = panoptic_scene(rng, *PROJ_FRAME)
    frame_tg = gen(frame_pan, frame_segs)
    frame = seg_images(torch, dev, np.where(frame_tg["sem_seg"] == PROJ_IGNORE, 0, frame_tg["sem_seg"])[None], rng)
    calibrate_frozen_bn(torch, m, trunk, images, trunk)
    small = int(sum((t_["sem_seg_weights"] > 1).sum() for t_ in targets))
    log(f"projects: Panoptic-DeepLab R52-OS16 (DEEPLAB_R50's trunk, semantic head 256, instance head 128 / 32) in bf16 "
        f"over float32, seeded, FrozenBN calibrated on the batch; {PROJ_PD_BATCH} crops of "
        f"{PROJ_CROP[0]}x{PROJ_CROP[1]}, Adam {PROJ_PD_LR} under "
        f"warmup_poly_schedule; targets by PanopticTargetGenerator in {gen_s:.3f} s on the host: "
        f"{sum(len(t_['center_points']) for t_ in targets)} thing centres, {small} px of small instances (x3), "
        f"{int((tg['center_weights'] == 0).sum())} px without centre weight (crowd)")
    sched = dl.warmup_poly_schedule(PROJ_PD_LR, 90000)
    params = [p for mod in (trunk, sem_h, ins_h) for p in mod.parameters()]
    opt = m.optim.build_optimizer("adam", params, lambda s: float(sched(s)))

    def forward():
        feats = trunk(images)
        _, sl = sem_h(feats, tg["sem_seg"], tg["sem_seg_weights"], train=True)
        _, _, cl, ol = ins_h(feats, tg["center"], tg["center_weights"], tg["offset"], tg["offset_weights"], train=True)
        return sl["loss_sem_seg"] + cl["loss_center"] + ol["loss_offset"]

    train_path(torch, "Panoptic-DeepLab R52-OS16 training (semantic + 200 centre + 0.01 offset)", forward, opt,
               PROJ_PD_BATCH, card)
    thing = torch.zeros(PROJ_CLASSES, dtype=torch.bool, device=dev)
    thing[list(PROJ_THINGS)] = True
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def infer():
        ev[0].record()
        feats = trunk(frame)
        ev[1].record()
        logits, _ = sem_h(feats)
        ev[2].record()
        center, offset, _, _ = ins_h(feats)
        ev[3].record()
        return logits, center, offset

    inf_ms, splits = [], []
    with torch.no_grad():
        for _ in range(3):  # the first warms cuDNN at this size
            logits = center = offset = None  # the last call's outputs freed first
            sync()
            t0 = time.perf_counter()
            logits, center, offset = infer()
            sync()
            inf_ms.append((time.perf_counter() - t0) * 1e3)
            splits.append([round(ev[i].elapsed_time(ev[i + 1]), 4) for i in range(3)])
        prof = profile_counts(torch, infer)
        sem = logits[0].argmax(-1)
        # the semantic head's ASPP alone on the frame's res5, once and twice in a batch
        res5 = trunk(frame)["res5"]
        aspp_ms = {b: time_ms(lambda r=res5.expand(b, -1, -1, -1).contiguous(): sem_h.decoder.aspp_res5(r), 3)
                   for b in (1, 2)}
    # the same fusion on the frame's own targets (its semantic map, centre heatmap and offsets): the instances back
    gt_in = [torch.from_numpy(frame_tg[k]).to(dev) for k in ("sem_seg", "center", "offset")]
    gt_in[0] = torch.where(gt_in[0] == PROJ_IGNORE, torch.zeros_like(gt_in[0]), gt_in[0])
    gt_things = sum(1 for s_ in frame_segs if s_["category_id"] in PROJ_THINGS and (frame_pan == s_["id"]).any())
    for label, args in (("the heads' outputs", (sem, center[0, ..., 0], offset[0])), ("the frame's targets", gt_in)):
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            got = pd.get_panoptic_segmentation(*args, thing, PROJ_CLASSES)
            sync()
            pp_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = pd.get_panoptic_segmentation(*(a.cpu() for a in args), thing.cpu(), PROJ_CLASSES)
        cpu_s = time.perf_counter() - t0
        same = [torch.equal(g.cpu(), w_) for g, w_ in zip(got, want)]
        ids = torch.unique(got[0])
        ids = ids[ids >= 0]
        log(f"projects: Panoptic-DeepLab get_panoptic_segmentation (threshold 0.1, NMS 7, top 200, stuff area 2048) on "
            f"{label} at {PROJ_FRAME[0]}x{PROJ_FRAME[1]} on {card}: {pp_ms:.4f} ms; {int(got[2].sum())} centres, "
            f"{len(ids)} panoptic ids besides void ({int((ids % 1000 > 0).sum())} instances; the frame has {gt_things} "
            f"things); "
            f"the CPU's on the same inputs ({cpu_s:.2f} s) equal: panoptic map, centres, validity {same}")
        if tuple(got[0].shape) != PROJ_FRAME or not all(same):
            raise RuntimeError(f"projects: the card's panoptic segmentation of {label} differs from the CPU's")
    log(f"projects: Panoptic-DeepLab inference on {card}: the trunk and both heads {[round(v, 4) for v in inf_ms]} "
        f"ms a {PROJ_FRAME[0]}x{PROJ_FRAME[1]} frame (the first warms cuDNN), trunk / semantic head / instance head "
        f"{splits} ms (CUDA events); a profiled call busy {prof['busy_us']:.0f} of {prof['wall_us']:.0f} us = "
        f"{prof['busy_us'] / prof['wall_us']:.4f}, {prof['kernel_launches']} kernel launches; outputs finite "
        f"{all(bool(torch.isfinite(v).all()) for v in (logits, center, offset))}; ASPP ({res5.shape[-1]} -> 256, "
        f"dilations 6, 12, 18) on the frame's res5 {tuple(res5.shape)}: {aspp_ms[1]:.4f} ms, on it twice in a batch "
        f"{aspp_ms[2]:.4f} ms (CUDA events)")


def projects_phase(torch, m, dev, card):
    """PointRend, PointSup, DeepLab and Panoptic-DeepLab on the card: first
    their tiny paths against the CPU; then PointRend and PointSup on
    config_1's X101 detector (each path's counters reset just before it and
    read just after), DeepLabV3+ (with PointRend's semantic head) and
    Panoptic-DeepLab at full width. Yields the detector paths' (rows,
    launches)."""
    t0 = time.perf_counter()
    check_projects_tiny_against_cpu(torch, m)
    rows, launches, det, scene = projects_pointrend(torch, m, dev, card)
    yield rows, launches
    del rows
    yield projects_pointsup(torch, m, dev, card, det, scene)
    del det, scene
    torch.cuda.empty_cache()
    projects_deeplab(torch, m, dev, card)
    torch.cuda.empty_cache()
    projects_panoptic(torch, m, dev, card)
    log(f"projects phase: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------- projects c

PC_P = 28  # DensePose's pooler resolution (ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION)
PC_INSTANCES, PC_POINTS = 32, 128  # DensePose training: annotated instances a frame, points an instance
PC_GT_SIDE = 64  # the coarse segmentation's GT grid an instance
# TridentNet-R101's res4: 23 trident blocks, 1024 out, 256 bottleneck, stride 2, dilations (1, 2, 3), on the res3
# map of 800^2 frames (512 channels, 100^2)
PC_TRIDENT = dict(num_blocks=23, cin=512, out_channels=1024, bottleneck_channels=256, stride=2)
PC_TRIDENT_FRAMES, PC_TRIDENT_HW = 2, 100
PC_VIT_HW, PC_VIT_BATCH = 1024, 2  # ViTDet-B's LSJ input
PC_MVIT_HW, PC_MVIT_BATCH = 1024, 1
PC_TOWER_HW = (100, 50, 25, 13, 7)  # RetinaNet's P3-P7 at 800^2
PC_SWAP_SHAPE, PC_SWAP_LAMBDA = (2, 15, 15, 100, 100), 2  # TensorMask's 15x15 windows on a 100^2 level
# parameters whose gradient is zero in exact arithmetic, so that the card and the CPU give each its own rounding
# noise: the bias of MViTv2's key LayerNorm adds q . b to every logit of a query's row, which the softmax removes
PC_NULL_GRADS = ("attn.norm_k.bias",)


def check_projects_c_tiny_against_cpu(torch, m) -> None:
    """The last projects' tiny paths in float32 (TF32 off) on the card
    against the CPU, from the same seeded parameters on the same inputs:
    DensePose on both routes (the decoder's map pooled by K2's gather read
    on one level against ``roi_align_maps``; the pyramid by K2's four-level
    gather read against its plain version; the gradients through K2b's
    gather read), the chart loss and the heads', decoder's and pyramid's
    gradients; TridentNet's stage on every branch and on one; ViTDet and
    MViTv2 (outputs and every gradient); both BNConvTower variants (a train
    step, the running statistics, eval); swap_align2nat and its gradient:
    each within 1e-3 of its scale. Then, equal: ``chart_result_for_grid``'s
    labels of the CPU's outputs given to the card, and TridentNet's branch
    merge (K4) on the same seeded detections."""
    import dataclasses

    import numpy as np

    dp, tn, vd, mv, tmk, rb = m.densepose, m.tridentnet, m.vitdet, m.mvitv2, m.tensormask, m.rethinking_bn
    rng = np.random.default_rng(181)
    normal = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    pyr = [normal(2, 64 >> i, 64 >> i, 8) for i in range(4)]
    ann, boxes, batch_idx = densepose_annotations(torch, dp, "cpu", 2, 3, 20, 4, 16, 64, 182)
    boxes[1] = torch.tensor([0.0, 0.0, 128.0, 128.0])  # past the frame: pooled from P3 by the multilevel route
    boxes[4] = torch.tensor([-40.0, -40.0, 240.0, 200.0])  # from P4
    dcfg = dp.DensePoseConfig(num_stacked_convs=2, conv_head_dim=32, num_patches=3, decoder_channels=8)
    x_trident, x_vit, x_mvit = normal(2, 16, 16, 8), normal(1, 96, 96, 3), normal(1, 64, 64, 3)
    tower_in = [normal(2, 8 >> i, 8 >> i, 4) for i in range(3)]
    x_swap = normal(2, 3, 2, 5, 7)
    cot_swap = normal(2, 6, 4, 3, 4)
    det_boxes = torch.from_numpy(rng.uniform(0, 60, (6, 10, 2)).astype(np.float32))
    det_boxes = torch.cat([det_boxes, det_boxes + torch.from_numpy(rng.uniform(5, 30, (6, 10, 2)).astype(np.float32))],
                          -1)
    dets = (det_boxes, torch.from_numpy(rng.choice([0.3, 0.6, 0.9], (6, 10)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (6, 10)).astype(np.int32)),
            torch.from_numpy((rng.uniform(size=(6, 10)) > 0.3).astype(np.float32)))
    cots = {}

    def cot_of(v):
        """A seeded cotangent of ``v``'s shape, the same on both devices."""
        key = tuple(v.shape)
        if key not in cots:
            cots[key] = normal(*key)
        return cots[key]

    out, exact, nulls = {}, {}, {}
    for device in ("cpu", "cuda"):
        to = lambda v: v.to(device)  # noqa: E731
        gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
        res = {}

        def grads(prefix, module):
            named = [(k, p.grad) for k, p in module.named_parameters() if p.grad is not None]
            scale = max(g.abs().max().item() for _, g in named)
            for k, g in named:
                if k.endswith(PC_NULL_GRADS):  # zero in exact arithmetic: held to the module's gradient scale
                    nulls[f"{device} {prefix} grad {k}"] = g.abs().max().item() / scale
                else:
                    res[f"{prefix} grad {k}"] = g

        dec = dp.DensePoseDecoder(dcfg, 8, device=device, generator=gen(183))
        for route, kind in (("decoder", "v1convx"), ("multilevel", "deeplab")):
            head = dp.DensePoseHead(dataclasses.replace(dcfg, head=kind), 8, device=device, generator=gen(184))
            feats = [to(f).detach().requires_grad_() for f in pyr]
            o = dp.densepose_roi_forward(head, feats, to(boxes), decoder=dec if route == "decoder" else None,
                                         batch_idx=to(batch_idx))
            losses = dp.densepose_chart_loss(o, dp.PackedChartAnnotations(*map(to, ann)), dcfg)
            sum(losses.values()).backward()
            res.update({f"densepose {route} {k}": v for k, v in zip(o._fields, o)} | {
                f"densepose {route} {k}": v for k, v in losses.items()} | {  # a level no box pools from: zeros
                f"densepose {route} grad p{i + 2}": torch.zeros_like(f) if f.grad is None else f.grad
                for i, f in enumerate(feats)})
            grads(f"densepose {route} head", head)
        grads("densepose decoder", dec)
        stage = tn.TridentStage(2, 8, 16, 8, 2, device=device, generator=gen(185))
        with torch.no_grad():
            res["trident all branches"] = stage(to(x_trident))
            res["trident branch 1"] = stage(to(x_trident), 1)
        exact[device] = tn.merge_branch_detections(*map(to, dets), 3, 0.5, 16)
        # gradients of <outputs, seeded cotangents>: the sum of squares of a LayerNorm's (or a train-mode BN's)
        # output hardly moves with its input, so its gradient would be rounding noise
        for name, model, x in (("vitdet", vd.ViTDetBackbone(vd.VITDET_TINY, (96, 96), device=device,
                                                            generator=gen(186)), x_vit),
                               ("mvitv2", mv.MViTv2Backbone(mv.MVITV2_TINY, (64, 64), device=device,
                                                            generator=gen(187)), x_mvit)):
            feats = model(to(x))
            sum(torch.sum(v * to(cot_of(v))) for v in feats.values()).backward()
            res.update({f"{name} {k}": v for k, v in feats.items()})
            grads(name, model)
        for variant in ("cycle", "shared"):
            tower = rb.BNConvTower(3, 4, 8, 2, variant, device=device, generator=gen(188))
            tower.train()
            with torch.no_grad():
                res.update({f"tower {variant} train {i}": o for i, o in enumerate(tower([to(f) for f in tower_in]))})
            tower.eval()
            outs = tower([to(f) for f in tower_in])
            sum(torch.sum(o * to(cot_of(o))) for o in outs).backward()
            grads(f"tower {variant}", tower)
            res.update({f"tower {variant} eval {i}": o for i, o in enumerate(outs)} | {
                f"tower {variant} {k}": v for k, v in tower.named_buffers()})
        xs = to(x_swap).detach().requires_grad_()
        y = tmk.swap_align2nat(xs, 2)
        torch.sum(y * to(cot_swap)).backward()
        res.update({"swap_align2nat": y, "swap_align2nat grad": xs.grad})
        out[device] = {k: v.detach().cpu() for k, v in res.items()}
    errs = scaled_errors(out["cuda"], out["cpu"])
    worst = max(errs, key=errs.get)
    log(f"tiny projects c, card vs CPU (f32): {len(errs)} outputs, losses, statistics and gradients, max error "
        f"{errs[worst]:.3g} of scale ({worst}; bar 1e-3)")
    if errs[worst] > 1e-3:
        raise RuntimeError(f"tiny projects c differ between the card and the CPU: {json.dumps(errs)}")
    log(f"tiny projects c: the gradients that are zero in exact arithmetic (MViTv2's norm_k biases: a shift of every "
        f"key moves each query's logits alike), largest over their module's largest gradient: "
        f"{max(nulls.values()):.3g} (bar 1e-3) on {len(nulls)} of them, both devices")
    if max(nulls.values()) > 1e-3:
        raise RuntimeError(f"tiny projects c: a gradient that is zero in exact arithmetic is not: {json.dumps(nulls)}")
    merge_same = [torch.equal(g.cpu(), w) for g, w in zip(exact["cuda"], exact["cpu"])]
    chart = dp.DensePoseChartPredictorOutput(*(out["cpu"][f"densepose decoder {k}"]
                                                 for k in dp.DensePoseChartPredictorOutput._fields))
    want = dp.chart_result_for_grid(chart, (21, 17))
    got = dp.chart_result_for_grid(dp.DensePoseChartPredictorOutput(*(v.cuda() for v in chart)), (21, 17))
    labels_same = torch.equal(got[0].cpu(), want[0])
    uv_err = (got[1].cpu() - want[1]).abs().max().item()
    log(f"tiny projects c, card vs CPU: TridentNet's branch merge (K4 on the card) boxes, scores, classes, valid equal "
        f"{merge_same} ({int(exact['cpu'][3].sum())} kept); chart_result_for_grid on the CPU's outputs: labels equal "
        f"{labels_same}, uv max error {uv_err:.3g}")
    if not all(merge_same) or not labels_same or uv_err > 1e-5:
        raise RuntimeError("tiny projects c: the branch merge or the chart labels differ between the card and the CPU")


def densepose_annotations(torch, dp, dev, b: int, instances: int, points: int, parts: int, gt_side: int, hw: int,
                          seed: int):
    """Seeded PackedChartAnnotations on ``dev``: ``instances`` GT boxes an
    image of ``b`` (5-38% of the ``hw`` frame a side), the last a padded
    slot; the estimates their GT boxes moved by up to a twentieth of their
    size; ``points`` points an instance (a tenth invalid; part labels 0 to
    ``parts`` - 1, 0 the background); the coarse GT a ``gt_side`` grid of
    15 labels. Returns (ann, the estimates as XYXY (b * instances, 4), their
    image indices)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, p = b * instances, b * instances * points
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    wh = hw * (0.05 + 0.33 * rand(n, 2))
    gt = torch.cat([rand(n, 2) * (hw - wh), wh], 1)
    est = gt + (rand(n, 4) - 0.5) * 0.1 * wh.repeat(1, 2)
    ann = dp.PackedChartAnnotations(
        x_gt=256 * rand(p), y_gt=256 * rand(p), u_gt=rand(p), v_gt=rand(p),
        fine_segm_labels_gt=torch.randint(0, parts, (p,), generator=gen, device=dev),
        point_instance=torch.arange(n, device=dev).repeat_interleave(points), point_valid=rand(p) > 0.1,
        bbox_xywh_gt=gt, bbox_xywh_est=est,
        coarse_segm_gt=torch.randint(0, 15, (n, gt_side, gt_side), generator=gen, device=dev),
        instance_valid=torch.arange(n, device=dev) < n - 1)
    boxes = torch.cat([est[:, :2], est[:, :2] + est[:, 2:]], 1)
    return ann, boxes, torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(instances)


def projects_densepose(torch, m, dev, card):
    """DensePose (``DensePoseConfig()``: the decoder at 256 channels, the
    v1convx head of 8 x 512 convs, the chart predictor to 112^2) on
    ``config_1``'s X101-32x8d FPN (bf16 over float32, seeded, FrozenBN
    calibrated, 100 detections an image) at 800^2, batch 4, on
    ``heads_scene`` frames: the decoder route (K2's gather read on the
    merged stride-4 map, one level, P 28, over the 400 detections) and
    ``chart_result_for_grid`` at 112^2; the route without the decoder once
    (K2's gather read on P2-P5); the DeepLab head once; then PROJ_STEPS SGD
    steps (config_1's solver) of the decoder and the head on
    ``densepose_annotations``, whose backward runs K2b's gather read on the
    merged map. Each path's counters reset just before it and read just
    after. The heads read the pyramid over its RMS (PROJ_P2_RMS). Returns
    the (rows, launches) of the three kernel paths and the detections."""
    dp = m.densepose
    cfg = m.zoo.DETECTOR_PRESETS["config_1"].config
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    det = m.rcnn.GeneralizedRCNN(cfg, dtype=torch.bfloat16, device=dev, generator=gen(191))
    scene = heads_scene(torch, m, dev, HEADS_BATCH, 192)
    calibrate_frozen_bn(torch, m, det, scene["image"])
    dcfg = dp.DensePoseConfig()
    dec = dp.DensePoseDecoder(dcfg, cfg.fpn_channels, dtype=torch.bfloat16, device=dev, generator=gen(193))
    head = dp.DensePoseHead(dcfg, dcfg.decoder_channels, dtype=torch.bfloat16, device=dev, generator=gen(194))
    with torch.no_grad():
        dets = det(scene["image"])
        pyr = det.pyramid(scene["image"])
        rms = pyr["p2"].float().square().mean().sqrt().item()
        feats = [(pyr[f"p{i}"] / rms).permute(0, 2, 3, 1) for i in range(2, 6)]  # see PROJ_P2_RMS
    del pyr
    b, r = dets["boxes"].shape[:2]
    boxes = dets["boxes"].reshape(-1, 4).float().contiguous()
    bidx = torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(r)
    log(f"projects c: DensePose (decoder {dcfg.decoder_channels}, v1convx {dcfg.num_stacked_convs} x "
        f"{dcfg.conv_head_dim}, chart predictor to {dcfg.heatmap_size}^2, K2 gather at P {PC_P}) on config_1's "
        f"X101-32x8d FPN (bf16, seeded, FrozenBN calibrated) at {HEADS_HW}^2, batch {b}: {r} detections an image "
        f"({int(dets['valid'].sum())} valid); the pyramid over P2's RMS {rms:.4f}")
    paths = []
    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == PC_P and len(a[0]) == 1)
    with k2, torch.no_grad():
        for _ in range(2):  # the first call warms cuDNN
            reset_counts(m)
            sync()
            t0 = time.perf_counter()
            out = dp.densepose_roi_forward(head, feats, boxes, decoder=dec, pooler_resolution=PC_P, batch_idx=bidx)
            labels, uv = dp.chart_result_for_grid(out, (dcfg.heatmap_size, dcfg.heatmap_size))
            sync()
            inf_ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts(m)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        merged = dec(feats)
        ev[1].record()
        pooled = dp.pool_merged(merged, boxes, bidx, PC_P, 4)
        ev[2].record()
        split_out = head(pooled)
        ev[3].record()
        dp.chart_result_for_grid(split_out, (dcfg.heatmap_size, dcfg.heatmap_size))
        ev[4].record()
        sync()
        splits = [round(ev[i].elapsed_time(ev[i + 1]), 4) for i in range(4)]
        del merged, pooled, split_out
    finite = all(bool(torch.isfinite(v).all()) for v in (*out, uv))
    side = 4 * PC_P
    log(f"projects c: DensePose inference on {card}: {inf_ms:.4f} ms a batch of {b} ({b * r} ROIs; the decoder, "
        f"K2's gather read on the merged {tuple(k2.calls[-1][0][0][0].shape)} map, the head and predictor, "
        f"chart_result_for_grid); decoder / pooling / head / converter {splits} ms (CUDA events); outputs "
        f"{tuple(out.fine_segm.shape)}, finite {finite}; labels {int((labels > 0).sum())} of {labels.numel()} "
        f"foreground; launches {json.dumps(launches)}")
    if tuple(out.fine_segm.shape) != (b * r, side, side, dcfg.num_patches + 1) or not finite:
        raise RuntimeError(f"projects c: DensePose's outputs are {tuple(out.fine_segm.shape)} or not finite")
    if launches["K2 gather"] == 0:
        raise RuntimeError("kernel K2 gather was not launched by DensePose's decoder route")
    del out, labels, uv
    paths.append(([pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (projects c: DensePose's decoder map, "
                                                       f"{b * r} ROIs, gather read, one level, P {PC_P})",
                              count="K2 gather")], launches))
    k2 = Capture(m.roi_align, "roi_align_multilevel", keep=lambda a: a[3] == PC_P and len(a[0]) == 4)
    with k2, torch.no_grad():
        reset_counts(m)
        sync()
        t0 = time.perf_counter()
        out = dp.densepose_roi_forward(head, feats, boxes, pooler_resolution=PC_P, batch_idx=bidx)
        sync()
        nodec_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(m)
    levels = m.roi_align.assign_levels(boxes, 4, 2)
    finite = bool(torch.isfinite(out.u).all())
    del out
    with torch.no_grad():
        dlhead = dp.DensePoseHead(dp.DensePoseConfig(head="deeplab"), dcfg.decoder_channels, dtype=torch.bfloat16,
                                  device=dev, generator=gen(195))
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            dlout = dp.densepose_roi_forward(dlhead, feats, boxes, decoder=dec, pooler_resolution=PC_P,
                                             batch_idx=bidx)
            sync()
            dl_ms = (time.perf_counter() - t0) * 1e3
        dl_finite = all(bool(torch.isfinite(v).all()) for v in dlout)
        del dlout, dlhead
    log(f"projects c: DensePose without the decoder on {card}: {nodec_ms:.4f} ms (K2's gather read on P2-P5, the "
        f"ROIs' levels {torch.bincount(levels, minlength=4).tolist()}), finite {finite}; launches "
        f"{json.dumps(launches)}; the DeepLab head (ASPP 6, 12, 56, GroupNorm 32) on the decoder route {dl_ms:.4f} "
        f"ms, finite {dl_finite}")
    if not finite or not dl_finite:
        raise RuntimeError("projects c: DensePose without the decoder or with the DeepLab head is not finite")
    if launches["K2 gather"] == 0:
        raise RuntimeError("kernel K2 gather was not launched by DensePose's route without the decoder")
    paths.append(([pooler_row(torch, m, k2.calls[-1], f"roi_align_multilevel (projects c: DensePose without the "
                                                       f"decoder, {b * r} ROIs, gather read, four levels, P {PC_P})",
                              count="K2 gather")], launches))
    # training: the decoder and the head, on the frozen pyramid
    ann, est, est_idx = densepose_annotations(torch, dp, dev, b, PC_INSTANCES, PC_POINTS, dcfg.num_patches + 1,
                                              PC_GT_SIDE, HEADS_HW, 196)
    opt = m.optim.build_optimizer("sgd", list(dec.parameters()) + list(head.parameters()), HEADS_LR,
                                  weight_decay=1e-4, momentum=0.9)

    def forward():
        o = dp.densepose_roi_forward(head, feats, est, decoder=dec, pooler_resolution=PC_P, batch_idx=est_idx)
        return sum(dp.densepose_chart_loss(o, ann, dcfg).values())

    k2b = Capture(m.roi_align, "roi_align_multilevel_backward", keep=lambda a: a[5] == PC_P)
    with k2b:
        reset_counts(m)
        train_path(torch, f"DensePose training (decoder + v1convx head, {b} images x {PC_INSTANCES} instances x "
                          f"{PC_POINTS} points, SGD {HEADS_LR})", forward, opt, b, card)
        launches = read_counts(m)
    log(f"projects c: DensePose training launches {json.dumps(launches)}")
    for key in ("K2 gather", "K2b gather"):
        if launches[key] == 0:
            raise RuntimeError(f"kernel {key} was not launched by DensePose's training")
    paths.append(([pooler_backward_row(torch, m, k2b.calls[-1], f"roi_align_multilevel_backward (projects c: "
                                                                f"DensePose training, {b * PC_INSTANCES} ROIs on the "
                                                                f"decoder map, gather read, one level, P {PC_P}, bf16 "
                                                                f"gradient)", count="K2b gather")], launches))
    return paths, dets


def projects_trident(torch, m, dev, card, dets):
    """TridentNet-R101's res4 stage (PC_TRIDENT, bf16 over float32, seeded,
    FrozenBN calibrated) on a seeded res3 map of PC_TRIDENT_FRAMES 800^2
    frames, on every branch and on branch 1; then ``merge_branch_detections``
    on 4 frames x 3 branches x 100 detections, each branch the DensePose
    path's detections jittered by a seeded draw (K4, counters reset just
    before and read just after). Returns K4's row and the launches."""
    tn = m.tridentnet
    stage = tn.TridentStage(**PC_TRIDENT, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(201))
    x = torch.randn((PC_TRIDENT_FRAMES, PC_TRIDENT_HW, PC_TRIDENT_HW, PC_TRIDENT["cin"]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(202))
    calibrate_frozen_bn(torch, m, stage, x, run=stage)
    ms = {}
    with torch.no_grad():
        for label, idx in (("every branch", None), ("branch 1", 1)):
            for _ in range(2):  # the first call warms cuDNN
                sync()
                t0 = time.perf_counter()
                y = stage(x, idx)
                sync()
                ms[label] = (time.perf_counter() - t0) * 1e3
            ms[label + " shape"] = tuple(y.shape)
            profile_call(torch, lambda: stage(x, idx), f"projects c: TridentNet-R101 res4, {label}")
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"projects c: TridentNet's stage on {label} is not finite")
            if label == "every branch":
                every = y[PC_TRIDENT_FRAMES:2 * PC_TRIDENT_FRAMES].float()
        one_off = ((y.float() - every).abs().max() / every.abs().max()).item()
    log(f"projects c: TridentNet-R101 res4 ({PC_TRIDENT['num_blocks']} blocks, bf16) on {PC_TRIDENT_FRAMES} frames' "
        f"res3 {tuple(x.shape)} on {card}: {json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in ms.items()})} "
        f"ms; branch 1 alone against branch 1 of every branch: max difference {one_off:.3g} of scale (bf16; cuDNN's "
        f"algorithms at batch {PC_TRIDENT_FRAMES} and {3 * PC_TRIDENT_FRAMES} may differ)")
    del stage, x, y, every
    gen = torch.Generator(device=dev).manual_seed(203)
    b, r = dets["boxes"].shape[:2]
    wh = (dets["boxes"][..., 2:] - dets["boxes"][..., :2]).repeat(1, 1, 2)
    jitter = lambda: torch.randn((b, r, 4), generator=gen, device=dev) * 0.05 * wh  # noqa: E731
    boxes = torch.cat([dets["boxes"] + jitter() for _ in range(3)])
    scores = torch.cat([dets["scores"] * (0.9 + 0.2 * torch.rand((b, r), generator=gen, device=dev)) for _ in range(3)])
    classes, valid = dets["classes"].repeat(3, 1), dets["valid"].float().repeat(3, 1)
    k4 = Capture(m.nms, "nms_mask_sorted")
    with k4:
        reset_counts(m)
        sync()
        t0 = time.perf_counter()
        mb, ms_, mc, mv = tn.merge_branch_detections(boxes, scores, classes, valid, 3, 0.5, r)
        sync()
        merge_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(m)
    log(f"projects c: TridentNet's branch merge on {card}: {merge_ms:.4f} ms for {b} frames x 3 branches x {r} "
        f"detections ({int(valid.sum())} valid) -> {tuple(mb.shape)}, {mv.sum(1).tolist()} kept; launches "
        f"{json.dumps(launches)}")
    if tuple(mb.shape) != (b, r, 4) or not bool(torch.isfinite(mb).all()) or launches["K4"] == 0:
        raise RuntimeError("projects c: TridentNet's branch merge failed or did not launch K4")
    nms_args = k4.calls[-1][0]
    return [nms_row(torch, m, dev, nms_args, f"nms_mask_sorted (projects c: TridentNet's branch merge, "
                                             f"{nms_args[1].shape[0]}x{nms_args[1].shape[1]})")], launches


def backbone_step(torch, card, label, model, fpn, x, images):
    """Two forwards (the first warms cuDNN), then two forward + backward
    passes of <outputs, seeded cotangents> (their means) timed by CUDA
    events: the first also grows the allocator's pool for the backward's
    saved tensors, the second is the warm step; a third under
    torch.profiler (``profile_call``: device time by kernel, busy share).
    The backbone's gradients must be finite and nonzero in every parameter
    but the PC_NULL_GRADS leaves, which stay below 1e-2 of the largest."""
    with torch.no_grad():
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            feats = model(x)
            outs = fpn({k: v.permute(0, 3, 1, 2) for k, v in feats.items()}) if fpn is not None else feats
            sync()
            fwd_ms = (time.perf_counter() - t0) * 1e3
    shapes = {k: tuple(v.shape) for k, v in outs.items()}
    del feats, outs
    gen = torch.Generator(device=x.device).manual_seed(216)
    cots = {k: torch.randn(sh, generator=gen, device=x.device) for k, sh in shapes.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step(ev=None):
        model.zero_grad(set_to_none=True)
        if ev:
            ev[0].record()
        feats = model(x)
        outs = fpn({k: v.permute(0, 3, 1, 2) for k, v in feats.items()}) if fpn is not None else feats
        loss = sum((v.float() * cots[k]).mean() for k, v in outs.items())
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        return loss

    splits = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        loss = step(ev)
        sync()
        splits.append([round(ev[0].elapsed_time(ev[1]), 4), round(ev[1].elapsed_time(ev[2]), 4)])
    profile_call(torch, step, f"projects c: {label}, a warm training step")
    named = [(k, p.grad) for k, p in model.named_parameters()]
    ok = all(g is not None and bool(torch.isfinite(g).all()) for _, g in named)
    if not ok:
        raise RuntimeError(f"projects c: {label}: a gradient is missing or not finite")
    scale = max(g.abs().max().item() for _, g in named)
    # the PC_NULL_GRADS leaves are zero in exact arithmetic: held below 1e-2 of the largest gradient, not to nonzero
    # (bf16 keeps 8 bits, so the logits' gradient carries ~2e-3 of rounding; MViTv2 in bf16 on the CPU at 128^2
    # reads 1.3e-4)
    nulls = max((g.abs().max().item() / scale for k, g in named if k.endswith(PC_NULL_GRADS)), default=0.0)
    live = [g for k, g in named if not k.endswith(PC_NULL_GRADS)]
    nonzero = sum(int(bool(g.any())) for g in live)
    log(f"projects c: {label} on {card}: forward {fwd_ms:.4f} ms ({images} images, no grad); training forward / "
        f"backward {splits[1]} ms warm, {splits[0]} ms the first (CUDA events), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.4f} GB; outputs {shapes}; loss {loss.item():.6g}; gradients "
        f"finite, nonzero in {nonzero} of {len(live)} parameters, {len(named) - len(live)} null-gradient leaves at "
        f"{nulls:.3g} of the largest")
    if not math.isfinite(loss.item()) or nonzero != len(live) or nulls > 1e-2:
        raise RuntimeError(f"projects c: {label}: a gradient is zero, or a null-gradient leaf is not small")


def projects_backbones(torch, m, dev, card):
    """ViTDet-B (``ViTDetConfig()``: 768 wide, 12 deep, 12 heads, windows of
    14, global blocks 2, 5, 8, 11; the position table 14^2 -> 64^2) at
    PC_VIT_HW^2, batch PC_VIT_BATCH, into the port's FPN(256); MViTv2-B
    (``MViTv2Config()``: 96 wide, depths 2, 3, 16, 3) at PC_MVIT_HW^2, batch
    PC_MVIT_BATCH; both bf16 over float32, seeded, forward and two
    training passes (``backbone_step``)."""
    vd, mv = m.vitdet, m.mvitv2
    vit = vd.ViTDetBackbone(vd.ViTDetConfig(), (PC_VIT_HW, PC_VIT_HW), dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(211))
    fpn = m.fpn.FPN({f"res{i}": vd.ViTDetConfig().out_channels for i in range(2, 6)}, 256)
    m.layers.init_params(fpn, torch.Generator().manual_seed(212))
    fpn.to(dev)
    x = torch.randn((PC_VIT_BATCH, PC_VIT_HW, PC_VIT_HW, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(213))
    backbone_step(torch, card, f"ViTDet-B + FPN(256) at {PC_VIT_HW}^2, batch {PC_VIT_BATCH} (bf16)", vit, fpn, x,
                  PC_VIT_BATCH)
    del vit, fpn, x
    torch.cuda.empty_cache()
    mvit = mv.MViTv2Backbone(mv.MViTv2Config(), (PC_MVIT_HW, PC_MVIT_HW), dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(214))
    x = torch.randn((PC_MVIT_BATCH, PC_MVIT_HW, PC_MVIT_HW, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(215))
    backbone_step(torch, card, f"MViTv2-B at {PC_MVIT_HW}^2, batch {PC_MVIT_BATCH} (bf16)", mvit, None, x,
                  PC_MVIT_BATCH)


def projects_tower_and_swap(torch, m, dev, card):
    """``BNConvTower`` at RetinaNet's head width (256 channels, 4 convs) on
    seeded P3-P7 maps of an 800^2 batch of 4, both variants, a train-mode
    call and an eval-mode one (bf16 over float32); ``swap_align2nat`` on
    PC_SWAP_SHAPE float32 at lambda PC_SWAP_LAMBDA with its gradient, the
    output held to the CPU's within 1e-5."""
    rb, tmk = m.rethinking_bn, m.tensormask
    gen = torch.Generator(device=dev).manual_seed(221)
    feats = [torch.randn((HEADS_BATCH, s, s, 256), device=dev, generator=gen).to(torch.bfloat16) for s in PC_TOWER_HW]
    for variant in ("cycle", "shared"):
        tower = rb.BNConvTower(len(PC_TOWER_HW), 256, 256, 4, variant, dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator().manual_seed(222))
        ms = {}
        with torch.no_grad():
            for mode in ("train", "eval"):
                tower.train(mode == "train")
                for _ in range(2):
                    sync()
                    t0 = time.perf_counter()
                    outs = tower(feats)
                    sync()
                    ms[mode] = round((time.perf_counter() - t0) * 1e3, 4)
                if not all(bool(torch.isfinite(o).all()) for o in outs):
                    raise RuntimeError(f"projects c: BNConvTower {variant} in {mode} mode is not finite")
        log(f"projects c: BNConvTower ({variant}, 4 x 256) on {HEADS_BATCH} frames' P3-P7 "
            f"{[tuple(f.shape[1:3]) for f in feats]} on {card}: {json.dumps(ms)} ms (the train call moves each "
            f"level's statistics; the eval call reads them); norm0's statistics {tuple(tower.norm0.mean.shape)}")
    x = torch.randn(PC_SWAP_SHAPE, device=dev, generator=gen)
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        y = tmk.swap_align2nat(x, PC_SWAP_LAMBDA)
        sync()
        swap_ms = (time.perf_counter() - t0) * 1e3
    err = (y.cpu() - tmk.swap_align2nat(x.cpu(), PC_SWAP_LAMBDA)).abs().max().item()
    xg = x.clone().requires_grad_()
    tmk.swap_align2nat(xg, PC_SWAP_LAMBDA).square().mean().backward()
    log(f"projects c: swap_align2nat {PC_SWAP_SHAPE} at lambda {PC_SWAP_LAMBDA} on {card}: {swap_ms:.4f} ms -> "
        f"{tuple(y.shape)}, max error against the CPU {err:.3g} (bar 1e-5); gradient finite "
        f"{bool(torch.isfinite(xg.grad).all())}")
    if err > 1e-5 or not bool(torch.isfinite(xg.grad).all()):
        raise RuntimeError("projects c: swap_align2nat differs from the CPU or its gradient is not finite")


def projects_c_phase(torch, m, dev, card):
    """DensePose, TridentNet, ViTDet, MViTv2, TensorMask and Rethinking-BN on
    the card: first their tiny paths against the CPU; then DensePose on
    config_1's X101 detector (K2's gather read at P 28 on one level and on
    four, K2b's in training), TridentNet-R101's res4 and branch merge (K4),
    ViTDet-B and MViTv2-B, BNConvTower and swap_align2nat at full width.
    Yields each kernel path's (rows, launches)."""
    t0 = time.perf_counter()
    check_projects_c_tiny_against_cpu(torch, m)
    paths, dets = projects_densepose(torch, m, dev, card)
    for path in paths:
        yield path
    del paths
    torch.cuda.empty_cache()
    yield projects_trident(torch, m, dev, card, dets)
    del dets
    torch.cuda.empty_cache()
    projects_backbones(torch, m, dev, card)
    torch.cuda.empty_cache()
    projects_tower_and_swap(torch, m, dev, card)
    log(f"projects c phase: {time.perf_counter() - t0:.1f} s")


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
        backbone_int8, cascade, fcos, fpn, hrnet, hrnet_int8, layers, rcnn, resnet_backbone, retinanet, roi_heads, rpn,
    )
    from spacecraft_pose_estimation_tpu_torch.models import discriminator
    from spacecraft_pose_estimation_tpu_torch.tools import (
        export_boxes, export_poses, test_landmarks, train_detector, train_landmarks, train_landmarks_da,
    )
    from spacecraft_pose_estimation_tpu_torch.train import adversarial, detection_state, landmark_loop, optim
    from spacecraft_pose_estimation_tpu_torch.train import state as train_state
    from spacecraft_pose_estimation_tpu_torch.ops import (
        geometry, heatmap, int8_blocks, int8_conv, masks, nms, pnp, roi_align, warp,
    )
    from spacecraft_pose_estimation_tpu_torch.data import coco_eval
    from spacecraft_pose_estimation_tpu_torch import convert
    from spacecraft_pose_estimation_tpu_torch.events import emulator, slomo
    from spacecraft_pose_estimation_tpu_torch.events import io as ev_io
    from spacecraft_pose_estimation_tpu_torch.tools import convert_aedats, evaluate_event_pipeline, v2e
    from spacecraft_pose_estimation_tpu_torch.data import augment
    from spacecraft_pose_estimation_tpu_torch.tools import make_synthetic_scene, train_pipeline_dvs
    from spacecraft_pose_estimation_tpu_torch.tools import export_model, export_weights, import_weights
    from spacecraft_pose_estimation_tpu_torch import structures
    from spacecraft_pose_estimation_tpu_torch.models import extra_layers, regnet, tta, zoo
    from spacecraft_pose_estimation_tpu_torch.ops import deform_conv, rotated_boxes
    from spacecraft_pose_estimation_tpu_torch.train import checkpoint, metrics, trainer
    from spacecraft_pose_estimation_tpu_torch.ops import s2d
    from spacecraft_pose_estimation_tpu_torch.tools import lazyconfig_train
    from spacecraft_pose_estimation_tpu_torch import parallel
    from spacecraft_pose_estimation_tpu_torch.parallel import multihost
    from spacecraft_pose_estimation_tpu_torch.tools import benchmark, demo
    from spacecraft_pose_estimation_tpu_torch.utils import analysis, collect_env, memory, vis
    from spacecraft_pose_estimation_tpu_torch.projects import deeplab, panoptic_deeplab, point_rend, pointsup
    from spacecraft_pose_estimation_tpu_torch.projects import (
        densepose, mvitv2, rethinking_bn, tensormask, tridentnet, vitdet,
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
                        train_detector=train_detector, convert=convert, emulator=emulator, slomo=slomo, ev_io=ev_io,
                        v2e=v2e, convert_aedats=convert_aedats, evaluate_event_pipeline=evaluate_event_pipeline,
                        augment=augment, make_synthetic_scene=make_synthetic_scene,
                        train_pipeline_dvs=train_pipeline_dvs, retinanet=retinanet, import_weights=import_weights,
                        export_weights=export_weights, export_model=export_model, cascade=cascade, fcos=fcos,
                        fpn=fpn, rpn=rpn, roi_heads=roi_heads, masks=masks, coco_eval=coco_eval,
                        structures=structures, extra_layers=extra_layers, regnet=regnet, tta=tta, zoo=zoo,
                        deform_conv=deform_conv, rotated_boxes=rotated_boxes, checkpoint=checkpoint, metrics=metrics,
                        trainer=trainer, s2d=s2d, lazyconfig_train=lazyconfig_train, parallel=parallel,
                        multihost=multihost, benchmark=benchmark, demo=demo, analysis=analysis,
                        collect_env=collect_env, memory=memory, vis=vis, point_rend=point_rend, pointsup=pointsup,
                        deeplab=deeplab, panoptic_deeplab=panoptic_deeplab, densepose=densepose,
                        tridentnet=tridentnet, vitdet=vitdet, mvitv2=mvitv2, tensormask=tensormask,
                        rethinking_bn=rethinking_bn)
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
    # beside each kernel's own counter: K5a's grouped, padded (by kernel size), clipped and f32 launches, K2's
    # and K2b's in the gather read
    m.counters = {key: k for key, (_, _, k) in m.kernels.items()} | {
        "K5a grouped": int8_conv.GROUPED, "K5a clipped": int8_conv.CLIPPED, "K5a f32": int8_conv.F32,
        "K2 gather": roi_align.GATHER, "K2b gather": roi_align.GATHER_BACKWARD} | {
        f"K5a padded {k}x{k}": c for k, c in int8_conv.PADDED.items()}
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
    log(card_health())
    # full float32 wherever float32 runs (the serving models run bf16 and int8)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    import importlib.util

    log("optional packages the port's library path does without: " + json.dumps(
        {name: importlib.util.find_spec(name) is not None
         for name in ("cv2", "PIL", "pandas", "yaml", "h5py", "zstandard", "flatbuffers", "cloudpickle")}))

    build_s = _cuda.build_all()
    log("build (s): " + json.dumps({k: round(v, 2) for k, v in build_s.items()}))
    check_tensor_core_sass(_cuda)
    check_pooler_coverage(torch, m)
    check_pooler_backward_tiles(torch, m)
    check_single_coverage(torch, m)
    check_nms_coverage(torch, m)
    check_tiny_against_cpu(torch, m)
    check_ransac_repeats(torch, m)

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
    torch.cuda.empty_cache()

    # weights in and out: reference .pth / zoo .pkl files imported, the trainers resumed from them, the
    # evaluation of the import, the export to .pth and the pose pipeline as a torch.export program (K1)
    report += kernel_report(*weights_phase(torch, m, dev, card))
    torch.cuda.empty_cache()

    # the heads: Mask and Keypoint R-CNN on the X101 detector, Cascade R-CNN's ROI heads and FCOS at full
    # width, with K2 and K2b in the gather read and K4 on FCOS's 2,843-candidate NMS
    for rows, launches in heads_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
        del rows  # the rows' captured calls and yardsticks: freed before the next path runs
    torch.cuda.empty_cache()

    # tools/train_detector.py's config_20: the R101 RetinaNet at full width, K4 at 10x4441 in its evaluation
    report += kernel_report(*retina_phase(torch, m, dev, card))
    torch.cuda.empty_cache()

    # the event-camera half: v2e at 1280x720, and the event evaluation of DAVIS346
    # recordings through K1, K2 and K4
    report += kernel_report(*events_phase(torch, m, dev, card))
    torch.cuda.empty_cache()

    # training on event frames: tools/train_pipeline_dvs.py on a rendered scene (K1,
    # K2, K2b and K4 on its inputs) and the photometric stacks
    report += kernel_report(*dvs_phase(torch, m, dev, card))
    torch.cuda.empty_cache()

    # the rest of the detection library and the trainer's hooks: TTA around config_1's detector (K2 on the
    # scaled view, K4 on the merge), RegNet, deformable conv, rotated boxes, ASPP, the tracker, PreciseBN
    for rows, launches in library_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
        del rows
    torch.cuda.empty_cache()

    # the int8 HRNet's options in bench.py's int8 form: s2d (K5a's padded 4x4, 2x2 and 3x3 convs), s2d with the
    # even3 chains (K5 at 128 channels), merge_fuse (K5a's per-channel clip), fold=2 (K5a's f32 epilogue); then
    # tools.lazyconfig_train at HRNet-W32's width
    for rows, launches in options_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
        del rows
    torch.cuda.empty_cache()

    # the tools, the utils and data parallelism: retry_if_oom on a real OOM, tools.demo (K1), tools.benchmark on
    # every task (train-det: K2, K2b, K4), utils.analysis, NCCL data parallelism at world size 1 (K2, K4)
    report += kernel_report(*tools_phase(torch, m, dev, card))
    torch.cuda.empty_cache()

    # the projects: PointRend (standard and implicit) and PointSup on config_1's X101 detector (K2 and K4 in its
    # inference; K2 and K2b in the gather read under PointSup), DeepLabV3+ R103 with PointRend's semantic head, and
    # Panoptic-DeepLab R52 with its post-processing
    for rows, launches in projects_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
        del rows
    torch.cuda.empty_cache()

    # the last projects: DensePose on config_1's X101 detector (K2's gather read at P 28 on the decoder's map and on
    # P2-P5, K2b's in training), TridentNet-R101's res4 and its branch merge (K4), ViTDet-B and MViTv2-B at 1024^2,
    # BNConvTower at RetinaNet's head width and swap_align2nat
    for rows, launches in projects_c_phase(torch, m, dev, card):
        report += kernel_report(rows, launches)
        del rows

    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        print(f"chip_smoke: the last line logged before the failure: {_LAST_LOGGED[0]}", file=sys.stderr, flush=True)
        print(f"chip_smoke: {card_health()}", file=sys.stderr, flush=True)
        raise
    sys.exit(rc)
