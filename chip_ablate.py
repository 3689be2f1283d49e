#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one CUDA card: the int8 tensor-core kernels K5a, K5, K6
and K7, the ROIAlign kernel (K2 on the FPN, K3 on one map), its backward K2b, the NMS K4 and the crop K1.

    python3 chip_ablate.py [--before TREE] [KERNEL ...]

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit; with kernel ids (``K2 K4``) it times only their variants and
shapes. It copies ``spacecraft_pose_estimation_tpu_torch/csrc`` once per
variant into the gitignored ``_build/ablate/``, edits one piece of a
kernel out of each copy (the tensor-core conv body's epilogue, wgmma or
copies into shared memory, K5's cluster barriers, the ROIAlign kernel's loads, its stores or all
but its launch, K2b's grad_out loads, its sums, all but its footprint walk, its stores or all but its
launches, K4's overlap phase, its walk or all but its launch, K1's staging and x contraction (its
stores alone), its stores, its x contraction or its copies into shared memory), changes one of its sizes, or swaps in an
exact alternative (K2b's rows a warp and columns a block; the ROIAlign sampling ratio fixed at the served 2, K4's IoU
decision by division, its walk not unrolled or not skipping empty
quarters of a word; K1's bytes turned into floats by I2F, its blocks' starts staggered, 128 threads a block,
its tiles of 4 rows, of 64 columns, of 16 rows by 64), builds each copy's sources of the kernels the variant
touches (one nvcc per source, in parallel), and times each variant's
kernels at the serving shapes (HRNet-W32's four branch chains; R101 and
HRNet conv sites; layer1 in 32-row strips and in two strips per image;
three fuse-exchange outputs; K2 on 256 boxes over the four R101-FPN
levels; K3 on 64 P2-sized boxes on one 192x192x256 bf16 map; K4 on the RPN's and the box head's problems, with as many valid
boxes as the served ones and with most valid; K2b on tools/train_detector's config_1 call: 512 ROIs over
the bf16 P2-P5 of 4 images at 800^2, C 256, a quarter of each image's clustered on its object; K1 on
each path's crop as chip_smoke.py's rows report it, from seeded frames and parameters of the same frame
size, crop size, count and step: ``K1_SHAPES``) from CUDA graphs, turn by turn in one process. With ``--before TREE``, a checkout of the port as it was when K2b
summed with float32 atomics (the commit before the owner-computes K2b), the kernel id ``K2b-atomic`` times
that K2b too, split into its memset and cast alone, its atomic kernel alone, and the atomic kernel with
each ROI's gradient sent to a private buffer of its own (no two ROIs add into one address), and ``K4-before``
times that tree's K4 beside this one's on every K4 shape it takes (up to 2,048 boxes before K4 took 8,192;
the shapes add the evaluation's 40x1000, training's RPN 20x2000 and RetinaNet's 10x4441); ``K2-before``
and ``K2b-before`` time that tree's K2 and K2b on K2's call (the Pallas read window) and K2b's (the
windowed one) and hold them bit for bit to this tree's (a change that adds a read keeps these), and
``K5a-before``, ``K5-before``, ``K6-before`` and ``K7-before`` likewise time that tree's int8 kernels on
the int8 shapes below, held bit for bit to this tree's (``K5a-before`` through the C entry that K5a had
before it took explicit padding and a clip bound: no ``lo``, padding k // 2). ``K1-before`` times that
tree's K1 on every K1 shape, held bit for bit to this tree's, and once more with its loads cut out (its
stores alone). With ``K1`` the script then splits the host's cost of one K1 call into its layers
(``k1_host_split``: 2,000 calls of each under ``time.perf_counter_ns``, on the demo's crop), this tree's
route beside a ``torch.library.custom_op`` route rebuilt here for comparison, and ``F.grid_sample``. Only the
unedited source and the exact
alternatives are held to the plain versions: the others compute wrong answers
on purpose, and their times say what the removed piece costs. Prints the
card, one JSON line per shape (and per host layer) and a last line ``{"ok": true, ...}``;
without a CUDA device it exits 1.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

INT8 = ("K5a", "K5", "K6", "K7")
# the atomic K2b without its memset of the float32 buffers and its cast to bf16
ATOMIC_NO_MEMSET_CAST = [("roi_align_multilevel_backward.cu", "  for (int l = 0; l < num_levels; ++l) {\n    const size_t n",
                        "  for (int l = 0; l < 0; ++l) {\n    const size_t n"),
                       ("roi_align_multilevel_backward.cu", "  if (is_bf16) {", "  if (is_bf16 < 0) {")]
# a private buffer a ROI: its read window's rows x the Pallas window's columns (48 x 56)
PRIVATE_W, PRIVATE_CELLS = 56, 48 * 56
# variant -> (kernel ids it applies to, [(file, text, replacement)] applied to a copy of csrc/)
VARIANTS = {
    "as committed": (INT8 + ("K2", "K3", "K4", "K2b", "K1"), []),
    "no epilogue": (INT8, [("int8_mma.cuh", "  store_tile<TN>(cw, rg, ld.p_base, ld.c_base, acc, smem, epi);",
                            "  if (acc[0] == 0x7fffffff) store_tile<TN>(cw, rg, ld.p_base, ld.c_base, acc, smem, epi);")]),
    "no wgmma": (INT8, [("int8_mma.cuh",
                         "      if (kk < nk) wgmma_s8<TN>(acc, desc_sw128(sa + kChunk * kk), desc_sw128(sb + kChunk * kk));",
                         "      ;")]),
    "no copies": (INT8, [("int8_mma.cuh", "    if (nxt < ld.nstage) ld.stage(smem, nxt % kStages, nxt);", "    ;"),
                         ("int8_mma.cuh", "      if (st < nstage) stage(smem, st, st);", "      ;")]),
    "no cluster barriers": (("K5",), [("basic_block_chain.cu", "    cluster_barrier();\n    // conv2", "    // conv2"),
                                      ("basic_block_chain.cu", "    cluster_barrier();\n    cur = Src", "    cur = Src")]),
    "4-stage ring": (INT8, [("int8_mma.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "K7 tiles of the fewest rows": (("K7",), [("up_exchange.cu", "constexpr int kMaxTileRows = 32;",
                                              "constexpr int kMaxTileRows = 1;")]),
    "K7 tiles of 32 rows": (("K7",), [("up_exchange.cu", "constexpr int kMinBlocksPerSm = 2;",
                                       "constexpr int kMinBlocksPerSm = 0;")]),
    "K2/K3 no loads": (("K2", "K3"), [("roi_align_multilevel.cu",
                               "              load8(feat + (static_cast<int64_t>(taps.ky[ty][sy]) * w + taps.kx[tx][sx]) * C + c, f);",
                               "              for (int q = 0; q < 8; ++q) f[q] = wx;")]),
    "K2/K3 no stores": (("K2", "K3"), [("roi_align_multilevel.cu", "      float4* o = reinterpret_cast<float4*>(orow + px * C + c);",
                                "      if (acc[0] != 12345.f) continue;\n"
                                "      float4* o = reinterpret_cast<float4*>(orow + px * C + c);")]),
    "K2/K3 launch only": (("K2", "K3"), [("roi_align_multilevel.cu", "  const int r = blockIdx.x / P, py = blockIdx.x % P;\n",
                                         "  if (P > 0) return;\n  const int r = blockIdx.x / P, py = blockIdx.x % P;\n")]),
    "K2/K3 S fixed at 2 (exact)": (("K2", "K3"), [("roi_align_multilevel.cu",
                                           "      for (int iy = 0; iy < S; ++iy) {\n        const int sy = py * S + iy;\n"
                                           "        for (int ix = 0; ix < S; ++ix) {\n          const int sx = px * S + ix;",
                                           "#pragma unroll\n      for (int iy = 0; iy < 2; ++iy) {\n"
                                           "        const int sy = py * 2 + iy;\n#pragma unroll\n"
                                           "        for (int ix = 0; ix < 2; ++ix) {\n          const int sx = px * 2 + ix;")]),
    "K2b no grad_out loads": (("K2b",), [("roi_align_multilevel_backward.cu",
                                          "const float4 u0 = __ldg(g0), v0 = __ldg(g0 + 1), u1 = __ldg(g1), v1 = __ldg(g1 + 1);",
                                          "const float4 u0 = make_float4(a0, a1, a0, a1), v0 = u0, u1 = u0, v1 = u0;")]),
    "K2b no sums": (("K2b",), [("roi_align_multilevel_backward.cu", "for (int py = qa; py <= qb && m_all; ++py) {",
                                "for (int py = qa; py <= qb && m_all && P < 0; ++py) {")]),
    "K2b footprint walk alone": (("K2b",), [("roi_align_multilevel_backward.cu", "const bool meets = f.x == key && (f.y",
                                             "const bool meets = f.x == key + (1 << 30) && (f.y")]),
    "K2b 8 rows a warp (exact)": (("K2b",), [("roi_align_multilevel_backward.cu", "constexpr int kRows = 4;",
                                              "constexpr int kRows = 8;")]),
    "K2b 2 rows a warp (exact)": (("K2b",), [("roi_align_multilevel_backward.cu", "constexpr int kRows = 4;",
                                              "constexpr int kRows = 2;")]),
    "K2b 4 columns a block (exact)": (("K2b",), [("roi_align_multilevel_backward.cu", "constexpr int kCols = 8;",
                                                  "constexpr int kCols = 4;")]),
    "K2b 16 columns a block (exact)": (("K2b",), [("roi_align_multilevel_backward.cu", "constexpr int kCols = 8;",
                                                   "constexpr int kCols = 16;")]),
    "K2b a block a tile (exact)": (("K2b",), [("roi_align_multilevel_backward.cu",
                                               "<<<min(n, sms * blocks_per_sm<__nv_bfloat16>()), kThreads",
                                               "<<<n, kThreads")]),
    "K2b no stores": (("K2b",), [("roi_align_multilevel_backward.cu", "      if (y0 + j < h) store8(",
                                  "      if (y0 + j < h && acc[j][0] == 12345.f) store8(")]),
    "K2b launch only": (("K2b",), [("roi_align_multilevel_backward.cu", "  if (r >= p.R) return;", "  return;"),
                                   ("roi_align_multilevel_backward.cu",
                                    "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n  const int P",
                                    "  if (tiles > 0) return;\n"
                                    "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n  const int P")]),
    # the atomic K2b, on --before's sources: a float32 buffer a level zeroed, atomics into it, a bf16 cast
    "K2b atomic (exact)": (("K2b-atomic",), []),
    "K2b atomic: memset + cast alone": (("K2b-atomic",), [("roi_align_multilevel_backward.cu", "  if (R > 0) {",
                                                       "  if (R < 0) {")]),
    "K2b atomic: atomics alone": (("K2b-atomic",), ATOMIC_NO_MEMSET_CAST),
    "K2b atomic: atomics alone, private buffers": (("K2b-atomic",), ATOMIC_NO_MEMSET_CAST + [
        ("roi_align_multilevel_backward.cu",
         "  float* g = grads.g[bw.lvl] + static_cast<int64_t>(batch_idx[r]) * bw.h * bw.w * C;",
         f"  float* g = grads.g[0] + static_cast<int64_t>(r) * {PRIVATE_CELLS} * C;"),
        ("roi_align_multilevel_backward.cu",
         "float* cell = g + (static_cast<int64_t>(taps.ky[ty][sy]) * bw.w + taps.kx[tx][sx]) * C + c;",
         f"float* cell = g + (static_cast<int64_t>(taps.ky[ty][sy] - bw.oy) * {PRIVATE_W} + taps.kx[tx][sx] - bw.ox)"
         " * C + c;")]),
    "K4 no overlaps": (("K4",), [("nms_mask_sorted.cu",
                                  "    if (!v[i]) continue;  // warp-uniform; the walk never reads an invalid row",
                                  "    continue;")]),
    "K4 no walk": (("K4",), [("nms_mask_sorted.cu", "  if (warp == 0) {", "  if (warp == 0 && N < 0) {")]),
    "K4 launch only": (("K4",), [("nms_mask_sorted.cu", "  const int W = (N + 63) / 64;\n",
                                  "  if (N > 0) return;\n  const int W = (N + 63) / 64;\n")]),
    "K4 8 warps": (("K4",), [("nms_mask_sorted.cu", "  const int threads = 32 * min(32, (N + 7) / 8);",
                              "  const int threads = 32 * min(8, (N + 7) / 8);")]),
    "K4 IoU by division (exact)": (("K4",), [("nms_mask_sorted.cu",
                                              "over_threshold(inter, fmaxf(uni, 1e-12f), threshold, t_up)",
                                              "inter / fmaxf(uni, 1e-12f) > threshold")]),
    "K4 walk not unrolled (exact)": (("K4",), [("nms_mask_sorted.cu", "#pragma unroll\n        for (int b = q;",
                                                "#pragma unroll 1\n        for (int b = q;")]),
    "K4 walk through empty quarters (exact)": (("K4",), [("nms_mask_sorted.cu",
                                                          "        if (!(alive >> q & 0xffffull)) continue;", "")]),
    # --before's K4, on the shapes it takes
    "K4 before (exact)": (("K4-before",), []),
    # --before's K2 and K2b, on K2's and K2b's windowed calls: bit-equal to this tree's
    "K2 and K2b before (exact)": (("K2-before", "K2b-before"), []),
    # --before's int8 kernels on the int8 shapes: bit-equal to this tree's
    "int8 before (exact)": (("K5a-before", "K5-before", "K6-before", "K7-before"), []),
    # K1: its stores alone (no staging, no x contraction: the y pass reads whatever shared memory holds), no
    # stores, no x contraction, no copies into shared memory, bytes turned into floats by the conversion unit, the
    # blocks' starts staggered (the first three crops' blocks, or every block: do blocks that start together read
    # and write in step?), 128 threads a block, other tiles; then --before's K1, whole and with its loads cut out
    "K1 stores only": (("K1",), [("crop_bilinear.cu", "r < nrows; r += kWarps)", "r < 0; r += kWarps)"),
                                 ("crop_bilinear.cu", "    if (x >= xa && x < xb) {", "    if (nx < 0) {")]),
    "K1 no stores": (("K1",), [("crop_bilinear.cu", "float4 v) { *reinterpret_cast<float4*>(p) = v; }",
                                "float4 v) { if (v.x == 12345.f) *reinterpret_cast<float4*>(p) = v; }"),
                               ("crop_bilinear.cu", "float v) { *p = v; }", "float v) { if (v == 12345.f) *p = v; }")]),
    "K1 no x contraction": (("K1",), [("crop_bilinear.cu", "    if (x >= xa && x < xb) {", "    if (nx < 0) {")]),
    "K1 no staging copies": (("K1",), [("crop_bilinear.cu", "          cp_async16(dst, piece);", "          ;")]),
    "K1 bytes to floats by I2F (exact)": (("K1",), [("crop_bilinear.cu",
                                                     "  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | k)), 8388608.f);",
                                                     "  return static_cast<float>((w >> (8 * k)) & 0xffu);")]),
    "K1 first wave staggered 0-0.9 us (exact)": (("K1",), [("crop_bilinear.cu",
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
        "  if (blockIdx.z < 3) __nanosleep((blockIdx.y % 4) * 300);\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;")]),
    "K1 first wave staggered 0-1.4 us (exact)": (("K1",), [("crop_bilinear.cu",
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
        "  if (blockIdx.z < 3) __nanosleep((blockIdx.y % 8) * 200);\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;")]),
    "K1 every block staggered 0-0.6 us (exact)": (("K1",), [("crop_bilinear.cu",
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
        "  __nanosleep(((blockIdx.y * 5 + blockIdx.x) % 4) * 200);\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;")]),
    "K1 128 threads (exact)": (("K1",), [("crop_bilinear.cu", "constexpr int kThreads = 256;",
                                          "constexpr int kThreads = 128;")]),
    "K1 tiles of 4 rows (exact)": (("K1",), [("crop_bilinear.cu", "constexpr int kTileRows = 8;",
                                              "constexpr int kTileRows = 4;")]),
    "K1 tiles of 64 columns (exact)": (("K1",), [("crop_bilinear.cu", "constexpr int kTileCols = 128;",
                                                  "constexpr int kTileCols = 64;")]),
    "K1 tiles of 16 rows by 64 (exact)": (("K1",), [("crop_bilinear.cu", "constexpr int kTileRows = 8;",
                                                     "constexpr int kTileRows = 16;"),
                                                    ("crop_bilinear.cu", "constexpr int kTileCols = 128;",
                                                     "constexpr int kTileCols = 64;")]),
    "K1 before (exact)": (("K1-before",), []),
    "K1 before: stores only": (("K1-before",), [("crop_bilinear.cu", "  if (xs > -1.f && xs < static_cast<float>(W)",
                                                 "  if (W < 0 && xs > -1.f && xs < static_cast<float>(W)")]),
}
# variants that must still agree with the plain versions: the committed sources and the other exact designs
EXACT = ("as committed",) + tuple(name for name in VARIANTS if name.endswith("(exact)"))
INT8_BEFORE = ("K5a-before", "K5-before", "K6-before", "K7-before")
BEFORE = ("K2b-atomic", "K4-before", "K2-before", "K2b-before", "K1-before") + INT8_BEFORE  # built from --before's
SOURCES = {"K5a": ("int8_conv_requant.cu", "int8_conv_requant"), "K5": ("basic_block_chain.cu", "basic_block_chain"),
           "K6": ("bottleneck_chain.cu", "bottleneck_chain"), "K7": ("up_exchange.cu", "up_exchange"),
           "K2": ("roi_align_multilevel.cu", "roi_align_multilevel"), "K3": ("roi_align_multilevel.cu", "roi_align_single"),
           "K2b": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward"),
           "K2b-atomic": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward"),
           "K4": ("nms_mask_sorted.cu", "nms_mask_sorted"), "K4-before": ("nms_mask_sorted.cu", "nms_mask_sorted"),
           "K2-before": ("roi_align_multilevel.cu", "roi_align_multilevel"),
           "K2b-before": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward"),
           "K5a-before": ("int8_conv_requant.cu", "int8_conv_requant"),
           "K5-before": ("basic_block_chain.cu", "basic_block_chain"),
           "K6-before": ("bottleneck_chain.cu", "bottleneck_chain"), "K7-before": ("up_exchange.cu", "up_exchange"),
           "K1": ("crop_bilinear.cu", "crop_bilinear"), "K1-before": ("crop_bilinear.cu", "crop_bilinear")}
# K5a's C entry before it took a clip bound and explicit padding: (x, wk, m, b, out, B, H, W, Cin, Ho, Wo, Cout,
# k, stride, groups, relu, out_f32, stream)
K5A_BEFORE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
CHAINS = [(16, 128, 128, 32), (16, 64, 64, 64), (16, 32, 32, 128), (16, 16, 16, 256)]  # W32 branches, 4 blocks
CONVS = [  # (B, H, W, Cin, Cout, k, stride): R101 at the 768 letterbox, HRNet-W32 at 512
    (4, 192, 192, 64, 256, 1, 1), (4, 192, 192, 256, 64, 1, 1), (4, 192, 192, 64, 64, 3, 1),
    (4, 96, 96, 512, 128, 1, 1), (4, 48, 48, 1024, 256, 1, 1), (4, 48, 48, 256, 256, 3, 1),
    (4, 48, 48, 256, 1024, 1, 1), (4, 24, 24, 512, 2048, 1, 1), (16, 64, 64, 32, 64, 3, 2),
]
LAYER1 = (16, 128, 128, 64, 64, 256, 4)  # (B, H, W, Cin0, Cm, Cout, blocks): HRNet-W32 layer1 at 512
# K1 on each path's crop (PERF.md's K1 rows): (label, crops, frame (H, W), crop side, step in px a pixel, where the
# crops lie: "inside" the frame or across its "edge"); the steps from the rows' bytes (tapped cells a crop), the
# evaluation entry's from its logged crops (3.7-4.0), the CMS evaluation's a guess above 2
K1_SHAPES = [
    ("served", 16, (1200, 1920), 512, 1.39, "inside"),
    ("evaluation entry, mostly off the frame", 8, (1200, 1920), 512, 3.8, "edge"),
    ("train_landmarks validation", 16, (720, 1280), 512, 0.78, "inside"),
    ("train_landmarks_da validation", 16, (1200, 1920), 768, 0.8, "inside"),
    ("CMS evaluation, partly off the frame", 8, (1200, 1920), 768, 2.5, "edge"),
    ("export_model's program", 8, (1200, 1920), 512, 1.33, "inside"),
    ("event evaluation", 8, (260, 346), 512, 0.36, "inside"),
    ("dvs pipeline validation, wider than the frame", 11, (720, 1280), 512, 2.0, "inside"),
    ("tools.demo", 1, (1200, 1920), 512, 1.5, "inside"),
]
EXCHANGES = [  # (B, H, C, downs, [(f, C_j)]): W32 fuse outputs at 512
    (16, 128, 32, 0, [(2, 64), (4, 128)]),  # stage 3, output 0
    (16, 64, 64, 1, [(2, 128), (4, 256)]),  # stage 4, output 1
    (16, 16, 256, 3, []),                   # stage 4, output 3: the n-way add alone
]


def build(cuda, keys, before=None) -> dict:
    """Every variant's copy of csrc/ (of ``before``'s for the ``BEFORE`` ids), edited, with the sources of
    its kernels among ``keys`` built (each source once); {variant: {kernel id: ctypes function}}."""
    root = cuda.BUILD_DIR / "ablate"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, (kernels, edits)) in enumerate(VARIANTS.items()):
        kernels = [k for k in kernels if k in keys]
        if not kernels:
            continue
        d = root / f"v{i}"
        shutil.copytree(before if set(kernels) <= set(BEFORE) else cuda.CSRC, d)
        for fname, text, repl in edits:
            src = (d / fname).read_text()
            if text not in src:
                raise RuntimeError(f"variant {name!r}: {fname} no longer holds {text!r}")
            (d / fname).write_text(src.replace(text, repl))
        for source in {SOURCES[key][0] for key in kernels}:
            out = d / f"{source[:-3]}.so"
            procs[name, source] = (subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out), str(d / source)],
                                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                   out, [k for k in kernels if SOURCES[k][0] == source])
    fns: dict = {}
    for (name, source), (proc, out, kernels) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed for {source}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for key in kernels:
            fns.setdefault(name, {})[key] = getattr(lib, SOURCES[key][1])
    return fns


def graph_ms(torch, fn, calls: int = 10, reps: int = 5) -> float:
    """Device ms of one ``fn()``: ``calls`` of them captured in a CUDA graph,
    replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def pooler_nms_workloads(torch, ra, nms, k4_before: bool = False, k2_before: bool = False):
    """K2, K3 and K4 (label, kernel id, wrapper call, plain result) at the serving shapes: K2 on 256 boxes
    over 4 images that reach all four R101-FPN levels (bf16, 256 channels); K3 on 64 boxes of sides
    16-112 px (P2's range) on the first image's P2 map at scale 0.25, as in its chip_smoke.py phase; K4 on
    the RPN's 20 problems of 256 boxes at IoU 0.7 and the box head's 4 of 64 at 0.5 (chip_smoke's seeded
    edge problems), then the evaluation's 40 of 1000, training's RPN 20 of 2000 and RetinaNet's 10 of 4441.
    With ``k4_before``, each K4 shape of at most 2,048 boxes again as ``K4-before``; with ``k2_before``, K2's
    again as ``K2-before``, its answer this tree's kernel's (bit for bit)."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    boxes = cs.coverage_boxes(torch, 256, cs.POOLER_SIZE, gen).cuda()
    batch_idx = torch.randint(0, 4, (256,), generator=gen, dtype=torch.int32).cuda()
    feats = [torch.randn(4, cs.POOLER_SIZE // s, cs.POOLER_SIZE // s, 256, generator=gen).to("cuda", torch.bfloat16)
             for s in cs.POOLER_STRIDES]
    args = (feats, boxes, batch_idx, 7, cs.POOLER_STRIDES)
    kw = dict(sampling_ratio=2, window=cs.POOLER_WINDOW)
    out = [("K2 256 boxes, P2-P5 of 4x192x192x256 bf16 -> 256x7x7x256 f32", "K2",
            functools.partial(ra.roi_align_multilevel, *args, **kw), ra.roi_align_multilevel_plain(*args, **kw))]
    # the served RPN's problems were 6% valid (323 of 5,120 boxes, chip_smoke.py), its box head's 12%
    for p, n, thresh, share in ((20, 256, 0.7, 0.8), (20, 256, 0.7, 0.06), (4, 64, 0.5, 0.8), (4, 64, 0.5, 0.12)):
        b, v = (t.cuda() for t in cs.nms_edge_problems(torch, n, p, gen, share))
        out.append((f"K4 {p}x{n} at IoU {thresh}, {share:.0%} valid", "K4",
                    functools.partial(nms.nms_mask_sorted, b, v, thresh), nms.nms_mask_sorted_plain(b, v, thresh)))
    # drawn after K4's problems, which keep their earlier inputs
    u = lambda: torch.rand(64, generator=gen, dtype=torch.float64)
    side, centre = 16 * 7 ** u(), torch.stack([u(), u()], -1) * cs.POOLER_SIZE
    p2 = torch.cat([centre - side[:, None] / 2, centre + side[:, None] / 2], -1).float().cuda()
    single = (feats[0][0], p2, 7, 0.25, 2, cs.POOLER_WINDOW)
    out.append(("K3 64 boxes, P2 of 192x192x256 bf16 at scale 0.25 -> 64x7x7x256 f32", "K3",
                functools.partial(ra.roi_align_single, *single), ra.roi_align_single_plain(*single)))
    large = torch.Generator().manual_seed(1)  # its own draws: the shapes above keep their inputs
    for p, n, thresh, share in ((40, 1000, 0.7, 0.8), (20, 2000, 0.7, 0.8), (10, 4441, 0.5, 1.0)):
        b, v = (t.cuda() for t in cs.nms_edge_problems(torch, n, p, large, share))
        out.append((f"K4 {p}x{n} at IoU {thresh}, {share:.0%} valid", "K4",
                    functools.partial(nms.nms_mask_sorted, b, v, thresh), nms.nms_mask_sorted_plain(b, v, thresh)))
    if k4_before:
        out += [(label, "K4-before", call, want) for label, key, call, want in out
                if key == "K4" and call.args[1].shape[1] <= 2048]
    if k2_before:  # this tree's kernel, built as committed, gives the answer
        out += [(label, "K2-before", call, call()) for label, key, call, _ in out if key == "K2"]
    return out


# the atomic K2b's C entry: f32 buffers g0..g3 that it zeroes and adds into, then bf16 outputs o0..o3 it casts them into
ATOMIC_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def k2b_problem(torch):
    """tools/train_detector's config_1 call of K2b, from seed 0: the bf16 P2-P5 of 4 images at 800^2 (200,
    100, 50 and 25 cells a side, C 256) and 128 ROIs an image, as its sampler draws them: 32 around the
    image's one object (60-100 px a side, each corner moved by up to 10% of its side) and 96 elsewhere (16-128 px
    a side, aspect up to 2:1), the ROIs of image i contiguous; grad_out (512, 7, 7, 256) f32; the windowed
    read window of 48. Returns the wrapper's arguments as a dict."""
    gen = torch.Generator().manual_seed(0)
    size, n_img, n_fg, n_bg = 800, 4, 32, 96
    u = lambda *shape: torch.rand(*shape, generator=gen, dtype=torch.float64)
    boxes = []
    for _ in range(n_img):
        side = 60 + 40 * u(2)
        centre = side / 2 + u(2) * (size - side)
        obj = torch.cat([centre - side / 2, centre + side / 2])
        fg = obj + (u(n_fg, 4) - 0.5) * 0.2 * side.repeat(2)
        bg_side, aspect = torch.exp(math.log(16.0) + u(n_bg) * math.log(8.0)), torch.exp((u(n_bg) - 0.5) * math.log(4.0)).sqrt()
        bw, bh, cx, cy = bg_side * aspect, bg_side / aspect, u(n_bg) * size, u(n_bg) * size
        boxes += [fg, torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)]
    r = n_img * (n_fg + n_bg)
    return dict(grad_out=torch.randn(r, 7, 7, 256, generator=gen).cuda(),
                shapes=[(n_img, size // s, size // s, 256) for s in (4, 8, 16, 32)], dtype=torch.bfloat16,
                boxes=torch.cat(boxes).float().cuda(),
                batch_idx=torch.arange(n_img, dtype=torch.int32).repeat_interleave(r // n_img).cuda(),
                output_size=7, strides=(4, 8, 16, 32), sampling_ratio=2, window=48, impl="windowed")


def k2b_workloads(torch, ra, keys, atomic):
    """K2b (and with ``atomic``, a Kernel bound to the atomic K2b's C entry, that kernel) on ``k2b_problem``:
    (label, kernel id, call, plain result)."""
    a = k2b_problem(torch)
    want = ra.roi_align_multilevel_backward_plain(**a)
    levels = ra.assign_levels(a["boxes"], 4, 2)
    label = (f"K2b 512 ROIs (per level P2..P5 {torch.bincount(levels, minlength=4).tolist()}), "
             "P2-P5 of 4x200x200x256 bf16, windowed")
    call = functools.partial(ra.roi_align_multilevel_backward, **a)
    out = [(label, "K2b", call, want)] if "K2b" in keys else []
    if "K2b-before" in keys:  # this tree's kernel, built as committed, gives the answer
        out.append((label, "K2b-before", call, call()))
    if atomic is not None:
        go, shapes, boxes, bidx = a["grad_out"], a["shapes"], a["boxes"], a["batch_idx"]
        # level 0's buffer also holds a private window a ROI for the private-buffer variant
        g = [torch.empty(max(math.prod(shapes[0]), go.shape[0] * PRIVATE_CELLS * 256) if i == 0 else math.prod(sh),
                         device="cuda") for i, sh in enumerate(shapes)]
        outs = [torch.empty(sh, dtype=torch.bfloat16, device="cuda") for sh in shapes]
        ptr = lambda t_: ctypes.c_void_p(t_.data_ptr())
        hw = [d for sh in shapes for d in sh[1:3]]

        def call():
            atomic.launch(ptr(go), *map(ptr, g), *map(ptr, outs), *hw, 4, 4, 2, 1, ptr(boxes), ptr(bidx),
                        go.shape[0], 256, 7, 2, 48, 0, 224.0, 4)
            return outs

        out.append((label + " (the atomic kernel)", "K2b-atomic", call, want))
    return out


def k1_problem(torch, b, hw, side, step, where, seed):
    """K1's arguments for one ``K1_SHAPES`` entry: seeded uint8 frames and (b, 4) parameters whose crops of
    ``side``^2 sample every ``step`` px around centres inside the frame, or across its edge."""
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).cuda()
    u = lambda: torch.rand(b, generator=gen, dtype=torch.float64)
    half = step * side / 2
    if where == "edge":
        cx, cy = u() * w, (u() < 0.5) * h + (u() - 0.5) * half
    else:  # inside where the crop fits, else centred
        cx, cy = (half + u() * max(w - 2 * half, 0.0) if 2 * half < w else torch.full((b,), w / 2.0),
                  half + u() * max(h - 2 * half, 0.0) if 2 * half < h else torch.full((b,), h / 2.0))
    params = torch.stack([torch.full((b,), step, dtype=torch.float64), cx - half,
                          torch.full((b,), step, dtype=torch.float64), cy - half], -1).float().cuda()
    return frames, params, (side, side)


def k1_workloads(torch, warp, keys):
    """K1 (and ``K1-before``, its answer this tree's kernel's) on every ``K1_SHAPES`` entry."""
    out = []
    for i, (label, b, hw, side, step, where) in enumerate(K1_SHAPES):
        args = k1_problem(torch, b, hw, side, step, where, i)
        text = f"K1 {label}: {b} crops of {side}^2 from {hw[1]}x{hw[0]}, step {step}"
        call = functools.partial(warp.crop_bilinear, *args)
        if "K1" in keys:
            out.append((text, "K1", call, warp.crop_bilinear_plain(*args)))
        if "K1-before" in keys:  # this tree's kernel, built as committed, gives the answer
            out.append((text, "K1-before", call, call()))
    return out


def per_call_us(torch, fn, calls: int = 2000, warm: int = 200) -> float:
    """Host microseconds of one ``fn()``: ``calls`` back-to-back calls under ``time.perf_counter_ns``, then a
    synchronize (the launches queue up only where a call's host time is below its device time, which no
    K1 layer's is)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls / 1e3


def k1_host_split(torch, warp, cuda, rounds: int = 3) -> dict:
    """The host's cost of one K1 call on the demo's crop (one 512^2 crop of a 1920x1200 frame at step 1.5),
    layer by layer: this tree's route (``warp.crop_bilinear`` -> ``torch.ops.spe_port.crop_bilinear``, a
    ``torch.library.Library`` operator -> ``_crop_bilinear_cuda`` -> ``Kernel.launch``), the operator as a
    ``torch.library.custom_op`` instead, rebuilt here, whose CUDA implementation reads the stream through
    ``torch.cuda.current_stream()``, each piece alone, and ``F.grid_sample`` on the same crop. Rounds in turn;
    {layer: [us a call, one a round]}."""
    import torch.nn.functional as F

    frames, params, (ow, oh) = k1_problem(torch, 1, (1200, 1920), 512, 1.5, "inside", 99)
    b, h, w, _ = frames.shape
    out = torch.empty((b, oh, ow, 3), dtype=torch.float32, device="cuda")
    warp.KERNEL._fn = None  # this tree's K1, built as committed
    fn = warp.KERNEL._function()
    fn_gil = getattr(ctypes.PyDLL(str(cuda._target(warp.KERNEL.source))), warp.KERNEL.name)
    fn_gil.argtypes, fn_gil.restype = warp.KERNEL.argtypes, ctypes.c_int

    def custom_checks(f, p):  # as the custom_op route had them: the device read through device.type
        for name, t, dtype, dims in (("frames", f, torch.uint8, 4), ("params", p, torch.float32, 2)):
            if t.device.type != "cuda" or t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
                raise ValueError(f"{name}: not a contiguous CUDA tensor of {dtype}")
        bb, _, _, ch = f.shape
        if ch != 3 or tuple(p.shape) != (bb, 4):
            raise ValueError("frames and params disagree")

    def checks():  # _crop_bilinear_cuda's: check_cuda_tensor on is_cuda, the shape test on torch.Size
        cuda.check_cuda_tensor("frames", frames, torch.uint8, 4)
        cuda.check_cuda_tensor("params", params, torch.float32, 2)
        bb, _, _, ch = frames.shape
        if ch != 3 or params.shape != (bb, 4):
            raise ValueError("frames and params disagree")

    def custom_cuda(frames: torch.Tensor, params: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
        custom_checks(frames, params)
        bb, hh, ww, _ = frames.shape
        o = torch.empty((bb, out_h, out_w, 3), dtype=torch.float32, device=frames.device)
        err = fn(cuda.ptr(frames), cuda.ptr(params), cuda.ptr(o), bb, hh, ww, out_h, out_w,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K1: CUDA error {err}")
        return o

    custom = torch.library.custom_op("spe_ablate::crop_bilinear_custom_op", custom_cuda, mutates_args=(), device_types="cuda",
                                   schema="(Tensor frames, Tensor params, SymInt out_w, SymInt out_h) -> Tensor")
    xs = params[:, 0:1] * torch.arange(ow, device="cuda") + params[:, 1:2]
    ys = params[:, 2:3] * torch.arange(oh, device="cuda") + params[:, 3:4]
    grid = torch.stack([((2 * xs + 1) / w - 1)[:, None, :].expand(-1, oh, -1),
                        ((2 * ys + 1) / h - 1)[:, :, None].expand(-1, -1, ow)], dim=-1)
    frames_f = frames.permute(0, 3, 1, 2).float()
    fp, pp, op_ = frames.data_ptr(), params.data_ptr(), out.data_ptr()
    raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    layers = {
        "warp.crop_bilinear, the whole call (eager: past the dispatcher)": lambda: warp.crop_bilinear(
            frames, params, (ow, oh)),
        "torch.ops.spe_port.crop_bilinear.default (the Library operator: an exported program's call)":
            lambda: warp.crop_bilinear_op(frames, params, ow, oh),
        "_crop_bilinear_cuda alone": lambda: warp._crop_bilinear_cuda(frames, params, ow, oh),
        "custom_op route: the whole call": lambda: custom(frames, params, ow, oh),
        "custom_op route: its CUDA implementation alone": lambda: custom_cuda(frames, params, ow, oh),
        "custom_op route: checks (the device read through device.type)": lambda: custom_checks(frames, params),
        "checks (check_cuda_tensor on is_cuda)": checks,
        "custom_op route: torch.empty of the output, device=": lambda: torch.empty((b, oh, ow, 3), dtype=torch.float32,
                                                                          device=frames.device),
        "new_empty of the output": lambda: frames.new_empty((b, oh, ow, 3), dtype=torch.float32),
        "params.new_empty of the output (no dtype)": lambda: params.new_empty((b, oh, ow, 3)),
        "custom_op route: torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "the raw stream (_cuda.Kernel.launch now)": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "Kernel.launch (stream, ctypes call, count)": lambda: warp.KERNEL.launch(fp, pp, op_, b, h, w, oh, ow),
        "the ctypes call alone (the launch included)": lambda: fn(fp, pp, op_, b, h, w, oh, ow, raw),
        "the same call through ctypes.PyDLL (the GIL kept)": lambda: fn_gil(fp, pp, op_, b, h, w, oh, ow, raw),
        "F.grid_sample, the yardstick": lambda: F.grid_sample(frames_f, grid, mode="bilinear", padding_mode="zeros",
                                                              align_corners=False),
    }
    if not torch.equal(custom(frames, params, ow, oh), warp.crop_bilinear(frames, params, (ow, oh))):
        raise RuntimeError("K1 host split: the custom_op route and this tree's give other crops")
    split: dict = {}
    for _ in range(rounds):
        for name, call in layers.items():
            split.setdefault(name, []).append(round(per_call_us(torch, call), 3))
    return split


def agrees(torch, key, got, want) -> bool:
    """A variant's answer against the plain version's, with chip_smoke.py's bars: exact; K2/K3 within 1e-5
    of the output's scale; K2b within 2^-7 of its bf16 gradient's scale. --before's K2, K2b, int8
    kernels and K1 against this tree's: bit for bit. K1 within chip_smoke.py's 1e-3 grey."""
    if key in ("K2-before", "K2b-before", "K1-before") + INT8_BEFORE:
        return all(map(torch.equal, got, want)) if isinstance(got, list) else torch.equal(got, want)
    if key.startswith("K2b"):
        scale = max(w.float().abs().max().item() for w in want)
        return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)) <= 2.0 ** -7 * scale
    if torch.equal(got, want):
        return True
    if key == "K1":
        return (got - want).abs().max().item() <= 1e-3
    return key in ("K2", "K3") and (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def k5a_before_call(torch, kernel, x, wk, m, b, stride, relu):
    """A call of --before's K5a through its own C entry (``K5A_BEFORE_ARGTYPES``): SAME padding, no clip."""
    bsz, h, w, cin = x.shape
    cout, k = wk.shape[:2]
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    ptr = lambda t_: ctypes.c_void_p(t_.data_ptr())

    def call():
        kernel.launch(ptr(x), ptr(wk), ptr(m), ptr(b), ptr(out), bsz, h, w, cin, ho, wo, cout, k, stride, 1,
                      int(relu), 0)
        return out

    return call


def workloads(torch, ic, ib, before=(), k5a_before=None):
    """(label, kernel id, wrapper call, plain result) at the serving shapes, from seed 0; with ``before``
    (ids of ``INT8_BEFORE``), each of those kernels' shapes again under its ``-before`` id, its answer this
    tree's kernel's (``k5a_before``: the Kernel bound to --before's K5a entry)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def i8(*shape):
        return torch.randint(-50, 50, shape, dtype=torch.int8, device="cuda", generator=g)

    def unif(*shape):
        return torch.rand(*shape, device="cuda", generator=g)

    out = []
    for bsz, h, w, c in CHAINS:
        n = 4
        x, wt = i8(bsz, h, w, c), i8(n, 2, 3, 3, c, c)
        m, b = unif(n, 2, c) * 60.0 / (50 * 50 * (9 * c) ** 0.5) + 1e-4, (unif(n, 2, c) - 0.5) * 6
        co, wk = unif(n, 2) * 0.8 + 0.4, ic.pack_kmajor(wt)
        out.append((f"K5 {bsz}x{h}x{w}x{c}, {n} blocks", "K5",
                    lambda x=x, wt=wt, m=m, b=b, co=co, wk=wk: ib.basic_block_chain(x, wt, m, b, co, n, wk=wk),
                    ib.basic_block_chain_plain(x, wt, m, b, co, n)))
    bsz, h, w, cin0, cm, cout, n = LAYER1
    x, w1, w2, w3, wd = i8(bsz, h, w, cin0), i8(n, cout, cm), i8(n, 3, 3, cm, cm), i8(n, cm, cout), i8(cin0, cout)
    w1[0, cin0:] = 0  # block 0 reads Cin0 rows of the padded w1

    def requant_vectors(c, fan_in, *lead):
        return unif(*lead, c) * 60.0 / (50 * 50 * fan_in ** 0.5) + 1e-4, (unif(*lead, c) - 0.5) * 6

    ops = (w1, *requant_vectors(cm, cout, n), w2, *requant_vectors(cm, 9 * cm, n), w3,
           *requant_vectors(cout, cm, n), wd, *requant_vectors(cout, cin0), unif(n, 2) * 0.8 + 0.4)
    wk = ib.pack_bottleneck_kmajor(w1, w2, w3, wd)
    want = ib.bottleneck_chain_plain(x, *ops, n)
    for strip, route in ((32, "K6s, 32-row strips"), (None, "K6, two strips per image")):
        out.append((f"{route} {bsz}x{h}x{w}x{cin0} -> {cout}, {n} blocks", "K6",
                    functools.partial(ib.bottleneck_chain, x, *ops, n, strip=strip, wk=wk), want))
    for bsz, h, c, nd, ups in EXCHANGES:
        yi, downs = i8(bsz, h, h, c), [i8(bsz, h, h, c) for _ in range(nd)]
        up_ops = [(i8(bsz, h // f, h // f, cu), i8(cu, c), *requant_vectors(c, cu)) for f, cu in ups]
        wks = [ic.pack_kmajor(w[None, None]) for _, w, _, _ in up_ops]
        co = unif(1 + nd + len(ups)) * 0.9 + 0.3
        out.append((f"K7 {bsz}x{h}x{h}x{c}, {nd} downs, ups {ups}", "K7",
                    lambda yi=yi, d=downs, u=up_ops, co=co, wks=wks: ib.up_exchange(yi, d, u, co, wks=wks),
                    ib.up_exchange_plain(yi, downs, up_ops, co)))
    for bsz, h, w, cin, cout, k, s in CONVS:
        x, wt = i8(bsz, h, w, cin), i8(k, k, cin, cout)
        m, b = unif(cout) * 60.0 / (50 * 50 * (k * k * cin) ** 0.5), (unif(cout) - 0.5) * 10
        wk = ic.pack_kmajor(wt)
        out.append((f"K5a {bsz}x{h}x{w}x{cin} -> {cout}, k{k} s{s}", "K5a",
                    lambda x=x, wt=wt, m=m, b=b, s=s, wk=wk: ic.int8_conv(x, wt, m, b, stride=s, relu=True, wk=wk),
                    ic.int8_conv_plain(x, wt, m, b, s, 1, True, False)))
        if "K5a-before" in before:
            out.append((out[-1][0], "K5a-before", k5a_before_call(torch, k5a_before, x, wk, m, b, s, True),
                        out[-1][2]()))
    # this tree's kernels, built as committed, give the answers
    out += [(label, f"{key}-before", call, call()) for label, key, call, _ in list(out)
            if f"{key}-before" in before and key != "K5a"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device is available", file=sys.stderr)
        return 1
    from spacecraft_pose_estimation_tpu_torch import _cuda
    from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks, int8_conv, nms, roi_align, warp

    argv, before = sys.argv[1:], None
    if "--before" in argv:
        i = argv.index("--before")
        before = Path(argv[i + 1]) / "spacecraft_pose_estimation_tpu_torch" / "csrc"
        argv = argv[:i] + argv[i + 2:]
        if not (before / "roi_align_multilevel_backward.cu").exists():
            raise SystemExit(f"chip_ablate: {before} holds no roi_align_multilevel_backward.cu")
    keys = argv or [k for k in SOURCES if before is not None or k not in BEFORE]
    if set(keys) - set(SOURCES) or (before is None and set(keys) & set(BEFORE)):
        raise SystemExit(f"chip_ablate: kernel ids are {list(SOURCES)} ({BEFORE} with --before), got {keys}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    fns = build(_cuda, keys, before)
    print(f"built {len(fns)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    k5a_before = _cuda.Kernel(*SOURCES["K5a-before"][::-1], K5A_BEFORE_ARGTYPES) if "K5a-before" in keys else None
    kernels = {"K5a": int8_conv.KERNEL, "K5": int8_blocks.CHAIN, "K6": int8_blocks.BOTTLENECK,
               "K7": int8_blocks.EXCHANGE, "K2": roi_align.KERNEL, "K3": roi_align.SINGLE, "K4": nms.KERNEL,
               "K2b": roi_align.BACKWARD, "K4-before": nms.KERNEL,  # one wrapper: each variant points it at its K4
               "K2-before": roi_align.KERNEL, "K2b-before": roi_align.BACKWARD, "K5a-before": k5a_before,
               "K5-before": int8_blocks.CHAIN, "K6-before": int8_blocks.BOTTLENECK, "K7-before": int8_blocks.EXCHANGE,
               "K2b-atomic": _cuda.Kernel(*SOURCES["K2b-atomic"][::-1], ATOMIC_ARGTYPES),
               "K1": warp.KERNEL, "K1-before": warp.KERNEL}  # one wrapper: each variant points it at its K1
    times: dict = {}
    work = (workloads(torch, int8_conv, int8_blocks, set(keys) & set(INT8_BEFORE), k5a_before)
            if set(keys) & set(INT8 + INT8_BEFORE) else []) + \
        (pooler_nms_workloads(torch, roi_align, nms, "K4-before" in keys, "K2-before" in keys)
         if set(keys) & {"K2", "K3", "K4", "K4-before", "K2-before"} else []) + \
        (k2b_workloads(torch, roi_align, keys, kernels["K2b-atomic"] if "K2b-atomic" in keys else None)
         if set(keys) & {"K2b", "K2b-atomic", "K2b-before"} else []) + \
        (k1_workloads(torch, warp, keys) if set(keys) & {"K1", "K1-before"} else [])
    for _ in range(2):  # two turns through the variants, to show the spread
        for name, by_key in fns.items():
            for key, fn in by_key.items():
                fn.argtypes, fn.restype = kernels[key].argtypes, ctypes.c_int
                kernels[key]._fn = fn
            for label, key, call, want in work:
                if key not in by_key:
                    continue
                got = call()
                torch.cuda.synchronize()
                if name in EXACT and not agrees(torch, key, got, want):
                    raise RuntimeError(f"{label}: {name!r} disagrees with the plain version")
                if name == "as committed" and key == "K2b" and not all(map(torch.equal, got, call())):
                    raise RuntimeError(f"{label}: two calls of K2b differ")
                calls = 50 if key in ("K2", "K3", "K4", "K4-before", "K2-before", "K1", "K1-before") else 10  # ~1 ms a replay, as chip_smoke's k
                times.setdefault(label, {}).setdefault(name, []).append(round(graph_ms(torch, call, calls), 5))
    for label, by_variant in times.items():
        print(json.dumps({"shape": label, "device_ms": by_variant}), flush=True)
    if "K1" in keys:
        for layer, us in k1_host_split(torch, warp, _cuda).items():
            print(json.dumps({"k1_host_layer": layer, "us_a_call": us}), flush=True)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
