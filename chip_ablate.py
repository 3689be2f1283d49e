#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one CUDA card: the int8 tensor-core kernels K5a, K5, K6
and K7, the ROIAlign kernel (K2 on the FPN, K3 on one map), its backward K2b and the NMS K4.

    python3 chip_ablate.py [--before TREE] [KERNEL ...]

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit; with kernel ids (``K2 K4``) it times only their variants and
shapes. It copies ``spacecraft_pose_estimation_tpu_torch/csrc`` once per
variant into the gitignored ``_build/ablate/``, edits one piece of a
kernel out of each copy (the tensor-core conv body's epilogue, wgmma or
copies into shared memory, K5's cluster barriers, the ROIAlign kernel's loads, its stores or all
but its launch, K2b's grad_out loads, its sums, all but its footprint walk, its stores or all but its
launches, K4's overlap phase, its walk or all but its launch), changes one of its sizes, or swaps in an
exact alternative (K2b's rows a warp and columns a block; the ROIAlign sampling ratio fixed at the served 2, K4's IoU
decision by division, its walk not unrolled or not skipping empty
quarters of a word), builds each copy's sources of the kernels the variant
touches (one nvcc per source, in parallel), and times each variant's
kernels at the serving shapes (HRNet-W32's four branch chains; R101 and
HRNet conv sites; layer1 in 32-row strips and in two strips per image;
three fuse-exchange outputs; K2 on 256 boxes over the four R101-FPN
levels; K3 on 64 P2-sized boxes on one 192x192x256 bf16 map; K4 on the RPN's and the box head's problems, with as many valid
boxes as the served ones and with most valid; K2b on tools/train_detector's config_1 call: 512 ROIs over
the bf16 P2-P5 of 4 images at 800^2, C 256, a quarter of each image's clustered on its object) from CUDA
graphs, turn by turn in one process. With ``--before TREE``, a checkout of the port as it was when K2b
summed with float32 atomics (the commit before the owner-computes K2b), the kernel id ``K2b-atomic`` times
that K2b too, split into its memset and cast alone, its atomic kernel alone, and the atomic kernel with
each ROI's gradient sent to a private buffer of its own (no two ROIs add into one address), and ``K4-before``
times that tree's K4 beside this one's on every K4 shape it takes (up to 2,048 boxes before K4 took 8,192;
the shapes add the evaluation's 40x1000, training's RPN 20x2000 and RetinaNet's 10x4441); ``K2-before``
and ``K2b-before`` time that tree's K2 and K2b on K2's call (the Pallas read window) and K2b's (the
windowed one) and hold them bit for bit to this tree's (a change that adds a read keeps these). Only the
unedited source and the exact
alternatives are held to the plain versions: the others compute wrong answers
on purpose, and their times say what the removed piece costs. Prints the
card, one JSON line per shape and a last line ``{"ok": true, ...}``;
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
    "as committed": (INT8 + ("K2", "K3", "K4", "K2b"), []),
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
}
# variants that must still agree with the plain versions: the committed sources and the other exact designs
EXACT = ("as committed",) + tuple(name for name in VARIANTS if name.endswith("(exact)"))
BEFORE = ("K2b-atomic", "K4-before", "K2-before", "K2b-before")  # kernel ids built from --before's sources
SOURCES = {"K5a": ("int8_conv_requant.cu", "int8_conv_requant"), "K5": ("basic_block_chain.cu", "basic_block_chain"),
           "K6": ("bottleneck_chain.cu", "bottleneck_chain"), "K7": ("up_exchange.cu", "up_exchange"),
           "K2": ("roi_align_multilevel.cu", "roi_align_multilevel"), "K3": ("roi_align_multilevel.cu", "roi_align_single"),
           "K2b": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward"),
           "K2b-atomic": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward"),
           "K4": ("nms_mask_sorted.cu", "nms_mask_sorted"), "K4-before": ("nms_mask_sorted.cu", "nms_mask_sorted"),
           "K2-before": ("roi_align_multilevel.cu", "roi_align_multilevel"),
           "K2b-before": ("roi_align_multilevel_backward.cu", "roi_align_multilevel_backward")}
CHAINS = [(16, 128, 128, 32), (16, 64, 64, 64), (16, 32, 32, 128), (16, 16, 16, 256)]  # W32 branches, 4 blocks
CONVS = [  # (B, H, W, Cin, Cout, k, stride): R101 at the 768 letterbox, HRNet-W32 at 512
    (4, 192, 192, 64, 256, 1, 1), (4, 192, 192, 256, 64, 1, 1), (4, 192, 192, 64, 64, 3, 1),
    (4, 96, 96, 512, 128, 1, 1), (4, 48, 48, 1024, 256, 1, 1), (4, 48, 48, 256, 256, 3, 1),
    (4, 48, 48, 256, 1024, 1, 1), (4, 24, 24, 512, 2048, 1, 1), (16, 64, 64, 32, 64, 3, 2),
]
LAYER1 = (16, 128, 128, 64, 64, 256, 4)  # (B, H, W, Cin0, Cm, Cout, blocks): HRNet-W32 layer1 at 512
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


def agrees(torch, key, got, want) -> bool:
    """A variant's answer against the plain version's, with chip_smoke.py's bars: exact; K2/K3 within 1e-5
    of the output's scale; K2b within 2^-7 of its bf16 gradient's scale. --before's K2 and K2b against this
    tree's: bit for bit."""
    if key in ("K2-before", "K2b-before"):
        return all(map(torch.equal, got, want)) if isinstance(got, list) else torch.equal(got, want)
    if key.startswith("K2b"):
        scale = max(w.float().abs().max().item() for w in want)
        return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)) <= 2.0 ** -7 * scale
    if torch.equal(got, want):
        return True
    return key in ("K2", "K3") and (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def workloads(torch, ic, ib):
    """(label, kernel id, wrapper call, plain result) at the serving shapes, from seed 0."""
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
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device is available", file=sys.stderr)
        return 1
    from spacecraft_pose_estimation_tpu_torch import _cuda
    from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks, int8_conv, nms, roi_align

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
    kernels = {"K5a": int8_conv.KERNEL, "K5": int8_blocks.CHAIN, "K6": int8_blocks.BOTTLENECK,
               "K7": int8_blocks.EXCHANGE, "K2": roi_align.KERNEL, "K3": roi_align.SINGLE, "K4": nms.KERNEL,
               "K2b": roi_align.BACKWARD, "K4-before": nms.KERNEL,  # one wrapper: each variant points it at its K4
               "K2-before": roi_align.KERNEL, "K2b-before": roi_align.BACKWARD,
               "K2b-atomic": _cuda.Kernel(*SOURCES["K2b-atomic"][::-1], ATOMIC_ARGTYPES)}
    times: dict = {}
    work = (workloads(torch, int8_conv, int8_blocks) if set(keys) & set(INT8) else []) + \
        (pooler_nms_workloads(torch, roi_align, nms, "K4-before" in keys, "K2-before" in keys)
         if set(keys) & {"K2", "K3", "K4", "K4-before", "K2-before"} else []) + \
        (k2b_workloads(torch, roi_align, keys, kernels["K2b-atomic"] if "K2b-atomic" in keys else None)
         if set(keys) & {"K2b", "K2b-atomic", "K2b-before"} else [])
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
                calls = 50 if key in ("K2", "K3", "K4", "K4-before", "K2-before") else 10  # ~1 ms a replay, as chip_smoke's k
                times.setdefault(label, {}).setdefault(name, []).append(round(graph_ms(torch, call, calls), 5))
    for label, by_variant in times.items():
        print(json.dumps({"shape": label, "device_ms": by_variant}), flush=True)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
