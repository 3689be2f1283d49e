#!/usr/bin/env python3
"""Where the time of the int8 tensor-core kernels K5a, K5, K6 and K7 goes, on one CUDA card.

    python3 chip_ablate.py

from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit. It copies ``spacecraft_pose_estimation_tpu_torch/csrc`` once per
variant into the gitignored ``_build/ablate/``, edits one piece of the
tensor-core conv body out of each copy (the epilogue, the wgmma, the
copies into shared memory, K5's cluster barriers) or changes the ring's
depth or K7's tile rows, builds every copy (one nvcc per source, in
parallel), and times each variant's K5a, K5, K6 and K7 at the serving
shapes (HRNet-W32's four branch chains; R101 and HRNet conv sites; layer1
in 32-row strips and in two strips per image; three fuse-exchange outputs)
from CUDA graphs, turn by turn in one process. Only the unedited source is held to the plain versions: the
others compute wrong answers on purpose, and their times say what the
removed piece costs. Prints the card, one JSON line per shape and a last
line ``{"ok": true, ...}``; without a CUDA device it exits 1.
"""

from __future__ import annotations

import ctypes
import functools
import json
import shutil
import subprocess
import sys
import time

# variant -> [(file, text, replacement)] applied to a copy of csrc/
VARIANTS = {
    "as committed": [],
    "no epilogue": [("int8_mma.cuh", "  store_tile<TN>(cw, rg, ld.p_base, ld.c_base, acc, smem, epi);",
                     "  if (acc[0] == 0x7fffffff) store_tile<TN>(cw, rg, ld.p_base, ld.c_base, acc, smem, epi);")],
    "no wgmma": [("int8_mma.cuh",
                  "      if (kk < nk) wgmma_s8<TN>(acc, desc_sw128(sa + kChunk * kk), desc_sw128(sb + kChunk * kk));",
                  "      ;")],
    "no copies": [("int8_mma.cuh", "    if (nxt < ld.nstage) ld.stage(smem, nxt % kStages, nxt);", "    ;"),
                  ("int8_mma.cuh", "      if (st < nstage) stage(smem, st, st);", "      ;")],
    "no cluster barriers": [("basic_block_chain.cu", "    cluster_barrier();\n    // conv2", "    // conv2"),
                            ("basic_block_chain.cu", "    cluster_barrier();\n    cur = Src", "    cur = Src")],
    "4-stage ring": [("int8_mma.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "K7 tiles of the fewest rows": [("up_exchange.cu", "constexpr int kMaxTileRows = 32;",
                                     "constexpr int kMaxTileRows = 1;")],
    "K7 tiles of 32 rows": [("up_exchange.cu", "constexpr int kMinBlocksPerSm = 2;",
                             "constexpr int kMinBlocksPerSm = 0;")],
}
SOURCES = {"K5a": ("int8_conv_requant.cu", "int8_conv_requant"), "K5": ("basic_block_chain.cu", "basic_block_chain"),
           "K6": ("bottleneck_chain.cu", "bottleneck_chain"), "K7": ("up_exchange.cu", "up_exchange")}
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


def build(cuda) -> dict:
    """Every variant's copy of csrc/, edited and built; {variant: {kernel id: ctypes function}}."""
    root = cuda.BUILD_DIR / "ablate"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = root / f"v{i}"
        shutil.copytree(cuda.CSRC, d)
        for fname, text, repl in edits:
            src = (d / fname).read_text()
            if text not in src:
                raise RuntimeError(f"variant {name!r}: {fname} no longer holds {text!r}")
            (d / fname).write_text(src.replace(text, repl))
        for key, (source, _) in SOURCES.items():
            out = d / f"{source[:-3]}.so"
            procs[name, key] = (subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out), str(d / source)],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns: dict = {}
    for (name, key), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed for {SOURCES[key][0]}:\n{log}")
        fns.setdefault(name, {})[key] = getattr(ctypes.CDLL(str(out)), SOURCES[key][1])
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
    from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks, int8_conv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    fns = build(_cuda)
    print(f"built {len(VARIANTS)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = {"K5a": int8_conv.KERNEL, "K5": int8_blocks.CHAIN, "K6": int8_blocks.BOTTLENECK,
               "K7": int8_blocks.EXCHANGE}
    times: dict = {}
    work = workloads(torch, int8_conv, int8_blocks)
    for _ in range(2):  # two turns through the variants, to show the spread
        for name, by_key in fns.items():
            for key, fn in by_key.items():
                fn.argtypes, fn.restype = kernels[key].argtypes, ctypes.c_int
                kernels[key]._fn = fn
            for label, key, call, want in work:
                got = call()
                torch.cuda.synchronize()
                if name == "as committed" and not torch.equal(got, want):
                    raise RuntimeError(f"{label}: the committed kernel disagrees with its plain version")
                times.setdefault(label, {}).setdefault(name, []).append(round(graph_ms(torch, call), 5))
    for label, by_variant in times.items():
        print(json.dumps({"shape": label, "device_ms": by_variant}), flush=True)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
