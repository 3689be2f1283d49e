// The int8 tensor-core conv body of every int8 kernel: K5a
// (int8_conv_requant.cu), K5 (basic_block_chain.cu), K6 (bottleneck_chain.cu)
// and K7 (up_exchange.cu).
//
// conv_tile_mma computes one tile of kTM = 128 output pixels x TN (32, 64
// or 128) output channels of an int8 x int8 -> int32 convolution (NHWC
// activations, K-major weights (cout, k, k, cin), k x k taps, stride s,
// zero padding pad_y rows above and pad_x columns left, k / 2 for the
// SAME convs of K5, K6 and K7) as an implicit GEMM on the int8 tensor cores, then
// hands every sum to an epilogue of int8_common.cuh.
//
// * The multiply is wgmma.mma_async m64nTNk32 .s32.s8.s8 with A and B in
//   shared memory: 256 threads are two warpgroups, each owning 64 pixel
//   rows of the tile and all TN channels. The int32 sums are exact, so the
//   epilogues (rintf, two roundings under --fmad=false) give the plain
//   version's bits.
// * The GEMM's K runs over (tap, 32-channel chunk). A stage holds 4 chunks:
//   one 128-byte row per pixel (A) and per output channel (B), in the
//   128-byte swizzled layout that wgmma reads (16-byte piece q of row r at
//   piece q ^ (r % 8)); the descriptor advances 32 bytes per chunk.
// * A ring of kStages stages is filled by cp.async.cg 16-byte copies
//   (L2 only: inside a cluster, activations must not come from L1); a
//   pixel outside the image (the conv's zero padding) or a channel past cin
//   is a copy of 0 source bytes, which zero-fills. While the tensor cores
//   work on one stage, the copies of the next kStages - 1 are in flight.
//   With cin not a multiple of 16 (the tiny test widths) the pieces are
//   loaded as 4-byte words through registers instead, still with ld.cg.
// * The tile's outputs are staged in shared memory (the ring's bytes) and
//   stored as 16-byte runs of one pixel's channels; a residual add reads
//   its operand as the same 16-byte runs. The destination is a generic
//   pointer: it may lie in shared memory outside the ring (K7's low-res
//   buffers).
#pragma once

#include "int8_common.cuh"

namespace spe_i8 {

constexpr int kTM = 128;           // output pixels per tile, 64 per warpgroup
constexpr int kChunk = 32;         // input channels of one tap: one k32 wgmma
constexpr int kChunksPerStage = 4;
constexpr int kRowBytes = kChunk * kChunksPerStage;  // 128: one swizzle row
constexpr int kStages = 3;         // ring slots: one multiplies while the others load

template <int TN>
struct MmaCfg {
  static_assert(TN == 32 || TN == 64 || TN == 128, "TN is 32, 64 or 128");
  static constexpr int kStageBytes = (kTM + TN) * kRowBytes;
  // + 1024: the ring is placed at the first 1024-byte boundary (the swizzle atom)
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary of dynamic shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread become visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of a K-major operand: rows of 128 bytes, 128-byte swizzle,
// 8-row groups 1024 bytes apart (SBO); the leading offset is unused (1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x N int32, wgmma's accumulator layout) += A (64 x 32) * B (N x 32)^T.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Output pixel p < npx of a conv's region is (row0 + p / ncols, col0 + p % ncols).
struct Region {
  int row0, col0, ncols, npx;
};

// One tile's operand copies: output pixels [tile_p * kTM, +kTM) of the
// region and channels [tile_c * TN, +TN); with groups > 1 a tile's
// channels lie in one group. V16: cin (per group) is a multiple of 16 and
// the activation and weight pointers are 16-byte aligned, so every 16-byte
// piece is one cp.async. Thread tid fills piece q = tid % 8 of rows
// tid / 8 + 32 j of A (pixels) and B (output channels).
template <int TN, bool V16>
struct TileLoad {
  static constexpr int kRowsA = kTM / 32, kRowsB = TN / 32;
  const Src& s;
  const ConvW& cw;
  int p_base, c_base, cin_off, nci, nchunk, nstage;
  int iy0[kRowsA], ix0[kRowsA];

  __device__ TileLoad(const Src& s_, const ConvW& cw_, const Region& rg, int tile_p, int tile_c)
      : s(s_), cw(cw_), p_base(tile_p * kTM), c_base(tile_c * TN) {
    cin_off = cw_.groups > 1 ? (c_base / (cw_.cout / cw_.groups)) * cw_.cin : 0;
    nci = (cw_.cin + kChunk - 1) / kChunk;  // chunks per tap
    nchunk = cw_.k * cw_.k * nci;
    nstage = (nchunk + kChunksPerStage - 1) / kChunksPerStage;
#pragma unroll
    for (int j = 0; j < kRowsA; ++j) {
      const int p = p_base + threadIdx.x / 8 + 32 * j;
      iy0[j] = -(1 << 28);  // a pixel past npx reads as padding
      ix0[j] = 0;
      if (p < rg.npx) {
        iy0[j] = (rg.row0 + p / rg.ncols) * cw_.stride - cw_.pad_y;
        ix0[j] = (rg.col0 + p % rg.ncols) * cw_.stride - cw_.pad_x;
      }
    }
  }

  // 16 bytes from src (in: cvalid > 0 bytes of it are real) to dst.
  __device__ __forceinline__ static void piece(uint8_t* dst, const int8_t* src, bool in, int cvalid) {
    if constexpr (V16) {
      cp_async16(smem_u32(dst), src, in ? 16 : 0);
    } else {
      int4 v = make_int4(0, 0, 0, 0);
      if (in) {
        const int* w4 = reinterpret_cast<const int*>(src);
        v.x = __ldcg(w4);
        if (cvalid > 4) v.y = __ldcg(w4 + 1);
        if (cvalid > 8) v.z = __ldcg(w4 + 2);
        if (cvalid > 12) v.w = __ldcg(w4 + 3);
      }
      *reinterpret_cast<int4*>(dst) = v;
    }
  }

  // K stage st (chunks [4 st, 4 st + 4)) into ring slot `slot`.
  __device__ void stage(uint8_t* smem, int slot, int st) const {
    uint8_t* a = smem + slot * MmaCfg<TN>::kStageBytes;
    uint8_t* b = a + kTM * kRowBytes;
    const int tid = threadIdx.x, q = tid % 8;
    const int chunk = st * kChunksPerStage + q / 2;
    const bool has = chunk < nchunk;
    const int tap = has ? chunk / nci : 0;
    const int ci = (has ? chunk % nci : 0) * kChunk + 16 * (q % 2);
    const int cvalid = has ? min(16, cw.cin - ci) : 0;  // this piece's channels inside cin
    const int dy = tap / cw.k, dx = tap % cw.k;
#pragma unroll
    for (int j = 0; j < kRowsA; ++j) {
      const int r = tid / 8 + 32 * j;
      const int iy = iy0[j] + dy, ix = ix0[j] + dx;
      const bool in = cvalid > 0 && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
      piece(a + r * kRowBytes + ((q ^ (r & 7)) << 4),
            in ? s.p + (static_cast<int64_t>(iy - s.row0) * s.W + ix) * s.C + cin_off + ci : s.p, in, cvalid);
    }
#pragma unroll
    for (int j = 0; j < kRowsB; ++j) {
      const int r = tid / 8 + 32 * j;
      const int co = c_base + r;
      const bool in = cvalid > 0 && co < cw.cout;
      piece(b + r * kRowBytes + ((q ^ (r & 7)) << 4),
            in ? cw.w + (static_cast<int64_t>(co) * cw.k * cw.k + tap) * cw.cin + ci : cw.w, in, cvalid);
    }
  }

  // The first kStages - 1 stages, one commit group each.
  __device__ void prologue(uint8_t* smem) const {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nstage) stage(smem, st, st);
      cp_async_commit();
    }
  }
};

// The K loop of one tile whose prologue is issued: acc = A * B^T, each
// warpgroup its 64 pixel rows. While the tensor cores work on stage st,
// the copies of stages st + 1 .. st + kStages - 1 are in flight. On return
// every wgmma of this thread's warpgroup is done.
template <int TN, bool V16>
__device__ void mma_mainloop(const TileLoad<TN, V16>& ld, uint8_t* smem, int (&acc)[TN / 2]) {
  constexpr int kStage = MmaCfg<TN>::kStageBytes;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  for (int st = 0; st < ld.nstage; ++st) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage st have landed
    fence_async_shared();
    __syncthreads();  // everyone's have, and stage st - 1's wgmma are done
    const int nxt = st + kStages - 1;
    if (nxt < ld.nstage) ld.stage(smem, nxt % kStages, nxt);  // the slot stage st - 1 used
    cp_async_commit();
    const uint8_t* a = smem + (st % kStages) * kStage;
    const uint32_t sa = smem_u32(a + wg * 64 * kRowBytes), sb = smem_u32(a + kTM * kRowBytes);
    const int nk = min(kChunksPerStage, ld.nchunk - st * kChunksPerStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunksPerStage; ++kk)
      if (kk < nk) wgmma_s8<TN>(acc, desc_sw128(sa + kChunk * kk), desc_sw128(sb + kChunk * kk));
    wgmma_commit();
    wgmma_wait_all();
  }
  fence_regs(acc);
}

// The epilogue of one tile: every sum's stage() value into `staging`
// (kTM pixels of TN values, rows 16 bytes apart beyond TN), then runs of
// 16 bytes of one pixel's channels finished and stored to dst, 16 bytes a
// thread. The caller makes the staging bytes free before the call.
template <int TN, class Epi>
__device__ void store_tile(const ConvW& cw, const Region& rg, int p_base, int c_base, const int (&acc)[TN / 2],
                           uint8_t* staging, const Epi& epi) {
  using Out = typename Epi::Out;
  constexpr int kVec = 16 / static_cast<int>(sizeof(Out));
  constexpr int kStride = TN * static_cast<int>(sizeof(Out)) + 16;  // bytes per staged pixel
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // wgmma's accumulator layout: rows lane / 4 (+ 8) of the warp's 16,
  // columns 2 (lane % 4) (+ 1) of every 8
  Out v[TN / 2];
#pragma unroll
  for (int n8 = 0; n8 < TN / 8; ++n8)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = c_base + 8 * n8 + 2 * (lane % 4) + j;
#pragma unroll
      for (int i = 0; i < 2; ++i) v[4 * n8 + 2 * i + j] = ch < cw.cout ? epi.stage(ch, acc[4 * n8 + 2 * i + j]) : Out(0);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    Out* srow = reinterpret_cast<Out*>(staging + (wg * 64 + warp * 16 + lane / 4 + 8 * i) * kStride);
#pragma unroll
    for (int n8 = 0; n8 < TN / 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) srow[8 * n8 + 2 * (lane % 4) + j] = v[4 * n8 + 2 * i + j];
  }
  __syncthreads();
  for (int idx = tid; idx < kTM * (TN / kVec); idx += kThreads) {
    const int r = idx / (TN / kVec), c0 = (idx % (TN / kVec)) * kVec;
    const int p = p_base + r, ch = c_base + c0;
    if (p >= rg.npx || ch >= cw.cout) continue;
    const int row = rg.row0 + p / rg.ncols, col = rg.col0 + p % rg.ncols;
    const int n = min(kVec, cw.cout - ch);
    alignas(16) Out run[kVec];
    *reinterpret_cast<int4*>(run) = *reinterpret_cast<const int4*>(staging + r * kStride + c0 * sizeof(Out));
    epi.finish(row, col, ch, run, n);
    Out* d = epi.dst.p + epi.dst.at(row, col, ch);
    if (n == kVec && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(run);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e < n) d[e] = run[e];
    }
  }
}

// One tile (tile_p, tile_c) of one conv (K5a's block, K7's ups). `smem` holds
// MmaCfg<TN>::kSmemBytes - 1024 bytes, 1024-aligned; the epilogue stages
// in the whole ring.
template <int TN, bool V16, class Epi>
__device__ void conv_tile_mma(const Src& s, const ConvW& cw, const Region& rg, int tile_p, int tile_c,
                              uint8_t* smem, const Epi& epi) {
  static_assert(kTM * (TN * sizeof(typename Epi::Out) + 16) <= kStages * MmaCfg<TN>::kStageBytes,
                "the staged tile fits the ring");
  const TileLoad<TN, V16> ld(s, cw, rg, tile_p, tile_c);
  ld.prologue(smem);
  int acc[TN / 2];
  mma_mainloop(ld, smem, acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  store_tile<TN>(cw, rg, ld.p_base, ld.c_base, acc, smem, epi);
}

// Every tile of one conv over output rows [lo, hi) x all cols (wo of them),
// dealt round-robin to `nworkers` blocks, this one being `worker` (the
// convs of K5 and K6).
template <int TN, bool V16, class Epi>
__device__ void conv_rows_mma(const Src& s, const ConvW& cw, int lo, int hi, int wo, int worker,
                              int nworkers, uint8_t* smem, const Epi& epi) {
  const Region rg{lo, 0, wo, (hi - lo) * wo};
  if (rg.npx <= 0) return;
  const int tiles_c = (cw.cout + TN - 1) / TN;
  const int ntiles = (rg.npx + kTM - 1) / kTM * tiles_c;
  for (int t = worker; t < ntiles; t += nworkers) {
    conv_tile_mma<TN, V16>(s, cw, rg, t / tiles_c, t % tiles_c, smem, epi);
    __syncthreads();  // the staged tile is the next tile's ring
  }
}

// Opt `kernel` into `bytes` of dynamic shared memory, once per kernel (a
// launch then needs no driver call but the launch itself).
template <auto kernel>
int allow_smem(int bytes) {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

// The channels per tile for `cout` output channels: 32, 64 or 128.
inline int mma_tile_n(int cout) { return cout <= 32 ? 32 : cout <= 64 ? 64 : 128; }

}  // namespace spe_i8
