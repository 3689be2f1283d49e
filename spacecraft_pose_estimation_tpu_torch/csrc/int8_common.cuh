// The int8 pieces shared by every int8 kernel, and the __dp4a conv body of
// K6 (bottleneck_chain.cu) and K7 (up_exchange.cu). K5a and K5 run the
// tensor-core body of int8_mma.cuh on the same operands and epilogues.
//
// One call of conv_tile computes a tile of TM output pixels x TN output
// channels of an int8 x int8 -> int32 convolution (NHWC activations, HWIO
// weights, k x k taps, stride s, zero padding k / 2) with 256 threads, then
// hands every (row, col, channel, int32 sum) to an epilogue functor. The
// inner product is __dp4a over groups of 4 input channels, so every input
// channel count must be a multiple of 4 (the wrappers check it). Per K step
// the block stages 32 input channels of one tap for its TM pixels and TN
// channels in shared memory; each thread keeps 4 x 4 int32 sums.
//
// The sums are exact. The epilogues compute f = float(acc) * m + b as two
// roundings (the build passes --fmad=false), an optional relu, and
// requantize with rintf (half to even, as jnp.round and torch.round), so
// each site equals the plain PyTorch version bit for bit.
//
// Activations are read with ld.global.cg (L2, not L1): inside the chain
// kernels the blocks of one cluster write workspace rows that the others
// read after a cluster barrier, and L1 is not coherent between SMs.
#pragma once

#include "common.cuh"

namespace spe_i8 {

constexpr int kThreads = 256;
constexpr int kKWords = 8;  // K step: 8 int32 words = 32 input channels

// An int8 NHWC activation of one image, or a band of its rows.
// Element (row, col, ch) of the image lives at
// p[((row - row0) * W + col) * C + ch] for row0 <= row < row0 + stored rows;
// rows and cols outside [0, H) x [0, W) read as 0 (the conv's padding).
struct Src {
  const int8_t* p;
  int row0;
  int H, W, C;
};

// Where an epilogue writes: element (row, col, ch) at
// p[((row - row0) * W + (col - col0)) * C + ch].
template <typename T>
struct Dst {
  T* p;
  int row0, col0;
  int W, C;
  __device__ __forceinline__ int64_t at(int row, int col, int ch) const {
    return (static_cast<int64_t>(row - row0) * W + (col - col0)) * C + ch;
  }
};

// One conv's weights and its per-output-channel requant vectors. The
// weights are HWIO (k, k, cin, cout) for conv_tile and K-major
// (cout, k, k, cin) for int8_mma.cuh's conv_tile_mma; cin is per group.
struct ConvW {
  const int8_t* w;
  const float* m;
  const float* b;
  int k, stride, cin, cout, groups;
};

__device__ __forceinline__ int8_t requant(float f) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(f), -127.f), 127.f));
}

__device__ __forceinline__ float epilogue(const ConvW& cw, int ch, int acc, bool relu) {
  float f = static_cast<float>(acc) * cw.m[ch] + cw.b[ch];
  return relu ? fmaxf(f, 0.f) : f;
}

__device__ __forceinline__ int8_t ld_i8(const int8_t* p) {
  return static_cast<int8_t>(__ldcg(reinterpret_cast<const signed char*>(p)));
}

template <int TN>
struct Tile {
  static constexpr int TM = 4096 / TN;  // 64 pixels at TN 64, 128 at TN 32
  static_assert(TN == 32 || TN == 64, "TN is 32 or 64");
};

template <int TN>
struct __align__(16) Smem {
  int a[kKWords][Tile<TN>::TM + 4];  // +4: the staging stores hit distinct banks
  int b[kKWords][TN];
};

// Epilogues. operator() computes the output element of the int32 sum
// `acc` at (row, col, ch) and stores it to dst (conv_tile).
// conv_tile_mma computes the same in two steps: stage() of every sum of a
// tile (it depends on the channel alone) into shared memory, then finish()
// of each run v of N = 16 / sizeof(Out) consecutive channels of one pixel
// (its first n valid), in place, before storing the run to dst.

// Requantize (optional relu) into an int8 destination.
struct StoreRq {
  using Out = int8_t;
  ConvW cw;
  Dst<int8_t> dst;
  bool relu;
  __device__ __forceinline__ int8_t stage(int ch, int acc) const { return requant(epilogue(cw, ch, acc, relu)); }
  template <int N>
  __device__ __forceinline__ void finish(int, int, int, int8_t (&)[N], int) const {}
  __device__ __forceinline__ void operator()(int row, int col, int ch, int acc) const {
    dst.p[dst.at(row, col, ch)] = stage(ch, acc);
  }
};

// f32 output (optional relu), no rounding (K5a's head).
struct StoreF32 {
  using Out = float;
  ConvW cw;
  Dst<float> dst;
  bool relu;
  __device__ __forceinline__ float stage(int ch, int acc) const { return epilogue(cw, ch, acc, relu); }
  template <int N>
  __device__ __forceinline__ void finish(int, int, int, float (&)[N], int) const {}
};

// A residual block's last conv: requantize the conv (no relu), then
// out = requant(relu(x * c0 + residual * c1)), the walk's add site. The
// residual may be the destination itself: each element is read before it
// is written, by the thread that writes it.
struct StoreResidualAdd {
  using Out = int8_t;
  ConvW cw;
  Src res;
  Dst<int8_t> dst;
  float c0, c1;
  __device__ __forceinline__ const int8_t* residual(int row, int col, int ch) const {
    return res.p + (static_cast<int64_t>(row - res.row0) * res.W + col) * res.C + ch;
  }
  __device__ __forceinline__ int8_t add(int8_t x, int8_t r) const {
    return requant(fmaxf(static_cast<float>(x) * c0 + static_cast<float>(r) * c1, 0.f));
  }
  __device__ __forceinline__ int8_t stage(int ch, int acc) const {
    return requant(epilogue(cw, ch, acc, false));
  }
  template <int N>
  __device__ __forceinline__ void finish(int row, int col, int ch, int8_t (&v)[N], int n) const {
    static_assert(N == 16, "runs of 16 int8 channels");
    const int8_t* r = residual(row, col, ch);
    if (n == N && (reinterpret_cast<uintptr_t>(r) & 15) == 0) {
      const int4 t = __ldcg(reinterpret_cast<const int4*>(r));
      const int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = add(v[e], static_cast<int8_t>(w[e >> 2] >> (8 * (e & 3))));
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (e < n) v[e] = add(v[e], ld_i8(r + e));
    }
  }
  __device__ __forceinline__ void operator()(int row, int col, int ch, int acc) const {
    dst.p[dst.at(row, col, ch)] = add(stage(ch, acc), ld_i8(residual(row, col, ch)));
  }
};

// Output pixels p in [0, npx) of a region map to (row0 + p / ncols, col0 + p % ncols).
// Tile (tile_p, tile_c) covers pixels [tile_p * TM, +TM) and channels
// [tile_c * TN, +TN). With groups > 1 a tile's channels must lie in one group.
template <int TN, class Epi>
__device__ void conv_tile(const Src& s, const ConvW& cw, int row0, int col0, int ncols, int npx,
                          int tile_p, int tile_c, Smem<TN>& sm, const Epi& epi) {
  constexpr int TM = Tile<TN>::TM;
  constexpr int kLoadsA = TM * kKWords / kThreads;  // 2 or 4
  constexpr int kLoadsB = TN * kKWords / kThreads;  // 2 or 1
  const int tid = threadIdx.x;
  const int pad = cw.k / 2;
  const int p_base = tile_p * TM, c_base = tile_c * TN;
  const int cin_off = cw.groups > 1 ? (c_base / (cw.cout / cw.groups)) * cw.cin : 0;

  // the pixels this thread stages: fixed over the K loop
  int iy0[kLoadsA], ix0[kLoadsA];
  bool pv[kLoadsA];
  for (int r = 0; r < kLoadsA; ++r) {
    const int p = p_base + (tid + r * kThreads) / kKWords;
    pv[r] = p < npx;
    const int oy = row0 + (pv[r] ? p / ncols : 0);
    const int ox = col0 + (pv[r] ? p % ncols : 0);
    iy0[r] = oy * cw.stride - pad;
    ix0[r] = ox * cw.stride - pad;
  }
  const int wa = tid % kKWords;  // the word this thread stages for its pixels

  const int tx = tid % (TN / 4), ty = tid / (TN / 4);
  int acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < cw.k * cw.k; ++tap) {
    const int dy = tap / cw.k, dx = tap % cw.k;
    const int8_t* wtap = cw.w + static_cast<int64_t>(tap) * cw.cin * cw.cout;
    for (int ci0 = 0; ci0 < cw.cin; ci0 += 4 * kKWords) {
      // stage A: activations, 4 channels per word
      const int ca = ci0 + 4 * wa;
      for (int r = 0; r < kLoadsA; ++r) {
        const int iy = iy0[r] + dy, ix = ix0[r] + dx;
        int v = 0;
        if (pv[r] && ca < cw.cin && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          v = __ldcg(reinterpret_cast<const int*>(
              s.p + (static_cast<int64_t>(iy - s.row0) * s.W + ix) * s.C + cin_off + ca));
        sm.a[wa][(tid + r * kThreads) / kKWords] = v;
      }
      // stage B: weights, the 4 input channels of a word packed for dp4a
      for (int r = 0; r < kLoadsB; ++r) {
        const int i = tid + r * kThreads;
        const int co = i % TN, wd = i / TN;
        const int cb = ci0 + 4 * wd, cg = c_base + co;
        uint32_t v = 0;
        if (cb < cw.cin && cg < cw.cout) {
          const int8_t* wp = wtap + static_cast<int64_t>(cb) * cw.cout + cg;
          for (int j = 0; j < 4; ++j)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(wp[static_cast<int64_t>(j) * cw.cout])) << (8 * j);
        }
        sm.b[wd][co] = static_cast<int>(v);
      }
      __syncthreads();
      for (int wd = 0; wd < kKWords; ++wd) {
        const int4 av = *reinterpret_cast<const int4*>(&sm.a[wd][ty * 4]);
        const int4 bv = *reinterpret_cast<const int4*>(&sm.b[wd][tx * 4]);
        const int a4[4] = {av.x, av.y, av.z, av.w};
        const int b4[4] = {bv.x, bv.y, bv.z, bv.w};
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a4[i], b4[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  for (int i = 0; i < 4; ++i) {
    const int p = p_base + ty * 4 + i;
    if (p >= npx) continue;
    const int oy = row0 + p / ncols, ox = col0 + p % ncols;
    for (int j = 0; j < 4; ++j) {
      const int co = c_base + tx * 4 + j;
      if (co < cw.cout) epi(oy, ox, co, acc[i][j]);
    }
  }
}

// Barrier of all blocks of this block's cluster, after which every global
// write of the cluster before it is visible to every block of the cluster.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Launch `kernel(args)` with 256-thread blocks in clusters of `cluster`
// consecutive blocks along x (grid.x must be a multiple of it), each with
// `smem_bytes` of dynamic shared memory (above 48 KB the caller has
// raised the kernel's cudaFuncAttributeMaxDynamicSharedMemorySize).
template <class Kernel, class Args>
int launch_clustered(Kernel kernel, dim3 grid, int cluster, cudaStream_t stream, const Args& args,
                     int smem_bytes = 0) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Every tile of one conv over output rows [lo, hi) x all cols (wo of them),
// dealt round-robin to `nworkers` blocks, this one being `worker`.
template <int TN, class Epi>
__device__ void conv_rows(const Src& s, const ConvW& cw, int lo, int hi, int wo, int worker,
                          int nworkers, Smem<TN>& sm, const Epi& epi) {
  constexpr int TM = Tile<TN>::TM;
  const int npx = (hi - lo) * wo;
  if (npx <= 0) return;
  const int tiles_p = (npx + TM - 1) / TM, tiles_c = (cw.cout + TN - 1) / TN;
  for (int t = worker; t < tiles_p * tiles_c; t += nworkers)
    conv_tile<TN>(s, cw, lo, 0, wo, npx, t / tiles_c, t % tiles_c, sm, epi);
}

}  // namespace spe_i8
