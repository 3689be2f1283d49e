// The int8 pieces shared by every int8 kernel of the port (K5a, K5, K6,
// K7): the operand descriptors (Src, Dst, ConvW), the requant epilogues, the
// cluster barrier and the clustered launch. The conv body they feed is the
// tensor-core tile of int8_mma.cuh.
//
// The sums are exact int32. The epilogues compute f = float(acc) * m + b as
// two roundings (the build passes --fmad=false), an optional relu, and
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

// One conv's weights, K-major (cout, k, k, cin) as int8_mma.cuh's
// conv_tile_mma reads them, and its per-output-channel requant vectors;
// cin is per group. pad_y and pad_x are the zero rows above and columns
// left of the input (k / 2 for a SAME conv; the bottom and right padding
// follow from the output size the caller gives).
struct ConvW {
  const int8_t* w;
  const float* m;
  const float* b;
  int k, stride, cin, cout, groups;
  int pad_y, pad_x;
};

__device__ __forceinline__ int8_t requant(float f, float lo = -127.f) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(f), lo), 127.f));
}

__device__ __forceinline__ float epilogue(const ConvW& cw, int ch, int acc, bool relu) {
  float f = static_cast<float>(acc) * cw.m[ch] + cw.b[ch];
  return relu ? fmaxf(f, 0.f) : f;
}

__device__ __forceinline__ int8_t ld_i8(const int8_t* p) {
  return static_cast<int8_t>(__ldcg(reinterpret_cast<const signed char*>(p)));
}

// Epilogues. conv_tile_mma computes each output element of an int32 sum
// `acc` in two steps: stage() of every sum of a tile (it depends on the
// channel alone) into shared memory, then finish() of each run v of
// N = 16 / sizeof(Out) consecutive channels of one pixel (its first n
// valid), in place, before storing the run to dst.

// Requantize (optional relu) into an int8 destination.
struct StoreRq {
  using Out = int8_t;
  ConvW cw;
  Dst<int8_t> dst;
  bool relu;
  __device__ __forceinline__ int8_t stage(int ch, int acc) const { return requant(epilogue(cw, ch, acc, relu)); }
  template <int N>
  __device__ __forceinline__ void finish(int, int, int, int8_t (&)[N], int) const {}
};

// StoreRq with a per-output-channel lower bound: clip(rint(f), lo[ch], 127),
// the merged fuse convs of mixed relu flags (K5a with lo).
struct StoreRqClip {
  using Out = int8_t;
  ConvW cw;
  Dst<int8_t> dst;
  bool relu;
  const float* lo;
  __device__ __forceinline__ int8_t stage(int ch, int acc) const {
    return requant(epilogue(cw, ch, acc, relu), lo[ch]);
  }
  template <int N>
  __device__ __forceinline__ void finish(int, int, int, int8_t (&)[N], int) const {}
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
};

// A pointer the 16-byte paths (cp.async, int4 loads and stores) can take.
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

}  // namespace spe_i8
