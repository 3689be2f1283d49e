// K5: a chain of int8 BasicBlocks (one HRNet module branch) in one launch.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_blocks.py,
// fused_basic_block_chain / _block_chain_kernel. Per block, with the walk's
// rounding points (models/hrnet_int8.py _Int8Ops.convbn + add):
//   x1 = rq(relu(conv3x3(x, w[blk, 0]) * m + b))
//   x2 = rq(conv3x3(x1, w[blk, 1]) * m + b)          (requantized before the add)
//   x  = rq(relu(x2 * coeffs[blk, 0] + x * coeffs[blk, 1]))
//
// The TPU kernel keeps one image resident in VMEM. A branch-0 image is
// 128 x 128 x 32 int8 (512 KB) and will not fit one SM's 227 KB of shared
// memory, so the chain is tiled by rows instead: each strip of S output
// rows is computed from its input rows widened by a halo of one row per
// 3x3 conv (2 * nblocks), and every conv shrinks the band it produces by a
// row at each end (rows outside the image are the convs' zero padding).
// A strip is worked on by a cluster of kCluster blocks that deal each
// conv's output tiles among themselves and meet at a cluster barrier
// between convs; the band's intermediates live in a global workspace
// (two int8 bands per strip), which L2 holds at the serving shapes.
//
// Bound: operations (2 * 9 * C int8 ops per output value per conv: a
// 3x3 conv over 32-256 channels does 576-4608 ops per byte it must move).
// Every conv runs the tensor-core body of int8_mma.cuh: 128-pixel x TN
// tiles (TN = C up to 128), wgmma on the int8 tensor cores over a ring of
// cp.async.cg copies (L2, never L1: the other blocks of the cluster wrote
// the band), weights K-major (n, 2, C, 3, 3, C) from the model's packer.
// Left for later: the recomputed halo rows of each strip, and the bands
// in L2 rather than in the cluster's distributed shared memory.
#include "int8_mma.cuh"

namespace {

using namespace spe_i8;

constexpr int kCluster = 8;

struct ChainArgs {
  const int8_t* x;
  const int8_t* wk;  // (n, 2, C, 3, 3, C): K-major
  const float* m;    // (n, 2, C)
  const float* b;    // (n, 2, C)
  const float* coeffs;  // (n, 2)
  int8_t* out;
  int8_t* work;      // (B, strips, 2, band, W, C)
  int H, W, C, nblocks, strip, band;
};

template <int TN, bool V16>
__global__ void __launch_bounds__(kThreads)
basic_block_chain_kernel(ChainArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int rank = blockIdx.x % kCluster;
  const int strip = blockIdx.x / kCluster;
  const int strips = gridDim.x / kCluster;
  const int img = blockIdx.y;
  const int H = a.H, W = a.W, C = a.C;
  const int r0 = strip * a.strip, r1 = min(H, r0 + a.strip);
  const int L = 2 * a.nblocks;  // 3x3 convs still to run = rows of halo
  const int base = max(0, r0 - L);
  const int64_t img_elems = static_cast<int64_t>(H) * W * C;
  const int64_t band_elems = static_cast<int64_t>(a.band) * W * C;
  int8_t* P = a.work + (static_cast<int64_t>(img) * strips + strip) * 2 * band_elems;
  int8_t* Q = P + band_elems;
  int8_t* out_img = a.out + img * img_elems;

  Src cur{a.x + img * img_elems, 0, H, W, C};
  for (int blk = 0; blk < a.nblocks; ++blk) {
    const int8_t* w1 = a.wk + static_cast<int64_t>(blk * 2) * 9 * C * C;
    const ConvW c1{w1, a.m + (blk * 2) * C, a.b + (blk * 2) * C, 3, 1, C, C, 1};
    const ConvW c2{w1 + 9 * C * C, a.m + (blk * 2 + 1) * C, a.b + (blk * 2 + 1) * C, 3, 1, C, C, 1};
    // conv1 -> Q over the rows the remaining convs still need
    const int h1 = L - 2 * blk - 1;
    const StoreRq e1{c1, {Q, base, 0, W, C}, true};
    conv_rows_mma<TN, V16>(cur, c1, max(0, r0 - h1), min(H, r1 + h1), W, rank, kCluster, smem, e1);
    cluster_barrier();
    // conv2 + residual add -> P (in place) or, for the last block, out
    const int h2 = h1 - 1;
    const bool last = blk == a.nblocks - 1;
    const Dst<int8_t> d2{last ? out_img : P, last ? 0 : base, 0, W, C};
    const StoreResidualAdd e2{c2, cur, d2, a.coeffs[2 * blk], a.coeffs[2 * blk + 1]};
    conv_rows_mma<TN, V16>(Src{Q, base, H, W, C}, c2, max(0, r0 - h2), min(H, r1 + h2), W, rank,
                           kCluster, smem, e2);
    cluster_barrier();
    cur = Src{P, base, H, W, C};
  }
}

template <int TN, bool V16>
int launch_v(dim3 grid, cudaStream_t s, const ChainArgs& a) {
  constexpr int smem = MmaCfg<TN>::kSmemBytes;
  if (const int err = allow_smem<basic_block_chain_kernel<TN, V16>>(smem)) return err;
  return launch_clustered(basic_block_chain_kernel<TN, V16>, grid, kCluster, s, a, smem);
}

template <int TN>
int launch(bool v16, dim3 grid, cudaStream_t s, const ChainArgs& a) {
  return v16 ? launch_v<TN, true>(grid, s, a) : launch_v<TN, false>(grid, s, a);
}

}  // namespace

// x, out: (B, H, W, C) int8; wk (n, 2, C, 3, 3, C) int8, K-major; m, b
// (n, 2, C) f32; coeffs (n, 2) f32; work: B * ceil(H / strip) * 2 * band *
// W * C int8 with band = min(H, strip + 4 * nblocks).
extern "C" int basic_block_chain(const void* x, const void* wk, const void* m, const void* b,
                                 const void* coeffs, void* out, void* work, int B, int H, int W,
                                 int C, int nblocks, int strip, void* stream) {
  if (B == 0 || H == 0 || W == 0 || nblocks == 0) return 0;
  if (C % 4 != 0 || strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ChainArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk),
                    static_cast<const float*>(m), static_cast<const float*>(b),
                    static_cast<const float*>(coeffs), static_cast<int8_t*>(out),
                    static_cast<int8_t*>(work), H, W, C, nblocks, strip,
                    min(H, strip + 4 * nblocks)};
  const dim3 grid(kCluster * ((H + strip - 1) / strip), B);
  auto s = static_cast<cudaStream_t>(stream);
  const bool v16 = C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wk) % 16 == 0 && reinterpret_cast<uintptr_t>(work) % 16 == 0;
  switch (mma_tile_n(C)) {
    case 32: return launch<32>(v16, grid, s, a);
    case 64: return launch<64>(v16, grid, s, a);
    default: return launch<128>(v16, grid, s, a);
  }
}
