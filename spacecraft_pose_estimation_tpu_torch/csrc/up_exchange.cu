// K7: one output of an HRNet fuse exchange in one launch.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_blocks.py,
// fused_up_exchange / _up_add_kernel:
//   out = rq(relu(yi * c[0] + sum_k d_k * c[1 + k]
//                 + sum_j up(rq(conv1x1(u_j, w_j) * m_j + b_j), f_j) * c[1 + nd + j]))
// summed in that order (the walk's operand order [ys[i], downs..., ups...]),
// where up(., f) is the nearest upsample by f: output pixel (y, x) reads
// low-res pixel (y / f, x / f), an index and never a tensor.
//
// Bound: bytes at the serving shapes. The 1x1 convs are small (C = 32-256
// output channels over 64-256 inputs, at a quarter or less of the output's
// pixels) and every operand is read once, the output written once.
//
// One 256-thread block per tile of ty x tx output pixels of one image. It
// first computes, for each coarser operand j, the 1x1 conv of the low-res
// pixels under its tile (each once, as the TPU kernel does) on the int8
// tensor cores: the tile body of int8_mma.cuh over a Region of those
// pixels, weights K-major (C, cu_j) read 16 bytes a copy, the requantized
// results stored by StoreRq into shared memory outside the ring. Then each
// thread sums runs of 16 consecutive channels of one output pixel: yi and
// every down as one 16-byte load each (ld.global.cg), each up value as 16
// bytes of shared memory, in the walk's order, and one 16-byte store
// (a scalar loop serves channel counts that are not a multiple of 16).
//
// The tile: tx = min(W, 128) columns (whole rows at W <= 128, so a row of
// low-res pixels is contiguous) and ty rows, a multiple of every f so that
// each low-res footprint is whole (ty / f x tx / f pixels). ty is the
// largest of them up to 32 that still gives kMinBlocksPerSm blocks per SM:
// the tile's conv is a few tensor-core tiles whose time is the latency of
// their copies and epilogue, and the sum is a stream of loads, so the
// kernel wants many blocks in flight more than large footprints. At the
// serving shapes (B = 16) the 128 x 128 x 32 outputs take 4-row tiles with
// ups from f = 2 and 4 (a 128-pixel footprint at f = 2) and 8-row tiles
// with an f = 8 up; the ring (62-99 KB) and the low-res buffers (at most
// 16 KB) leave 2-3 blocks per SM.
#include <numeric>

#include "int8_mma.cuh"

namespace {

using namespace spe_i8;

constexpr int kMaxOps = 3;          // at most 3 finer or coarser operands (4 branches)
constexpr int kMaxTileCols = 128;
constexpr int kMaxTileRows = 32;
constexpr int kMinBlocksPerSm = 2;
constexpr int kMaxSmem = 232448;    // 227 KB: the most a block may opt into

struct Up {
  const int8_t* u;   // (B, h, w, cu)
  const int8_t* wk;  // (C, cu): the 1x1 kernel, K-major
  const float* m;
  const float* b;
  int h, w, cu, f;
  int buf;           // byte offset of its low-res buffer past the ring
};

struct ExchangeArgs {
  const int8_t* yi;              // (B, H, W, C)
  const int8_t* downs[kMaxOps];  // (B, H, W, C)
  Up ups[kMaxOps];
  const float* coeffs;           // (1 + n_down + n_up,)
  int8_t* out;
  int n_down, n_up, H, W, C, ty, tx;
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float lane_f(const int4& t, int e) {
  const int w = e < 4 ? t.x : e < 8 ? t.y : e < 12 ? t.z : t.w;
  return static_cast<float>(static_cast<int8_t>(w >> (8 * (e & 3))));
}

template <int TN, bool V16>
__global__ void __launch_bounds__(kThreads) up_exchange_kernel(ExchangeArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint8_t* low = ring + MmaCfg<TN>::kSmemBytes - 1024;  // the low-res conv outputs under this tile
  const int img = blockIdx.z;
  const int y0 = blockIdx.y * a.ty, x0 = blockIdx.x * a.tx;
  const int rows = min(a.ty, a.H - y0), cols = min(a.tx, a.W - x0);
  const int C = a.C;

  int lo_y[kMaxOps], lo_x[kMaxOps], n_x[kMaxOps];
  const int8_t* buf[kMaxOps];
  for (int j = 0; j < a.n_up; ++j) {
    const Up& u = a.ups[j];
    lo_y[j] = y0 / u.f;
    lo_x[j] = x0 / u.f;
    n_x[j] = ceil_div(x0 + cols, u.f) - lo_x[j];
    int8_t* dst = reinterpret_cast<int8_t*>(low + u.buf);
    buf[j] = dst;
    const Src s{u.u + static_cast<int64_t>(img) * u.h * u.w * u.cu, 0, u.h, u.w, u.cu};
    const ConvW cw{u.wk, u.m, u.b, 1, 1, u.cu, C, 1};
    const StoreRq epi{cw, {dst, lo_y[j], lo_x[j], n_x[j], C}, false};
    const Region rg{lo_y[j], lo_x[j], n_x[j], (ceil_div(y0 + rows, u.f) - lo_y[j]) * n_x[j]};
    const int tiles_c = ceil_div(C, TN);
    const int ntiles = ceil_div(rg.npx, kTM) * tiles_c;
    for (int t = 0; t < ntiles; ++t) {
      conv_tile_mma<TN, V16>(s, cw, rg, t / tiles_c, t % tiles_c, ring, epi);
      __syncthreads();  // the ring is free again; after the last tile, every buffer is written
    }
  }

  float c[1 + 2 * kMaxOps];
  for (int i = 0; i < 1 + a.n_down + a.n_up; ++i) c[i] = a.coeffs[i];
  const int64_t img_px = static_cast<int64_t>(img) * a.H * a.W;
  if constexpr (V16) {
    const int runs = C / 16;
#pragma unroll 2
    for (int idx = threadIdx.x; idx < rows * cols * runs; idx += kThreads) {
      const int p = idx / runs, ch = (idx % runs) * 16;
      const int y = y0 + p / cols, x = x0 + p % cols;
      const int64_t at = (img_px + static_cast<int64_t>(y) * a.W + x) * C + ch;
      int4 v = __ldcg(reinterpret_cast<const int4*>(a.yi + at));
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = lane_f(v, e) * c[0];
      for (int k = 0; k < a.n_down; ++k) {
        v = __ldcg(reinterpret_cast<const int4*>(a.downs[k] + at));
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = acc[e] + lane_f(v, e) * c[1 + k];
      }
      for (int j = 0; j < a.n_up; ++j) {
        const int f = a.ups[j].f;
        v = *reinterpret_cast<const int4*>(buf[j] + ((y / f - lo_y[j]) * n_x[j] + (x / f - lo_x[j])) * C + ch);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = acc[e] + lane_f(v, e) * c[1 + a.n_down + j];
      }
      int w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        w[e >> 2] |= static_cast<int>(static_cast<uint8_t>(requant(fmaxf(acc[e], 0.f)))) << (8 * (e & 3));
      *reinterpret_cast<int4*>(a.out + at) = make_int4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols * C; e += kThreads) {
      const int ch = e % C, p = e / C;
      const int y = y0 + p / cols, x = x0 + p % cols;
      const int64_t at = (img_px + static_cast<int64_t>(y) * a.W + x) * C + ch;
      float acc = static_cast<float>(ld_i8(a.yi + at)) * c[0];
      for (int k = 0; k < a.n_down; ++k) acc = acc + static_cast<float>(ld_i8(a.downs[k] + at)) * c[1 + k];
      for (int j = 0; j < a.n_up; ++j) {
        const int f = a.ups[j].f;
        const int8_t v = buf[j][((y / f - lo_y[j]) * n_x[j] + (x / f - lo_x[j])) * C + ch];
        acc = acc + static_cast<float>(v) * c[1 + a.n_down + j];
      }
      a.out[at] = requant(fmaxf(acc, 0.f));
    }
  }
}

// Bytes of dynamic shared memory for tiles of ty rows: the ring (when
// there are ups) and one 16-byte-aligned low-res buffer per up.
int smem_bytes(ExchangeArgs& a, int ring, int ty) {
  int bytes = 0;
  for (int j = 0; j < a.n_up; ++j) {
    a.ups[j].buf = bytes;
    bytes += (ceil_div(ty, a.ups[j].f) * ceil_div(a.tx, a.ups[j].f) * a.C + 15) / 16 * 16;
  }
  return a.n_up ? ring + bytes : 0;
}

template <int TN, bool V16>
int launch(ExchangeArgs a, int B, int step, cudaStream_t s) {
  constexpr int ring = MmaCfg<TN>::kSmemBytes;
  int dev = 0, sms = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess) return static_cast<int>(err);
  if (const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev); err != cudaSuccess)
    return static_cast<int>(err);
  const int want = kMinBlocksPerSm * sms;
  int ty = step;
  while (2 * ty <= kMaxTileRows && ty < a.H &&
         ceil_div(a.H, 2 * ty) * ceil_div(a.W, a.tx) * B >= want && smem_bytes(a, ring, 2 * ty) <= kMaxSmem)
    ty *= 2;
  a.ty = ty;
  const int smem = smem_bytes(a, ring, ty);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = allow_smem<up_exchange_kernel<TN, V16>>(kMaxSmem)) return err;
  const dim3 grid(ceil_div(a.W, a.tx), ceil_div(a.H, ty), B);
  up_exchange_kernel<TN, V16><<<grid, kThreads, smem, s>>>(a);
  SPE_RETURN_LAUNCH_STATUS();
}

template <int TN>
int launch_tn(bool v16, const ExchangeArgs& a, int B, int step, cudaStream_t s) {
  return v16 ? launch<TN, true>(a, B, step, s) : launch<TN, false>(a, B, step, s);
}

}  // namespace

// yi, downs[k], out: (B, H, W, C) int8; ups[j]: u (B, h_j, w_j, cu_j) int8
// with H = h_j * f_j and W = w_j * f_j, w (C, cu_j) int8 (K-major), m, b
// (C,) f32; coeffs (1 + n_down + n_up,) f32. Unused pointers may be null.
extern "C" int up_exchange(const void* yi, const void* d0, const void* d1, const void* d2,
                           int n_down, const void* u0, const void* w0, const void* m0,
                           const void* b0, int h0, int wd0, int cu0, const void* u1,
                           const void* w1, const void* m1, const void* b1, int h1, int wd1,
                           int cu1, const void* u2, const void* w2, const void* m2,
                           const void* b2, int h2, int wd2, int cu2, int n_up,
                           const void* coeffs, void* out, int B, int H, int W, int C,
                           void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (n_down < 0 || n_down > kMaxOps || n_up < 0 || n_up > kMaxOps || C % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ExchangeArgs a{};
  a.yi = static_cast<const int8_t*>(yi);
  const void* downs[kMaxOps] = {d0, d1, d2};
  for (int k = 0; k < kMaxOps; ++k) a.downs[k] = static_cast<const int8_t*>(downs[k]);
  const void* us[kMaxOps] = {u0, u1, u2};
  const void* ws[kMaxOps] = {w0, w1, w2};
  const void* ms[kMaxOps] = {m0, m1, m2};
  const void* bs[kMaxOps] = {b0, b1, b2};
  const int hs[kMaxOps] = {h0, h1, h2}, wds[kMaxOps] = {wd0, wd1, wd2};
  const int cus[kMaxOps] = {cu0, cu1, cu2};
  a.tx = min(W, kMaxTileCols);
  int step = 1;  // tile rows are a multiple of every f
  bool v16 = C % 16 == 0 && aligned16(yi) && aligned16(out);
  for (int k = 0; k < n_down; ++k) v16 = v16 && aligned16(downs[k]);
  for (int j = 0; j < n_up; ++j) {
    if (hs[j] < 1 || wds[j] < 1 || H % hs[j] != 0 || W % wds[j] != 0 || H / hs[j] != W / wds[j] ||
        cus[j] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int f = H / hs[j];
    if (a.tx != W && a.tx % f != 0) return static_cast<int>(cudaErrorInvalidValue);
    step = std::lcm(step, f);
    a.ups[j] = Up{static_cast<const int8_t*>(us[j]), static_cast<const int8_t*>(ws[j]),
                  static_cast<const float*>(ms[j]), static_cast<const float*>(bs[j]),
                  hs[j], wds[j], cus[j], f, 0};
    v16 = v16 && cus[j] % 16 == 0 && aligned16(us[j]) && aligned16(ws[j]);
  }
  a.coeffs = static_cast<const float*>(coeffs);
  a.out = static_cast<int8_t*>(out);
  a.n_down = n_down;
  a.n_up = n_up;
  a.H = H;
  a.W = W;
  a.C = C;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mma_tile_n(C)) {
    case 32: return launch_tn<32>(v16, a, B, step, s);
    case 64: return launch_tn<64>(v16, a, B, step, s);
    default: return launch_tn<128>(v16, a, B, step, s);
  }
}
