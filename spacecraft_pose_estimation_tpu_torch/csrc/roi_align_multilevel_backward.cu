// K2's backward: the gradient of the FPN ROIAlign with respect to the
// pyramid's features.
//
// No TPU kernel has a backward: the JAX trainer differentiates the windowed
// XLA pooler (spacecraft_pose_estimation_tpu/ops/roi_align.py:194,
// multilevel_roi_align(impl="windowed"), which models/roi_heads.py picks for
// config_1-config_3), and jax.grad through the Pallas pooler
// (ops/pallas_pooler.py:135) is not defined. This kernel is the gradient of
// K2's forward (roi_align_multilevel.cu), which computes that pooler's
// function. The pooler is linear and separable: a box's (P, P, C) bins are
// Ay . F . Ax^T over its level's cells, where Ay (P, h) and Ax (P, w) fold
// each bin's S samples, their two bilinear taps and 1 / S^2. So one box's
// gradient is Ay^T . G . Ax, G its (P, P, C) grad_out, and it lies in the
// small rectangle of cells its nonzero taps span (at most the read window).
// The mask and keypoint heads and the cascade train through the XLA gather
// pooler (ops/roi_align.py:194, impl="gather"), which has no window: there a
// box's rectangle is its whole tap span, clamped to its level, and each
// ROI's table is sized for the largest level side instead of the window.
//
// The same geometry, bit for bit: the level, the read window and the taps
// come from roi_align_common.cuh, the functions K2's forward calls, so a
// box on a level boundary sends its gradient to the level it pooled from,
// and a tap the window drops (weight 0) gets none.
//
// Bound: memory. The call must read grad_out and write the gradient of
// every level once in the features' dtype; at config_1 (batch 4, 800^2,
// C 256, bf16, 512 ROIs) that is 25.7 MB read and 108.8 MB written, the
// whole of every level, most of it zeros. The contraction is ~2.7 GFLOP,
// a few hundredths of a ms on the FP32 CUDA cores, so it runs there and
// not on the tensor cores: TF32 would miss the float32 bar of 1e-5 of the
// gradient's scale.
//
// Its design, owner computes. A first pass, a warp a ROI, writes each
// ROI's footprint (its level and image, and the span of rows and columns
// where some tap weight is nonzero), the row and column span of each of its
// bins, and its Ay and Ax over the footprint. Then each block owns a tile
// of 4 x 8 cells of one level of one image and 256 channels, each warp one
// column of it (8 channels a lane); the blocks are persistent and take the
// tiles in turn. The block lists the ROIs whose footprint meets its tile,
// in index order; each warp adds the share of each listed ROI that meets
// its column into float32 accumulators in registers: t[py] = sum_px
// G[py][px] Ax[px][x] over the bins whose span holds x, then acc[y] +=
// Ay[py][y] t[py] over the bins whose span meets its rows. The warps of a
// block read the same grad_out bins, which the L1 serves after the first.
// A block writes its tile once, 16 bytes a lane a cell (512 bytes a warp),
// in the features' dtype (bf16 rounded to nearest even); cells no ROI
// touches get zeros. Nothing is zeroed beforehand, there is no float32
// buffer of the gradient, no cast pass and no atomic, and every call sums
// in the same order: two calls on the same inputs agree bit for bit.
//
// What the shape costs (chip_ablate.py K2b, config_1's problem): the walk,
// the table pass and the stores alone are ~40% of the time, the sums the
// rest, whose tail is the few tiles under one image's object, where ~35
// ROIs overlap; 8-row columns (more registers, longer chains a ROI), 2-row
// ones (more walks), 4 or 16 columns a block and a block a tile are all
// slower; so was staging each ROI's grad_out in shared memory, which
// copies all its bins to every tile it meets, where the L1 here serves
// only the bins a column reads.
#include "roi_align_common.cuh"

namespace {

constexpr int kRows = 4;      // rows of a warp's column: the tile's rows
constexpr int kCols = 8;      // warps of a block, one a column: the tile's columns
constexpr int kLaneCh = 8;    // channels of a lane
constexpr int kWarpCh = 32 * kLaneCh;  // channels of a warp: a chunk
constexpr int kThreads = 32 * kCols;
constexpr int kMaxSide = 32767;  // spans pack their two ends in 16 bits each
constexpr int kEmpty = kMaxSide;  // the span of a bin with no nonzero tap: no cell lies in it

// 8 channels into 16 bytes of bf16 (round to nearest even) or 32 of f32.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[4] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3]),
                         __floats2bfloat162_rn(v[4], v[5]), __floats2bfloat162_rn(v[6], v[7])};
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct Outs {
  void* o[4];
};

struct Params {
  Pyramid pyr;
  int num_levels, lvl_min, B, R, C, P, S, window, read, canonical_level;
  float canonical_size;
};

// A ROI's table, after the footprints: its bins' (row span, column span)
// pairs (2 P words, padded to a multiple of 4), then Ay (P rows of sy
// floats, index y - oy) and Ax / S^2 (P rows of sx floats, index x - ox),
// where oy and ox are the footprint's first row and column rounded down to
// a multiple of 8: a warp's kRows rows of a bin are aligned float4s. sy and
// sx hold a footprint of at most span rows and span + 8 columns (span: the
// read window; for the gather, which has none, the largest level side) at
// any such offset and, for sy, up to 8 rows read past it.
struct Table {
  int P, sp, sy, sx;
  __host__ __device__ Table(int P_, int span)
      : P(P_), sp((2 * P_ + 3) / 4 * 4), sy((span + 15 + 7) / 8 * 8), sx((span + 15 + 3) / 4 * 4) {}
  __host__ __device__ int words() const { return sp + P * (sy + sx); }
  __device__ __forceinline__ int ay(int b) const { return sp + b * sy; }
  __device__ __forceinline__ int ax(int b) const { return sp + P * sy + b * sx; }
};

__device__ __forceinline__ int pack_span(int lo, int hi) { return lo <= hi ? lo | (hi << 16) : kEmpty; }

// A warp a ROI. footprints (R, 4): {image * 4 + level, or -1 when no tap
// weight is nonzero; first | last row << 16; first | last column << 16; 0}.
// Lane b owns bin b's spans and its rows of Ay and Ax, into which it adds
// its samples' tap weights in order (sample, then tap); masked taps carry
// weight 0 and add nothing.
__global__ void __launch_bounds__(128)
roi_table_kernel(Params p, const float* __restrict__ boxes, const int* __restrict__ batch_idx,
                 int4* __restrict__ fp, int* __restrict__ tables, Table tb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 4 + warp;
  if (r >= p.R) return;
  const int P = p.P, S = p.S;
  const BoxWindow bw = box_window(p.pyr, boxes + 4 * r, false, p.num_levels, p.lvl_min, 0.f, p.window,
                                  p.read, p.canonical_size, p.canonical_level);
  int* tab = tables + static_cast<int64_t>(r) * tb.words();
  int y0 = kMaxSide, y1 = -1, x0 = kMaxSide, x1 = -1;
  for (int b = lane; b < P; b += 32) {
    int ylo = kMaxSide, yhi = -1, xlo = kMaxSide, xhi = -1;
    for (int i = b * S; i < b * S + S; ++i) {
      int k[2];
      float wt[2];
      row_taps(bw, i, P, S, k, wt);
      for (int t = 0; t < 2; ++t)
        if (wt[t] != 0.f) ylo = min(ylo, k[t]), yhi = max(yhi, k[t]);
      col_taps(bw, i, P, S, k, wt);
      for (int t = 0; t < 2; ++t)
        if (wt[t] != 0.f) xlo = min(xlo, k[t]), xhi = max(xhi, k[t]);
    }
    tab[2 * b] = pack_span(ylo, yhi);
    tab[2 * b + 1] = pack_span(xlo, xhi);
    y0 = min(y0, ylo), y1 = max(y1, yhi), x0 = min(x0, xlo), x1 = max(x1, xhi);
  }
  for (int o = 16; o > 0; o >>= 1) {
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
  }
  const bool any = y1 >= 0 && x1 >= 0;
  if (lane == 0) fp[r] = make_int4(any ? batch_idx[r] * 4 + bw.lvl : -1, y0 | (y1 << 16), x0 | (x1 << 16), 0);
  if (!any) return;  // warp-uniform: no warp reads this table
  float* ft = reinterpret_cast<float*>(tab);
  for (int i = tb.sp / 4 + lane; i < tb.words() / 4; i += 32) reinterpret_cast<float4*>(ft)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  const int oy = y0 & ~7, ox = x0 & ~7;
  const float inv = 1.f / static_cast<float>(S * S);
  for (int b = lane; b < P; b += 32)
    for (int i = b * S; i < b * S + S; ++i) {
      int k[2];
      float wt[2];
      row_taps(bw, i, P, S, k, wt);
      for (int t = 0; t < 2; ++t)
        if (wt[t] != 0.f) ft[tb.ay(b) + k[t] - oy] += wt[t];
      col_taps(bw, i, P, S, k, wt);
      for (int t = 0; t < 2; ++t)
        if (wt[t] != 0.f) ft[tb.ax(b) + k[t] - ox] += wt[t] * inv;
    }
}

// Persistent blocks over the tiles (levels P2 first, then images, tile
// rows, tile columns, channel chunks). Warp x of a block: column x0 + x of
// the tile, its kRows rows; lane: channels [8 lane, 8 lane + 8) of the
// chunk. The block walks the ROIs kThreads at a time, a thread a
// footprint, and lists those that meet its tile in index order; then each
// warp takes the list 32 at a time: each lane, if its ROI meets the warp's
// column, reads that ROI's bin spans, so the spans of 32 ROIs arrive in
// one round trip; and the warp sums those ROIs in index order, each bin
// row's loads (Ay, and Ax and grad_out of two bins at a time) issued before
// their products.
template <typename T>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
roi_align_ml_backward_kernel(Params p, Outs outs, const int4* __restrict__ fp, const int* __restrict__ tables,
                             Table tb, const float* __restrict__ grad_out, int tiles) {
  __shared__ int4 hits[kThreads];  // {ROI, its footprint's rows, its columns, 0}
  __shared__ int warp_hits[kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = p.P, C = p.C, chunks = (C + kWarpCh - 1) / kWarpCh;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int tile = t / chunks, lvl = 0;
    for (; lvl < p.num_levels - 1; ++lvl) {
      const int n = p.B * ((p.pyr.h[lvl] + kRows - 1) / kRows) * ((p.pyr.w[lvl] + kCols - 1) / kCols);
      if (tile < n) break;
      tile -= n;
    }
    const int h = p.pyr.h[lvl], w = p.pyr.w[lvl];
    const int tiles_x = (w + kCols - 1) / kCols, tiles_yx = tiles_x * ((h + kRows - 1) / kRows);
    const int img = tile / tiles_yx, key = img * 4 + lvl;
    const int y0 = (tile % tiles_yx) / tiles_x * kRows, x0 = (tile % tiles_x) * kCols, x = x0 + warp;
    const int c = (t % chunks) * kWarpCh + kLaneCh * lane;
    const bool mine = x < w;  // warp-uniform: a column past the level's edge has no cells
    const bool active = mine && c < C;
    float acc[kRows][kLaneCh] = {};
    for (int base = 0; base < p.R; base += kThreads) {
      int4 f = make_int4(-1, 0, 0, 0);
      if (base + threadIdx.x < p.R) f = __ldg(fp + base + threadIdx.x);
      const bool meets = f.x == key && (f.y & 0xffff) < y0 + kRows && (f.y >> 16) >= y0 &&
                         (f.z & 0xffff) < x0 + kCols && (f.z >> 16) >= x0;
      const unsigned ballot = __ballot_sync(0xffffffffu, meets);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      int off = 0, nh = 0;
      for (int i = 0; i < kCols; ++i) off += i < warp ? warp_hits[i] : 0, nh += warp_hits[i];
      if (meets) hits[off + __popc(ballot & ((1u << lane) - 1u))] = make_int4(base + threadIdx.x, f.y, f.z, 0);
      __syncthreads();
      for (int hb = 0; hb < nh; hb += 32) {
        const int4 hl = hb + lane < nh ? hits[hb + lane] : make_int4(-1, 0, 0, 0);
        const bool hit = hb + lane < nh && mine && (hl.z & 0xffff) <= x && (hl.z >> 16) >= x;
        // this lane's ROI: the bins that reach the warp's rows, [pa, pb], and those whose columns hold x
        int pa = P, pb = -1;
        unsigned long long cols = 0;
        if (hit) {
          const int2* spans = reinterpret_cast<const int2*>(tables + static_cast<int64_t>(hl.x) * tb.words());
#pragma unroll 4
          for (int b = 0; b < P; ++b) {
            const int2 sp = __ldg(spans + b);
            if ((sp.x >> 16) >= y0 && (sp.x & 0xffff) < y0 + kRows) pa = min(pa, b), pb = b;
            if (x >= (sp.y & 0xffff) && x <= (sp.y >> 16)) cols |= 1ull << b;
          }
        }
        for (unsigned mask = __ballot_sync(0xffffffffu, hit); mask; mask &= mask - 1) {
          const int src = __ffs(mask) - 1, r = __shfl_sync(0xffffffffu, hl.x, src);
          const int qa = __shfl_sync(0xffffffffu, pa, src), qb = __shfl_sync(0xffffffffu, pb, src);
          unsigned long long m_all = __shfl_sync(0xffffffffu, static_cast<unsigned>(cols >> 32), src);
          m_all = m_all << 32 | __shfl_sync(0xffffffffu, static_cast<unsigned>(cols), src);
          if (!active) m_all = 0;
          const int oy = __shfl_sync(0xffffffffu, hl.y, src) & 0xffff & ~7;
          const int ox = __shfl_sync(0xffffffffu, hl.z, src) & 0xffff & ~7;
          const float* tab = reinterpret_cast<const float*>(tables + static_cast<int64_t>(r) * tb.words());
          const float* ay = tab + tb.ay(0) + (y0 - oy);
          const float* ax = tab + tb.ax(0) + (x - ox);
          const float* g = grad_out + static_cast<int64_t>(r) * P * P * C + c;
          for (int py = qa; py <= qb && m_all; ++py) {
            float ar[kRows];  // Ay[py] at the warp's rows
            if constexpr (kRows % 4 == 0) {
#pragma unroll
              for (int q = 0; q < kRows / 4; ++q) {
                const float4 a4 = __ldg(reinterpret_cast<const float4*>(ay + py * tb.sy) + q);
                ar[4 * q] = a4.x, ar[4 * q + 1] = a4.y, ar[4 * q + 2] = a4.z, ar[4 * q + 3] = a4.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < kRows; ++j) ar[j] = __ldg(ay + py * tb.sy + j);
            }
            // t = sum over the bins px whose columns hold x of G[py][px] Ax[px][x], two bins a step (a
            // missing second bin repeats the first with weight 0)
            float tv[kLaneCh] = {};
            for (unsigned long long m = m_all; m;) {
              const int p0 = __ffsll(static_cast<long long>(m)) - 1;
              m &= m - 1;
              const int p1 = m ? __ffsll(static_cast<long long>(m)) - 1 : p0;
              const float a0 = __ldg(ax + p0 * tb.sx), a1 = m ? __ldg(ax + p1 * tb.sx) : 0.f;
              m &= m - 1;
              const float4* g0 = reinterpret_cast<const float4*>(g + static_cast<int64_t>(py * P + p0) * C);
              const float4* g1 = reinterpret_cast<const float4*>(g + static_cast<int64_t>(py * P + p1) * C);
              const float4 u0 = __ldg(g0), v0 = __ldg(g0 + 1), u1 = __ldg(g1), v1 = __ldg(g1 + 1);
              tv[0] = fmaf(a1, u1.x, fmaf(a0, u0.x, tv[0])); tv[1] = fmaf(a1, u1.y, fmaf(a0, u0.y, tv[1]));
              tv[2] = fmaf(a1, u1.z, fmaf(a0, u0.z, tv[2])); tv[3] = fmaf(a1, u1.w, fmaf(a0, u0.w, tv[3]));
              tv[4] = fmaf(a1, v1.x, fmaf(a0, v0.x, tv[4])); tv[5] = fmaf(a1, v1.y, fmaf(a0, v0.y, tv[5]));
              tv[6] = fmaf(a1, v1.z, fmaf(a0, v0.z, tv[6])); tv[7] = fmaf(a1, v1.w, fmaf(a0, v0.w, tv[7]));
            }
#pragma unroll
            for (int j = 0; j < kRows; ++j)
#pragma unroll
              for (int q = 0; q < kLaneCh; ++q) acc[j][q] = fmaf(ar[j], tv[q], acc[j][q]);
          }
        }
      }
      __syncthreads();  // the list is refilled by the next chunk or tile
    }
    if (!active) continue;
    T* out = static_cast<T*>(outs.o[lvl]) + (static_cast<int64_t>(img) * h * w + x) * C + c;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (y0 + j < h) store8(out + static_cast<int64_t>(y0 + j) * w * C, acc[j]);
  }
}

template <typename T>
int blocks_per_sm() {
  static int n = 0;
  if (n == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, roi_align_ml_backward_kernel<T>, kThreads, 0) !=
                     cudaSuccess || n < 1))
    n = 1;
  return n;
}

}  // namespace

// grad_out: (R, P, P, C) f32, 16-byte aligned. o0..o3: the per-level
// gradients (B, h_l, w_l, C), bf16 when is_bf16 else f32, 16-byte aligned,
// every element of which the call writes. scratch: 16-byte aligned int32
// words, 4 R of footprints then R tables of Table(P, span).words(), span
// the window or, for the gather read, the largest level side.
// Levels past num_levels are unused. boxes (R, 4) f32 XYXY image pixels,
// batch_idx (R,) int32; lvl_min = log2 of the finest level's stride;
// read as the forward's. C a multiple of 8.
extern "C" int roi_align_multilevel_backward(
    const void* grad_out, void* o0, void* o1, void* o2, void* o3, void* scratch, int h0, int w0,
    int h1, int w1, int h2, int w2, int h3, int w3, int B, int num_levels, int lvl_min, int is_bf16,
    const void* boxes, const void* batch_idx, int R, int C, int P, int S, int window, int read,
    float canonical_size, int canonical_level, void* stream) {
  if (P * S > kMaxSamples || num_levels < 1 || num_levels > 4 || C % 8 != 0 || read < kWindowed ||
      read > kGather)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{{{nullptr, nullptr, nullptr, nullptr}, {h0, h1, h2, h3}, {w0, w1, w2, w3}},
                 num_levels, lvl_min, B, R, C, P, S, window, read, canonical_level, canonical_size};
  int span = window;
  if (read == kGather) {
    span = 0;
    for (int l = 0; l < num_levels; ++l) span = max(span, max(p.pyr.h[l], p.pyr.w[l]));
  }
  const Table tb(P, span);
  int64_t tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (p.pyr.h[l] > kMaxSide || p.pyr.w[l] > kMaxSide) return static_cast<int>(cudaErrorInvalidValue);
    tiles += static_cast<int64_t>(B) * ((p.pyr.h[l] + kRows - 1) / kRows) * ((p.pyr.w[l] + kCols - 1) / kCols);
  }
  tiles *= (C + kWarpCh - 1) / kWarpCh;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* fp = static_cast<int4*>(scratch);
  int* tables = static_cast<int*>(scratch) + 4LL * R;
  if (R > 0) {
    roi_table_kernel<<<(R + 3) / 4, 128, 0, s>>>(p, static_cast<const float*>(boxes),
                                                 static_cast<const int*>(batch_idx), fp, tables, tb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (tiles == 0) SPE_RETURN_LAUNCH_STATUS();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Outs outs{{o0, o1, o2, o3}};
  const auto* go = static_cast<const float*>(grad_out);
  const int n = static_cast<int>(tiles);
  if (is_bf16)
    roi_align_ml_backward_kernel<__nv_bfloat16><<<min(n, sms * blocks_per_sm<__nv_bfloat16>()), kThreads, 0, s>>>(
        p, outs, fp, tables, tb, go, n);
  else
    roi_align_ml_backward_kernel<float><<<min(n, sms * blocks_per_sm<float>()), kThreads, 0, s>>>(
        p, outs, fp, tables, tb, go, n);
  SPE_RETURN_LAUNCH_STATUS();
}
