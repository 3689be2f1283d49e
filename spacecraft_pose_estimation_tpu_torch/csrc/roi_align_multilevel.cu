// K2: FPN ROIAlign over up to four pyramid levels in one pass, and K3:
// ROIAlign over one map.
//
// K2 replaces spacecraft_pose_estimation_tpu/ops/pallas_pooler.py,
// multilevel_roi_align_pallas / _ml_pooler_kernel. Semantics are those of
// its level_mats / window_matrices: each box picks its level
// floor(canonical_level + log2(sqrt(area) / canonical_size + 1e-8)) clipped
// to the pyramid; sample points use the aligned -0.5 offset and a regular
// S x S sub-grid per bin; a sample outside (-1, size) is 0, otherwise it is
// clamped into [0, size-1]; only taps inside the box's (window, window+8)
// read window count (the window origin is clamped to the level padded up
// to the window, the x origin rounded down to a multiple of 8); each bin is
// the mean of its S*S samples. Where the window covers the box, which the
// caller checks, this is exact ROIAlign. The same kernel also takes the
// read of the windowed XLA pooler (ops/roi_align.py:101, (window, window))
// and that of the XLA gather pooler (ops/roi_align.py:194, impl="gather",
// the default the mask and keypoint heads and the cascade call): no read
// window, every tap of the box on its level, which bounds the reads. A bin
// takes its 2 x 2 taps per sample in every read, so the gather costs the
// same loads as a window that holds the box.
//
// K2's bound: memory, and mostly its f32 output. The serving call pools
// R = 4 keyframes x 64 proposals = 256 ROIs of 7 x 7 x 256 channels: the
// output is 12.85 MB of the 14.6 MB the call must move (the rest is the
// feature cells its taps touch), ~16 tap reads and ~50 FLOP per output.
// Its design: one block per (ROI, output row py), R * P blocks (1,792 at
// serving, ~13 per SM), so enough warps are in flight to cover the loads'
// latency; one warp per bin px of the row; each lane owns 8 consecutive
// channels and reads them as one 16-byte vector through the read-only path
// (8 bf16, or two float4 of f32), so a warp reads a cell's 512 bytes of 256
// bf16 channels in one coalesced load, and writes its 8 f32 outputs as two
// 16-byte stores (1 KB contiguous per warp). The block lays out the taps of
// its S sample rows and P * S sample columns once in shared memory; zero-
// weight taps are skipped warp-uniformly. Each lane sums in f32 registers in
// the plain version's order: x taps, then y taps, then the S x S mean.
// Channels must be a multiple of 8 and every level 16-byte aligned (the
// wrapper raises otherwise).
//
// K3 replaces pallas_pooler.py:262, roi_align_pallas / _pooler_kernel:
// the same taps on one (h, w, C) map of one image at any spatial_scale
// (not only 1 / stride), with no level assignment. Its window is
// window_matrices' min(window, h) x min(window + 8, w), origin clamped to
// max(h - win_h, 0) and max(w - win_w, 0), x rounded down to a multiple of
// 8: on a map smaller than the window the origin is 0 and every in-map tap
// lies inside either window, so K2's padded window picks the same taps. K3
// is therefore K2's kernel with one level, the caller's scale and image 0
// (kSingleMap). Bound: memory, as K2's. The served call (64 proposals on
// one keyframe's 192 x 192 x 256 bf16 P2 map) moves ~3.6 MB, 3.2 MB of it
// the f32 output; its 448 blocks (3.4 per SM) are one wave, so the loads'
// latency, not a bandwidth, is what the design has to hide.
// The level assignment, the window and the taps are in roi_align_common.cuh,
// which K2's backward (roi_align_multilevel_backward.cu) shares.
#include "roi_align_common.cuh"

namespace {

// 8 consecutive channels of one cell as f32, in one 16-byte vector load
// through the read-only path (p is 16-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

constexpr int kMaxBinWarps = 16;  // warps of a block; bins past it loop

// Block (r, py) of a grid of R * P; warp px of the row's bins; lane
// channels [8 * lane, 8 * lane + 8) + 256 k. K2 assigns each box its level
// and reads image batch_idx[r]; K3 (kSingleMap) reads level 0 of image 0 at
// spatial_scale.
template <typename T, bool kSingleMap>
__global__ void __launch_bounds__(32 * kMaxBinWarps)
roi_align_ml_kernel(Pyramid pyr, int num_levels, int lvl_min, float spatial_scale,
                    const float* __restrict__ boxes, const int* __restrict__ batch_idx,
                    float* __restrict__ out, int C, int P, int S, int window, int read,
                    float canonical_size, int canonical_level) {
  __shared__ Taps taps;

  const int r = blockIdx.x / P, py = blockIdx.x % P;
  const BoxWindow bw = box_window(pyr, boxes + 4 * r, kSingleMap, num_levels, lvl_min, spatial_scale,
                                  window, read, canonical_size, canonical_level);
  const int lvl = bw.lvl, w = bw.w;
  fill_taps(taps, bw, py, P, S);
  __syncthreads();

  const T* feat = static_cast<const T*>(pyr.feat[lvl]);
  if (!kSingleMap) feat += static_cast<int64_t>(batch_idx[r]) * bw.h * w * C;
  float* orow = out + (static_cast<int64_t>(r) * P + py) * P * C;
  const int lane = threadIdx.x & 31;
  const float inv = 1.f / static_cast<float>(S * S);
  for (int px = threadIdx.x >> 5; px < P; px += blockDim.x >> 5) {
    for (int c = 8 * lane; c < C; c += 256) {
      float acc[8] = {};
      for (int iy = 0; iy < S; ++iy) {
        const int sy = py * S + iy;
        for (int ix = 0; ix < S; ++ix) {
          const int sx = px * S + ix;
          float v[8] = {};
#pragma unroll
          for (int ty = 0; ty < 2; ++ty) {
            const float wy = taps.wy[ty][sy];
            if (wy == 0.f) continue;  // adds 0 * row in the plain version
            float rowv[8] = {};
#pragma unroll
            for (int tx = 0; tx < 2; ++tx) {
              const float wx = taps.wx[tx][sx];
              if (wx == 0.f) continue;
              float f[8];
              load8(feat + (static_cast<int64_t>(taps.ky[ty][sy]) * w + taps.kx[tx][sx]) * C + c, f);
#pragma unroll
              for (int q = 0; q < 8; ++q) rowv[q] += wx * f[q];
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] += wy * rowv[q];
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += v[q];
        }
      }
      float4* o = reinterpret_cast<float4*>(orow + px * C + c);
      o[0] = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
      o[1] = make_float4(acc[4] * inv, acc[5] * inv, acc[6] * inv, acc[7] * inv);
    }
  }
}

// Both entries: C a multiple of 8, every map 16-byte aligned, out (R, P, P,
// C) f32 16-byte aligned.
template <bool kSingleMap>
int launch(const Pyramid& pyr, int num_levels, int lvl_min, float spatial_scale, int is_bf16,
           const void* boxes, const void* batch_idx, void* out, int R, int C, int P, int S,
           int window, int read, float canonical_size, int canonical_level, void* stream) {
  if (R == 0) return 0;
  if (P * S > kMaxSamples || num_levels < 1 || num_levels > 4 || C % 8 != 0 || read < kWindowed ||
      read > kGather)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * min(P, kMaxBinWarps);
  const int blocks = R * P;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* bi = static_cast<const int*>(batch_idx);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    roi_align_ml_kernel<__nv_bfloat16, kSingleMap><<<blocks, threads, 0, s>>>(
        pyr, num_levels, lvl_min, spatial_scale, bx, bi, o, C, P, S, window, read,
        canonical_size, canonical_level);
  } else {
    roi_align_ml_kernel<float, kSingleMap><<<blocks, threads, 0, s>>>(
        pyr, num_levels, lvl_min, spatial_scale, bx, bi, o, C, P, S, window, read,
        canonical_size, canonical_level);
  }
  SPE_RETURN_LAUNCH_STATUS();
}

}  // namespace

// f0..f3: per-level NHWC features (B, h_l, w_l, C), float32 or bfloat16
// (all the same type), fine to coarse, each 16-byte aligned with C a
// multiple of 8; levels past num_levels are unused. boxes: (R, 4) f32 XYXY
// in image pixels; batch_idx: (R,) int32; out: (R, P, P, C) f32, 16-byte
// aligned. lvl_min = log2 of the finest level's stride. read: the Read
// code, 1 for the Pallas pooler's read window, 0 for the windowed XLA
// pooler's, 2 for the XLA gather pooler's whole level (window unused).
extern "C" int roi_align_multilevel(const void* f0, const void* f1, const void* f2,
                                    const void* f3, int h0, int w0, int h1, int w1, int h2,
                                    int w2, int h3, int w3, int num_levels, int lvl_min,
                                    int is_bf16, const void* boxes, const void* batch_idx,
                                    void* out, int R, int C, int P, int S, int window,
                                    int read, float canonical_size, int canonical_level,
                                    void* stream) {
  const Pyramid pyr{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  return launch<false>(pyr, num_levels, lvl_min, 0.f, is_bf16, boxes, batch_idx, out, R, C, P, S,
                       window, read, canonical_size, canonical_level, stream);
}

// feat: (h, w, C) NHWC, float32 or bfloat16, 16-byte aligned with C a
// multiple of 8; boxes: (R, 4) f32 XYXY in image pixels, scaled by
// spatial_scale; out: (R, P, P, C) f32, 16-byte aligned.
extern "C" int roi_align_single(const void* feat, int h, int w, int C, int is_bf16,
                                const void* boxes, void* out, int R, int P, float spatial_scale,
                                int S, int window, void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pyramid pyr{{feat}, {h}, {w}};
  return launch<true>(pyr, 1, 0, spatial_scale, is_bf16, boxes, nullptr, out, R, C, P, S, window,
                      kPallas, 0.f, 0, stream);
}
