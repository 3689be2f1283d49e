// K2's backward: the gradient of the FPN ROIAlign with respect to the
// pyramid's features.
//
// No TPU kernel has a backward: the JAX trainer differentiates the windowed
// XLA pooler (spacecraft_pose_estimation_tpu/ops/roi_align.py:194,
// multilevel_roi_align(impl="windowed"), which models/roi_heads.py picks for
// config_1-config_3), and jax.grad through the Pallas pooler
// (ops/pallas_pooler.py:135) is not defined. This kernel is the gradient of
// K2's forward (roi_align_multilevel.cu), which computes that pooler's
// function: each bin's grad_out, times 1 / S^2, times the weights of its
// bilinear taps, is added into the cells of its box's level that the
// forward read.
//
// The same geometry, bit for bit: the level, the read window and the taps
// come from roi_align_common.cuh, the functions K2's forward calls, so a
// box on a level boundary sends its gradient to the level it pooled from,
// and a tap the window drops (weight 0) gets none.
//
// Bound: memory. The call must write the gradient of every level (the
// float32 buffers it zeroes and accumulates into, and for bf16 features
// the cast copy) and read grad_out; at batch 4 and 800^2 the f32 P2 buffer
// alone is 4 x 200 x 200 x 256 x 4 B = 164 MB, against 25.7 MB of grad_out
// for 512 ROIs. Its design, a simple one: the forward's blocks (one per
// (ROI, output row), a warp per bin, 8 channels a lane), each tap's
// contribution added with one float32 atomicAdd per channel into the
// level's buffer, which the call zeroes first (cudaMemsetAsync); for bf16
// features a second kernel casts each buffer to bf16 (round to nearest),
// 8 channels a thread. Atomics sum in no fixed order, so two runs agree
// to rounding, not bit for bit.
#include "roi_align_common.cuh"

namespace {

constexpr int kMaxBinWarps = 16;  // warps of a block; bins past it loop

struct Grads {
  float* g[4];
};

// Block (r, py) of a grid of R * P; warp px of the row's bins; lane
// channels [8 * lane, 8 * lane + 8) + 256 k.
__global__ void __launch_bounds__(32 * kMaxBinWarps)
roi_align_ml_backward_kernel(Pyramid pyr, Grads grads, int num_levels, int lvl_min,
                             const float* __restrict__ boxes, const int* __restrict__ batch_idx,
                             const float* __restrict__ grad_out, int C, int P, int S, int window,
                             int pallas_window, float canonical_size, int canonical_level) {
  __shared__ Taps taps;

  const int r = blockIdx.x / P, py = blockIdx.x % P;
  const BoxWindow bw = box_window(pyr, boxes + 4 * r, false, num_levels, lvl_min, 0.f, window,
                                  pallas_window != 0, canonical_size, canonical_level);
  fill_taps(taps, bw, py, P, S, window);
  __syncthreads();

  float* g = grads.g[bw.lvl] + static_cast<int64_t>(batch_idx[r]) * bw.h * bw.w * C;
  const float* grow = grad_out + (static_cast<int64_t>(r) * P + py) * P * C;
  const int lane = threadIdx.x & 31;
  const float inv = 1.f / static_cast<float>(S * S);
  for (int px = threadIdx.x >> 5; px < P; px += blockDim.x >> 5) {
    for (int c = 8 * lane; c < C; c += 256) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(grow + px * C + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(grow + px * C + c) + 1);
      // the plain version's order: (grad * 1 / S^2) * wy * wx
      const float go[8] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv,
                           b.x * inv, b.y * inv, b.z * inv, b.w * inv};
      for (int iy = 0; iy < S; ++iy) {
        const int sy = py * S + iy;
        for (int ix = 0; ix < S; ++ix) {
          const int sx = px * S + ix;
#pragma unroll
          for (int ty = 0; ty < 2; ++ty) {
            const float wy = taps.wy[ty][sy];
            if (wy == 0.f) continue;  // a dropped tap: no gradient
            float gy[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) gy[q] = go[q] * wy;
#pragma unroll
            for (int tx = 0; tx < 2; ++tx) {
              const float wx = taps.wx[tx][sx];
              if (wx == 0.f) continue;
              float* cell = g + (static_cast<int64_t>(taps.ky[ty][sy]) * bw.w + taps.kx[tx][sx]) * C + c;
#pragma unroll
              for (int q = 0; q < 8; ++q) atomicAdd(cell + q, gy[q] * wx);
            }
          }
        }
      }
    }
  }
}

// n8 groups of 8 floats -> bf16, round to nearest even; 16-byte aligned.
__global__ void cast_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                 int64_t n8) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n8;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(in) + 2 * i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(in) + 2 * i + 1);
    __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                           __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
    reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(h);
  }
}

}  // namespace

// grad_out: (R, P, P, C) f32, 16-byte aligned. g0..g3: per-level f32 NHWC
// buffers (B, h_l, w_l, C), 16-byte aligned, which the call zeroes and
// fills with the gradient; o0..o3: for bf16 features (is_bf16) the
// per-level bf16 gradients the call casts them into, unused otherwise.
// Levels past num_levels are unused. boxes (R, 4) f32 XYXY image pixels,
// batch_idx (R,) int32; lvl_min = log2 of the finest level's stride;
// pallas_window as the forward's. C a multiple of 8.
extern "C" int roi_align_multilevel_backward(
    const void* grad_out, void* g0, void* g1, void* g2, void* g3, void* o0, void* o1, void* o2,
    void* o3, int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3, int B,
    int num_levels, int lvl_min, int is_bf16, const void* boxes, const void* batch_idx, int R,
    int C, int P, int S, int window, int pallas_window, float canonical_size, int canonical_level,
    void* stream) {
  if (P * S > kMaxSamples || num_levels < 1 || num_levels > 4 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Pyramid pyr{{nullptr, nullptr, nullptr, nullptr}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const Grads grads{{static_cast<float*>(g0), static_cast<float*>(g1), static_cast<float*>(g2),
                     static_cast<float*>(g3)}};
  void* outs[4] = {o0, o1, o2, o3};
  for (int l = 0; l < num_levels; ++l) {
    const size_t n = static_cast<size_t>(B) * pyr.h[l] * pyr.w[l] * C;
    const cudaError_t e = cudaMemsetAsync(grads.g[l], 0, n * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (R > 0) {
    roi_align_ml_backward_kernel<<<R * P, 32 * min(P, kMaxBinWarps), 0, s>>>(
        pyr, grads, num_levels, lvl_min, static_cast<const float*>(boxes),
        static_cast<const int*>(batch_idx), static_cast<const float*>(grad_out), C, P, S, window,
        pallas_window, canonical_size, canonical_level);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (is_bf16) {
    for (int l = 0; l < num_levels; ++l) {
      const int64_t n8 = static_cast<int64_t>(B) * pyr.h[l] * pyr.w[l] * C / 8;
      if (n8 == 0) continue;
      const int64_t want = (n8 + 255) / 256;  // a grid-stride loop over at most 16 blocks an SM
      const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
      cast_bf16_kernel<<<blocks, 256, 0, s>>>(grads.g[l], static_cast<__nv_bfloat16*>(outs[l]), n8);
    }
  }
  SPE_RETURN_LAUNCH_STATUS();
}
