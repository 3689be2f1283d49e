// K2: FPN ROIAlign over up to four pyramid levels in one pass.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_pooler.py,
// multilevel_roi_align_pallas / _ml_pooler_kernel. Semantics are those of
// its level_mats / window_matrices: each box picks its level
// floor(canonical_level + log2(sqrt(area) / canonical_size + 1e-8)) clipped
// to the pyramid; sample points use the aligned -0.5 offset and a regular
// S x S sub-grid per bin; a sample outside (-1, size) is 0, otherwise it is
// clamped into [0, size-1]; only taps inside the box's (window, window+8)
// read window count (the window origin is clamped to the level padded up
// to the window, the x origin rounded down to a multiple of 8); each bin is
// the mean of its S*S samples. Where the window covers the box, which the
// caller checks, this is exact ROIAlign.
//
// One block per ROI (over all images; batch_idx names the ROI's image).
// The block first lays out the 2 taps of each of the P*S sample rows and
// columns in shared memory, then its threads span (bin, channel): channels
// are innermost, so a warp reads 32 consecutive channels of one NHWC cell.
//
// Bound: memory. Per ROI it writes P*P*C f32 (50 KB at 7x7x256) and reads
// at most (P*S*2)^2 cells of C channels of one level, ~16 reads and ~50
// FLOP per output value.
#include "common.cuh"

namespace {

constexpr int kMaxSamples = 64;  // P * S per axis

struct Pyramid {
  const void* feat[4];
  int h[4];
  int w[4];
};

// Taps of one sample coordinate along one axis, with the window and
// in-bounds masks folded into the weights (a masked tap has weight 0 and a
// safe index 0).
__device__ void axis_taps(float coord, int limit, int origin, int win, int* k, float* wgt) {
  const bool inb = coord > -1.f && coord < static_cast<float>(limit);
  const float cc = fminf(fmaxf(coord, 0.f), static_cast<float>(limit - 1));
  const int k0 = static_cast<int>(floorf(cc));
  const float rel = cc - static_cast<float>(origin);
  for (int t = 0; t < 2; ++t) {
    const int kk = k0 + t;
    const int local = kk - origin;
    float w = fmaxf(0.f, 1.f - fabsf(rel - static_cast<float>(local)));
    const bool ok = inb && local >= 0 && local < win && kk < limit;
    k[t] = ok ? kk : 0;
    wgt[t] = ok ? w : 0.f;
  }
}

template <typename T>
__global__ void roi_align_ml_kernel(Pyramid pyr, int num_levels, int lvl_min,
                                    const float* __restrict__ boxes,
                                    const int* __restrict__ batch_idx,
                                    float* __restrict__ out, int C, int P, int S, int window,
                                    float canonical_size, int canonical_level) {
  __shared__ int ky[2][kMaxSamples], kx[2][kMaxSamples];
  __shared__ float wy[2][kMaxSamples], wx[2][kMaxSamples];

  const int r = blockIdx.x;
  const float* box = boxes + 4 * r;
  const int win_h = window, win_w = window + 8;
  const int ps = P * S;

  // level assignment (pallas_pooler.py:165-171)
  const float bw = fmaxf(box[2] - box[0], 0.f);
  const float bh = fmaxf(box[3] - box[1], 0.f);
  const float area = bw * bh;
  float target = floorf(static_cast<float>(canonical_level) +
                        log2f(sqrtf(area) / canonical_size + 1e-8f));
  target = fminf(fmaxf(target, static_cast<float>(lvl_min)),
                 static_cast<float>(lvl_min + num_levels - 1));
  const int lvl = static_cast<int>(target) - lvl_min;

  const int h = pyr.h[lvl], w = pyr.w[lvl];
  const float scale = 1.f / static_cast<float>(1 << (lvl_min + lvl));
  const float x0 = box[0] * scale - 0.5f, y0 = box[1] * scale - 0.5f;
  const float x1 = box[2] * scale - 0.5f, y1 = box[3] * scale - 0.5f;
  const int hp = max(h, win_h), wp = max(w, win_w);
  const int oy = min(max(static_cast<int>(floorf(y0)) - 1, 0), hp - win_h);
  int ox = min(max(static_cast<int>(floorf(x0)) - 1, 0), wp - win_w);
  ox = (ox / 8) * 8;

  for (int i = threadIdx.x; i < ps; i += blockDim.x) {
    const float grid = static_cast<float>(i / S) +
                       (static_cast<float>(i % S) + 0.5f) / static_cast<float>(S);
    const float sy = y0 + grid * (y1 - y0) / static_cast<float>(P);
    const float sx = x0 + grid * (x1 - x0) / static_cast<float>(P);
    int k[2];
    float wt[2];
    axis_taps(sy, h, oy, win_h, k, wt);
    ky[0][i] = k[0]; ky[1][i] = k[1]; wy[0][i] = wt[0]; wy[1][i] = wt[1];
    axis_taps(sx, w, ox, win_w, k, wt);
    kx[0][i] = k[0]; kx[1][i] = k[1]; wx[0][i] = wt[0]; wx[1][i] = wt[1];
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pyr.feat[lvl]) +
                  static_cast<int64_t>(batch_idx[r]) * h * w * C;
  const float inv = 1.f / static_cast<float>(S * S);
  const int n_out = P * P * C;
  float* o = out + static_cast<int64_t>(r) * n_out;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int c = e % C;
    const int bin = e / C;
    const int px = bin % P, py = bin / P;
    float acc = 0.f;
    for (int iy = 0; iy < S; ++iy) {
      const int sy = py * S + iy;
      for (int ix = 0; ix < S; ++ix) {
        const int sx = px * S + ix;
        float v = 0.f;
        for (int ty = 0; ty < 2; ++ty) {
          float rowv = 0.f;
          for (int tx = 0; tx < 2; ++tx) {
            const float wgt = wx[tx][sx];
            if (wgt != 0.f && wy[ty][sy] != 0.f)
              rowv += wgt * spe_load(feat, (static_cast<int64_t>(ky[ty][sy]) * w + kx[tx][sx]) * C + c);
          }
          v += wy[ty][sy] * rowv;
        }
        acc += v;
      }
    }
    o[e] = acc * inv;
  }
}

}  // namespace

// f0..f3: per-level NHWC features (B, h_l, w_l, C), float32 or bfloat16
// (all the same type), fine to coarse; levels past num_levels are unused.
// boxes: (R, 4) f32 XYXY in image pixels; batch_idx: (R,) int32;
// out: (R, P, P, C) f32. lvl_min = log2 of the finest level's stride.
extern "C" int roi_align_multilevel(const void* f0, const void* f1, const void* f2,
                                    const void* f3, int h0, int w0, int h1, int w1, int h2,
                                    int w2, int h3, int w3, int num_levels, int lvl_min,
                                    int is_bf16, const void* boxes, const void* batch_idx,
                                    void* out, int R, int C, int P, int S, int window,
                                    float canonical_size, int canonical_level, void* stream) {
  if (R == 0) return 0;
  if (P * S > kMaxSamples || num_levels < 1 || num_levels > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int threads = 256;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_ml_kernel<__nv_bfloat16><<<R, threads, 0, s>>>(
        pyr, num_levels, lvl_min, static_cast<const float*>(boxes),
        static_cast<const int*>(batch_idx), static_cast<float*>(out), C, P, S, window,
        canonical_size, canonical_level);
  } else {
    roi_align_ml_kernel<float><<<R, threads, 0, s>>>(
        pyr, num_levels, lvl_min, static_cast<const float*>(boxes),
        static_cast<const int*>(batch_idx), static_cast<float*>(out), C, P, S, window,
        canonical_size, canonical_level);
  }
  SPE_RETURN_LAUNCH_STATUS();
}
