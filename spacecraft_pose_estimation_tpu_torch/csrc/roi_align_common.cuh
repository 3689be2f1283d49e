// The windowed ROIAlign's geometry, shared by K2's forward
// (roi_align_multilevel.cu) and its backward
// (roi_align_multilevel_backward.cu): the level a box is pooled from, its
// read window and the two bilinear taps of every sample row and column.
// Both kernels compute them with these functions, so a box pools from and
// sends its gradient to the same level, and a tap the window drops in the
// forward gets no gradient in the backward.
#pragma once

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

// Sample point i of the P * S along one axis of a box from lo to hi: bin
// i / S, sub-sample i % S, at the centre of its 1 / S slice.
__device__ __forceinline__ float sample_coord(int i, float lo, float hi, int P, int S) {
  const float grid = static_cast<float>(i / S) +
                     (static_cast<float>(i % S) + 0.5f) / static_cast<float>(S);
  return lo + grid * (hi - lo) / static_cast<float>(P);
}

// The two taps of every sample row and column of one box, in shared memory.
struct Taps {
  int ky[2][kMaxSamples], kx[2][kMaxSamples];
  float wy[2][kMaxSamples], wx[2][kMaxSamples];
};

// One box on its level: the level index, the level's size, the box in the
// level's cells (aligned: -0.5), the origin of its read window and the
// window's width.
struct BoxWindow {
  int lvl, h, w, oy, ox, win_w;
  float x0, y0, x1, y1;
};

// K2 assigns each box its level (pallas_pooler.py:165-171) and maps it at
// 1 / stride; K3 (single_map) reads level 0 at spatial_scale. The window's
// origin is clamped to the level padded up to the window. pallas_window:
// the Pallas pooler's (window, window + 8) window, its x origin rounded down
// to a multiple of 8 (pallas_pooler.py:213-218); otherwise the windowed XLA
// pooler's (window, window) window (ops/roi_align.py:101-143). The two pick
// the same taps wherever the box fits the window and the x origin needs no
// rounding.
__device__ __forceinline__ BoxWindow box_window(const Pyramid& pyr, const float* box, bool single_map,
                                                int num_levels, int lvl_min, float spatial_scale,
                                                int window, bool pallas_window, float canonical_size,
                                                int canonical_level) {
  BoxWindow b;
  const int win_h = window, win_w = pallas_window ? window + 8 : window;
  b.win_w = win_w;
  b.lvl = 0;
  float scale = spatial_scale;
  if (!single_map) {
    const float bw = fmaxf(box[2] - box[0], 0.f);
    const float bh = fmaxf(box[3] - box[1], 0.f);
    const float area = bw * bh;
    float target = floorf(static_cast<float>(canonical_level) +
                          log2f(sqrtf(area) / canonical_size + 1e-8f));
    target = fminf(fmaxf(target, static_cast<float>(lvl_min)),
                   static_cast<float>(lvl_min + num_levels - 1));
    b.lvl = static_cast<int>(target) - lvl_min;
    scale = 1.f / static_cast<float>(1 << (lvl_min + b.lvl));
  }
  b.h = pyr.h[b.lvl];
  b.w = pyr.w[b.lvl];
  b.x0 = box[0] * scale - 0.5f;
  b.y0 = box[1] * scale - 0.5f;
  b.x1 = box[2] * scale - 0.5f;
  b.y1 = box[3] * scale - 0.5f;
  const int hp = max(b.h, win_h), wp = max(b.w, win_w);
  b.oy = min(max(static_cast<int>(floorf(b.y0)) - 1, 0), hp - win_h);
  const int ox = min(max(static_cast<int>(floorf(b.x0)) - 1, 0), wp - win_w);
  b.ox = pallas_window ? (ox / 8) * 8 : ox;
  return b;
}

// The block's taps: every sample column of the box, and the S sample rows
// of output row py. All threads of the block take part; the caller
// synchronizes before reading them.
__device__ __forceinline__ void fill_taps(Taps& taps, const BoxWindow& b, int py, int P, int S,
                                          int window) {
  for (int i = threadIdx.x; i < P * S; i += blockDim.x) {
    int k[2];
    float wt[2];
    axis_taps(sample_coord(i, b.x0, b.x1, P, S), b.w, b.ox, b.win_w, k, wt);
    taps.kx[0][i] = k[0]; taps.kx[1][i] = k[1]; taps.wx[0][i] = wt[0]; taps.wx[1][i] = wt[1];
    if (i < S) {
      const int iy = py * S + i;
      axis_taps(sample_coord(iy, b.y0, b.y1, P, S), b.h, b.oy, window, k, wt);
      taps.ky[0][iy] = k[0]; taps.ky[1][iy] = k[1]; taps.wy[0][iy] = wt[0]; taps.wy[1][iy] = wt[1];
    }
  }
}

}  // namespace
