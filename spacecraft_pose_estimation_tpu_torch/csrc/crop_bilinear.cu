// K1: axis-aligned bilinear crop of uint8 frames, zero border.
//
// Replaces the windowed serving crop of the JAX package:
// spacecraft_pose_estimation_tpu/ops/pallas_crop.py, extract_windows /
// _window_kernel and hcontract_windows / _hcontract_kernel (composed by
// crop_and_resize_window), and the XLA windowed crop
// ops/warp.crop_and_resize_mxu_windowed. Once the crop scale is clamped to
// the window (ops/warp.clamp_scales_to_window) both equal the full-frame
// separable crop ops/warp.crop_and_resize_mxu, which is what this kernel
// computes directly from the frame: no window copy is needed here, since a
// thread reads its four taps where they lie.
//
// out[b, y, x, c] = sum over the taps (ky, kx) of wy(ky) * wx(kx) * frame[b, ky, kx, c]
// with xs = ax * x + bx and ys = ay * y + by (the rot=0 inverse crop affine
// of geometry.crop_affine_matrix), tap weight max(0, 1 - |s - k|), a tap
// outside the frame contributing 0, and the whole sample 0 unless
// -1 < s < size on both axes (cv2 BORDER_CONSTANT 0, warp._interp_matrix).
// The x taps are summed first, as the separable crop contracts W first.
//
// Bound: memory. Per 512x512 crop it writes 3.1 MB of f32 and reads at most
// the (crop side + 1)^2 x 3 bytes of frame under the crop (1.77 MB for the
// serving 768-px window), at ~12 FLOP per output value. One thread per
// output pixel computes its three channels, so neighbouring threads read
// neighbouring frame bytes and write neighbouring output floats.
#include "common.cuh"

__global__ void crop_bilinear_kernel(const uint8_t* __restrict__ frames,
                                     const float* __restrict__ params,
                                     float* __restrict__ out, int B, int H, int W,
                                     int OH, int OW) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(B) * OH * OW;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % OW);
  const int64_t row = idx / OW;
  const int y = static_cast<int>(row % OH);
  const int b = static_cast<int>(row / OH);

  const float* p = params + 4 * b;  // ax, bx, ay, by
  const float xs = p[0] * static_cast<float>(x) + p[1];
  const float ys = p[2] * static_cast<float>(y) + p[3];
  float acc[3] = {0.f, 0.f, 0.f};
  if (xs > -1.f && xs < static_cast<float>(W) && ys > -1.f && ys < static_cast<float>(H)) {
    const int kx0 = static_cast<int>(floorf(xs));
    const int ky0 = static_cast<int>(floorf(ys));
    float wx[2], wy[2];
    bool vx[2], vy[2];
    for (int t = 0; t < 2; ++t) {
      wx[t] = fmaxf(0.f, 1.f - fabsf(xs - static_cast<float>(kx0 + t)));
      wy[t] = fmaxf(0.f, 1.f - fabsf(ys - static_cast<float>(ky0 + t)));
      vx[t] = kx0 + t >= 0 && kx0 + t < W;
      vy[t] = ky0 + t >= 0 && ky0 + t < H;
    }
    const uint8_t* img = frames + static_cast<int64_t>(b) * H * W * 3;
    for (int ty = 0; ty < 2; ++ty) {
      float rowv[3] = {0.f, 0.f, 0.f};
      for (int tx = 0; tx < 2; ++tx) {
        if (!(vy[ty] && vx[tx])) continue;
        const uint8_t* px = img + (static_cast<int64_t>(ky0 + ty) * W + (kx0 + tx)) * 3;
        for (int c = 0; c < 3; ++c) rowv[c] += wx[tx] * static_cast<float>(px[c]);
      }
      for (int c = 0; c < 3; ++c) acc[c] += wy[ty] * rowv[c];
    }
  }
  float* o = out + idx * 3;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
}

// frames: (B, H, W, 3) uint8; params: (B, 4) f32 [ax, bx, ay, by];
// out: (B, OH, OW, 3) f32. All contiguous, on the device of `stream`.
extern "C" int crop_bilinear(const void* frames, const void* params, void* out, int B, int H,
                             int W, int OH, int OW, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * OH * OW;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  crop_bilinear_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(params),
      static_cast<float*>(out), B, H, W, OH, OW);
  SPE_RETURN_LAUNCH_STATUS();
}
