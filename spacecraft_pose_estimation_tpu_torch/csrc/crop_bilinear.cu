// K1: axis-aligned bilinear crop of uint8 frames, zero border.
//
// Replaces the windowed serving crop of the JAX package:
// spacecraft_pose_estimation_tpu/ops/pallas_crop.py, extract_windows /
// _window_kernel and hcontract_windows / _hcontract_kernel (composed by
// crop_and_resize_window), and the XLA windowed crop
// ops/warp.crop_and_resize_mxu_windowed. Once the crop scale is clamped to
// the window (ops/warp.clamp_scales_to_window) both equal the full-frame
// separable crop ops/warp.crop_and_resize_mxu, which is what this kernel
// computes directly from the frame: no window copy is needed here.
//
// out[b, y, x, c] = sum over the taps (ky, kx) of wy(ky) * wx(kx) * frame[b, ky, kx, c]
// with xs = ax * x + bx and ys = ay * y + by (the rot=0 inverse crop affine
// of geometry.crop_affine_matrix), tap weight max(0, 1 - |s - k|), a tap
// outside the frame contributing 0, and the whole sample 0 unless
// -1 < s < size on both axes (cv2 BORDER_CONSTANT 0, warp._interp_matrix).
// The x taps are summed first, as the separable crop contracts W first,
// each product rounded before its sum (no fused multiply-add): bit for bit
// the plain version's arithmetic. (A tap off the frame is weighted 0 rather
// than skipped, and the plain version's leading 0 + is dropped: both leave
// a sum of nonnegative products unchanged to the bit.)
//
// Bound: memory. A 512x512 crop writes 3.1 MB of float32 and reads at most
// the (crop side + 1)^2 x 3 bytes of frame under it (1.77 MB for the serving
// 768-px window), at ~12 FLOP per output value: the stores are two thirds
// of the bytes.
//
// Design: one block owns a band of one crop, kTileRows output rows of
// kTileCols pixels, and takes it in three stages (in passes of fewer pixels
// above a downsampling step of 2, where the staged columns would outgrow the
// buffer):
//   1. stage the frame bytes its taps reach in shared memory, a warp a row:
//      the contiguous run of source rows when it fits in 2 * kTileRows
//      rows, else the two tapped rows of each output row; of each row, the
//      run of tapped columns, as the 16-byte aligned pieces that hold it,
//      copied whole with cp.async (the bytes beside the run are staged and
//      never read; byte loads only where a piece crosses either end of the
//      frames' tensor), so any row stride and frame offset takes the same
//      path. Rows off the frame are not staged and count as 0, columns off
//      it are weighted 0;
//   2. contract x on every staged row into float32 rows in shared memory,
//      a thread a column: a tap pair's 6 bytes read as 32-bit words, each
//      byte turned into a float with a byte permute and a subtraction
//      (2^23 + byte, exact) instead of the conversion unit's I2F;
//   3. contract y and write each output row's run of 3 * kTileCols floats,
//      a warp a row, with 16-byte stores, neighbouring lanes on
//      neighbouring 16 bytes (a warp covers 512 contiguous bytes), and
//      scalar stores for the up to 3 floats at each end where the run is not
//      16-byte aligned (OW % 4 != 0).
// What the whole band shares (its rows' y taps and the source rows they
// span, the columns' x taps and the run of valid columns) is worked out once,
// by one warp or one thread a column, before a single barrier. Plain stores:
// the landmark network reads the crops next. No allocation and no
// synchronisation beyond the block, so a CUDA graph can capture it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;    // output rows a block
constexpr int kTileCols = 128;  // output pixels a row of a block
constexpr int kIntMax = 0x7fffffff, kIntMin = -kIntMax - 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// the bilinear tap weight max(0, 1 - |s - k|)
__device__ __forceinline__ float tap_weight(float s, int k) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, static_cast<float>(k)))));
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// w0 * a + w1 * c, each product rounded: a tap pair's sum on either axis
__device__ __forceinline__ float pair_sum(float w0, float a, float w1, float c) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, c));
}

// byte k of w as a float: the bits of 2^23 + byte, less 2^23
template <int k>
__device__ __forceinline__ float byte_float(uint32_t w) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | k)), 8388608.f);
}

template <int TY, int TX>
__global__ void __launch_bounds__(kThreads)
crop_bilinear_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ params,
                     float* __restrict__ out, int H, int W, int OH, int OW) {
  constexpr int kRows = 2 * TY;                          // staged source rows
  constexpr int kMaxCols = 2 * TX + 2;                   // staged columns a pass
  constexpr int kPitch = (3 * kMaxCols + 30) / 16 * 16;  // a staged row: any alignment, 3 words read
  constexpr int kRun = 3 * TX;                           // floats of an output row's run
  constexpr int kWarpsX = TX / 32, kWarps = kThreads / 32;
  static_assert(TX % 32 == 0 && kThreads % TX == 0 && TY <= 32, "tile");

  __shared__ __align__(16) uint8_t s_src[kRows * kPitch];
  __shared__ __align__(16) float s_row[kRows * kRun];
  __shared__ int s_ky[TY];      // floor(ys) of each output row; kIntMin: the row is 0
  __shared__ float s_wy[TY][2];
  __shared__ int s_lo, s_nrows;  // the staged rows: lo..lo + nrows - 1 (s_nrows > 0), else 2 an output row
  __shared__ int s_kx[TX];      // each column's first x tap; kIntMin where the sample is 0
  __shared__ int s_valid[2][kWarpsX];
  __shared__ int s_off[kRows];  // byte offset of a pass's first column in a staged row; -1: off the frame

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int nx = min(TX, OW - x0), ny = min(TY, OH - y0);
  const float ax = params[4 * b], bx = params[4 * b + 1];
  const uint8_t* img = frames + static_cast<int64_t>(b) * H * W * 3;
  const uint8_t* frames_end = frames + static_cast<int64_t>(gridDim.z) * H * W * 3;

  if (warp == kWarps - 1) {  // the band's rows: a lane a row
    const float ys = __fadd_rn(__fmul_rn(params[4 * b + 2], static_cast<float>(y0 + lane)), params[4 * b + 3]);
    int ky = kIntMin;
    if (lane < ny && ys > -1.f && ys < static_cast<float>(H)) {
      ky = static_cast<int>(floorf(ys));
      s_wy[lane][0] = tap_weight(ys, ky);
      s_wy[lane][1] = tap_weight(ys, ky + 1);
    }
    if (lane < TY) s_ky[lane] = ky;
    const int lo = __reduce_min_sync(0xffffffffu, ky != kIntMin ? ky : kIntMax);
    const int hi = __reduce_max_sync(0xffffffffu, ky != kIntMin ? ky + 1 : kIntMin);
    if (lane == 0) {  // the contiguous run when it fits in kRows rows (negative nrows: two rows an output row)
      s_lo = lo;
      s_nrows = hi < lo ? 0 : (hi - lo < kRows ? hi - lo + 1 : -kRows);
    }
  }
  // this thread's output column, and its x taps (a tap off the frame weighted 0)
  const int x = tid % TX;
  const float xs = __fadd_rn(__fmul_rn(ax, static_cast<float>(x0 + x)), bx);
  const bool vx = x < nx && xs > -1.f && xs < static_cast<float>(W);
  const int kx = vx ? static_cast<int>(floorf(xs)) : 0;
  const float w0 = vx && kx >= 0 ? tap_weight(xs, kx) : 0.f;
  const float w1 = vx && kx + 1 < W ? tap_weight(xs, kx + 1) : 0.f;
  if (tid < TX) {  // xs is monotone in x, so the valid columns are one run: its ends
    s_kx[x] = vx ? kx : kIntMin;
    const int first = __reduce_min_sync(0xffffffffu, vx ? x : kIntMax);
    const int last = __reduce_max_sync(0xffffffffu, vx ? x : kIntMin);
    if (lane == 0) {
      s_valid[0][warp] = first;
      s_valid[1][warp] = last;
    }
  }
  __syncthreads();
  const int lo = s_lo, nrows = abs(s_nrows);
  const bool span = s_nrows > 0;
  int xv0 = kIntMax, xv1 = kIntMin;
#pragma unroll
  for (int w = 0; w < kWarpsX; ++w) {
    xv0 = min(xv0, s_valid[0][w]);
    xv1 = max(xv1, s_valid[1][w]);
  }

  // pixels a pass: up to a step of 2 the band's columns at once, so that its taps span at most kMaxCols
  const float step = fabsf(ax);
  int chunk = TX;
  if (step > 2.f) chunk = step < 1e6f ? max(1, min(TX, 1 + static_cast<int>((2.f * TX - 2.f) / step))) : 1;
  for (int xa = 0; xa < nx; xa += chunk) {
    const int xb = min(nx, xa + chunk);
    // the columns this pass's taps reach (-1 and W among them: staged, weighted 0): [c0, c0 + ncols)
    int c0 = 0, ncols = 0;
    const int xl = max(xa, xv0), xr = min(xb - 1, xv1);
    if (xl <= xr) {
      const int kl = s_kx[xl], kr = s_kx[xr];
      c0 = min(kl, kr);
      ncols = min(max(kl, kr) + 2 - c0, kMaxCols);
    }

    // 1. stage, a warp a row: the 16-byte aligned pieces that hold the run
    const int nbytes = 3 * ncols;
    for (int r = warp; r < nrows; r += kWarps) {
      int sy = -1;
      if (span) {
        sy = lo + r;
      } else if (s_ky[r >> 1] != kIntMin) {
        sy = s_ky[r >> 1] + (r & 1);
      }
      if (sy < 0 || sy >= H || nbytes == 0) {
        if (lane == 0) s_off[r] = -1;
        continue;
      }
      const uint8_t* first = img + (static_cast<int64_t>(sy) * W + c0) * 3;
      const int off = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15);
      if (lane == 0) s_off[r] = off;
      const uint8_t* base = first - off;
      const int npiece = (off + nbytes + 15) >> 4;
      for (int j = lane; j < npiece; j += 32) {
        const uint8_t* piece = base + 16 * j;
        uint8_t* dst = s_src + r * kPitch + 16 * j;
        if (piece >= frames && piece + 16 <= frames_end) {
          cp_async16(dst, piece);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) dst[k] = piece + k >= frames && piece + k < frames_end ? piece[k] : 0;
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // 2. contract x on each staged row: w0 * p0 + w1 * p1
    if (x >= xa && x < xb) {
      const int dx = 3 * (kx - c0);
      for (int r = tid / TX; r < nrows; r += kThreads / TX) {
        const int off = s_off[r];
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        if (vx && off >= 0) {
          const int o = off + dx;
          const uint32_t* word = reinterpret_cast<const uint32_t*>(s_src + r * kPitch) + (o >> 2);
          const uint32_t lo4 = __funnelshift_r(word[0], word[1], 8 * (o & 3));  // bytes o..o+3
          const uint32_t hi4 = __funnelshift_r(word[1], word[2], 8 * (o & 3));  // bytes o+4..o+7
          v0 = pair_sum(w0, byte_float<0>(lo4), w1, byte_float<3>(lo4));
          v1 = pair_sum(w0, byte_float<1>(lo4), w1, byte_float<0>(hi4));
          v2 = pair_sum(w0, byte_float<2>(lo4), w1, byte_float<1>(hi4));
        }
        float* o = s_row + r * kRun + 3 * x;
        o[0] = v0;
        o[1] = v1;
        o[2] = v2;
      }
    }
    __syncthreads();
  }

  // 3. contract y and store, a warp a row: 16-byte stores, the unaligned ends one float at a time
  for (int i = warp; i < ny; i += kWarps) {
    float* o = out + ((static_cast<int64_t>(b) * OH + y0 + i) * OW + x0) * 3;
    const int n = 3 * nx;
    const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> 2);
    const int body = (n - head) >> 2, tail = n - head - 4 * body;
    const int ky = s_ky[i];
    const bool vy = ky != kIntMin;  // else the row is 0
    const float wy0 = vy ? s_wy[i][0] : 0.f, wy1 = vy ? s_wy[i][1] : 0.f;
    const float* a = s_row + (vy ? (span ? ky - lo : 2 * i) : 0) * kRun;
    const float* c = a + kRun;
    for (int q = lane; q < body; q += 32) {
      const int f = head + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vy) {
        float4 va, vc;
        if (head == 0) {
          va = *reinterpret_cast<const float4*>(a + f);
          vc = *reinterpret_cast<const float4*>(c + f);
        } else {
          va = make_float4(a[f], a[f + 1], a[f + 2], a[f + 3]);
          vc = make_float4(c[f], c[f + 1], c[f + 2], c[f + 3]);
        }
        v = make_float4(pair_sum(wy0, va.x, wy1, vc.x), pair_sum(wy0, va.y, wy1, vc.y),
                        pair_sum(wy0, va.z, wy1, vc.z), pair_sum(wy0, va.w, wy1, vc.w));
      }
      store4(o + f, v);
    }
    if (lane < head + tail) {
      const int f = lane < head ? lane : head + 4 * body + (lane - head);
      store1(o + f, vy ? pair_sum(wy0, a[f], wy1, c[f]) : 0.f);
    }
  }
}

}  // namespace

// frames: (B, H, W, 3) uint8, contiguous, at any byte offset; params: (B, 4)
// f32 [ax, bx, ay, by]; out: (B, OH, OW, 3) f32, contiguous and 4-byte
// aligned. All on the device of `stream`.
extern "C" int crop_bilinear(const void* frames, const void* params, void* out, int B, int H, int W, int OH,
                             int OW, void* stream) {
  if (B == 0 || OH == 0 || OW == 0) return 0;
  if (B > 65535 || (OH + kTileRows - 1) / kTileRows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((OW + kTileCols - 1) / kTileCols, (OH + kTileRows - 1) / kTileRows, B);
  crop_bilinear_kernel<kTileRows, kTileCols><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(params), static_cast<float*>(out), H, W,
      OH, OW);
  SPE_RETURN_LAUNCH_STATUS();
}
