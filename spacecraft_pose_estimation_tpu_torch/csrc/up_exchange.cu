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
// One 256-thread block per TY x TX tile of output pixels of one image. It
// first computes, for each coarser operand j, the 1x1 conv of the low-res
// pixels under its tile into shared memory (each low-res pixel once, as
// the TPU kernel does, so no conv is repeated per output pixel), then the
// weighted sum for every output element of the tile.
//
// Bound: bytes at the serving shapes (the 1x1 convs are small; every
// operand is read once and the output written once).
#include "int8_common.cuh"

namespace {

using namespace spe_i8;

constexpr int kMaxOps = 3;  // at most 3 finer or coarser operands (4 branches)
constexpr int TY = 16, TX = 16;

struct Up {
  const int8_t* u;   // (B, h, w, cu)
  const int8_t* wk;  // (cu, C): a 1x1 HWIO kernel
  const float* m;
  const float* b;
  int h, w, cu, f;
};

struct ExchangeArgs {
  const int8_t* yi;              // (B, H, W, C)
  const int8_t* downs[kMaxOps];  // (B, H, W, C)
  Up ups[kMaxOps];
  const float* coeffs;           // (1 + n_down + n_up,)
  int8_t* out;
  int n_down, n_up, H, W, C;
};

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int TN>
__global__ void __launch_bounds__(kThreads) up_exchange_kernel(ExchangeArgs a) {
  __shared__ Smem<TN> sm;
  extern __shared__ int8_t low[];  // the low-res conv outputs under this tile
  const int img = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int C = a.C;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W * C;

  int lo_y[kMaxOps], lo_x[kMaxOps], n_x[kMaxOps];
  int8_t* buf[kMaxOps];
  int8_t* next = low;
  for (int j = 0; j < a.n_up; ++j) {
    const Up& u = a.ups[j];
    lo_y[j] = y0 / u.f;
    lo_x[j] = x0 / u.f;
    const int hi_y = min(u.h, ceil_div(min(a.H, y0 + TY), u.f));
    const int hi_x = min(u.w, ceil_div(min(a.W, x0 + TX), u.f));
    n_x[j] = hi_x - lo_x[j];
    buf[j] = next;
    next += ceil_div(TY, u.f) * ceil_div(TX, u.f) * C;
    const Src s{u.u + static_cast<int64_t>(img) * u.h * u.w * u.cu, 0, u.h, u.w, u.cu};
    const ConvW cw{u.wk, u.m, u.b, 1, 1, u.cu, C, 1};
    const StoreRq epi{cw, {buf[j], lo_y[j], lo_x[j], n_x[j], C}, false};
    const int npx = (hi_y - lo_y[j]) * n_x[j];
    const int tiles_p = ceil_div(npx, Tile<TN>::TM), tiles_c = ceil_div(C, TN);
    for (int t = 0; t < tiles_p * tiles_c; ++t)
      conv_tile<TN>(s, cw, lo_y[j], lo_x[j], n_x[j], npx, t / tiles_c, t % tiles_c, sm, epi);
  }
  __syncthreads();

  const int rows = min(TY, a.H - y0), cols = min(TX, a.W - x0);
  for (int e = threadIdx.x; e < rows * cols * C; e += kThreads) {
    const int ch = e % C, p = e / C;
    const int y = y0 + p / cols, x = x0 + p % cols;
    const int64_t at = static_cast<int64_t>(img) * plane + (static_cast<int64_t>(y) * a.W + x) * C + ch;
    float acc = static_cast<float>(a.yi[at]) * a.coeffs[0];
    int ci = 1;
    for (int k = 0; k < a.n_down; ++k) acc = acc + static_cast<float>(a.downs[k][at]) * a.coeffs[ci++];
    for (int j = 0; j < a.n_up; ++j) {
      const int f = a.ups[j].f;
      const int8_t v = buf[j][((y / f - lo_y[j]) * n_x[j] + (x / f - lo_x[j])) * C + ch];
      acc = acc + static_cast<float>(v) * a.coeffs[ci++];
    }
    a.out[at] = requant(fmaxf(acc, 0.f));
  }
}

}  // namespace

// yi, downs[k], out: (B, H, W, C) int8; ups[j]: u (B, h_j, w_j, cu_j) int8
// with H = h_j * f_j and W = w_j * f_j, w (cu_j, C) int8, m, b (C,) f32;
// coeffs (1 + n_down + n_up,) f32. Unused pointers may be null.
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
  int smem = 0;
  for (int j = 0; j < n_up; ++j) {
    if (hs[j] < 1 || wds[j] < 1 || H % hs[j] != 0 || W % wds[j] != 0 || H / hs[j] != W / wds[j] ||
        cus[j] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int f = H / hs[j];
    a.ups[j] = Up{static_cast<const int8_t*>(us[j]), static_cast<const int8_t*>(ws[j]),
                  static_cast<const float*>(ms[j]), static_cast<const float*>(bs[j]),
                  hs[j], wds[j], cus[j], f};
    smem += ((TY + f - 1) / f) * ((TX + f - 1) / f) * C;
  }
  a.coeffs = static_cast<const float*>(coeffs);
  a.out = static_cast<int8_t*>(out);
  a.n_down = n_down;
  a.n_up = n_up;
  a.H = H;
  a.W = W;
  a.C = C;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (C <= 32) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(up_exchange_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    up_exchange_kernel<32><<<grid, kThreads, smem, s>>>(a);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(up_exchange_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    up_exchange_kernel<64><<<grid, kThreads, smem, s>>>(a);
  }
  SPE_RETURN_LAUNCH_STATUS();
}
