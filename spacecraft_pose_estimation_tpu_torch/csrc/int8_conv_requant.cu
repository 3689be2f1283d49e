// K5a: one int8 convolution with its requant epilogue (the per-op int8 site).
//
// Replaces the XLA int8 convs of the JAX package's int8 walks:
// models/hrnet_int8.py _Int8Ops.convbn / final and models/backbone_int8.py
// _conv_i8 (jax.lax.conv_general_dilated with preferred_element_type=int32,
// then f = y * m + b). The Pallas chains K5-K7 run this same body
// (int8_common.cuh) on their own sites.
//
// x (B, H, W, Cin) int8 NHWC; w (k, k, Cin / groups, Cout) int8 HWIO;
// m, b (Cout,) f32. out (B, Ho, Wo, Cout) is int8
// clip(rint(relu?(f)), -127, 127) or, with out_f32, f32 relu?(f).
// Grid: (pixel tiles, channel tiles, B); one 256-thread block per tile.
//
// Bound: operations at the serving shapes (a 3x3 conv over 32-256 channels
// does 18 * Cin int8 ops per output byte), but this first kernel is bound
// by its own issue rate: dp4a on the CUDA cores, not the int8 tensor cores
// that the bound counts (wgmma is a later PR's work).
#include "int8_common.cuh"

namespace {

using namespace spe_i8;

template <int TN>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, ConvW cw, int H, int W, int Cin, int Ho, int Wo,
                 int relu, int out_f32, void* __restrict__ out) {
  __shared__ Smem<TN> sm;
  const int img = blockIdx.z;
  const Src s{x + static_cast<int64_t>(img) * H * W * Cin, 0, H, W, Cin};
  const int npx = Ho * Wo;
  const int64_t out_off = static_cast<int64_t>(img) * npx * cw.cout;
  if (out_f32) {
    const StoreF32 epi{cw, {static_cast<float*>(out) + out_off, 0, 0, Wo, cw.cout}, relu != 0};
    conv_tile<TN>(s, cw, 0, 0, Wo, npx, blockIdx.x, blockIdx.y, sm, epi);
  } else {
    const StoreRq epi{cw, {static_cast<int8_t*>(out) + out_off, 0, 0, Wo, cw.cout}, relu != 0};
    conv_tile<TN>(s, cw, 0, 0, Wo, npx, blockIdx.x, blockIdx.y, sm, epi);
  }
}

}  // namespace

extern "C" int int8_conv_requant(const void* x, const void* w, const void* m, const void* b,
                                 void* out, int B, int H, int W, int Cin, int Ho, int Wo,
                                 int Cout, int k, int stride, int groups, int relu, int out_f32,
                                 void* stream) {
  if (B == 0 || Ho * Wo == 0 || Cout == 0) return 0;
  if (Cin % 4 != 0 || groups < 1 || Cin % groups != 0 || (Cin / groups) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvW cw{static_cast<const int8_t*>(w), static_cast<const float*>(m),
                 static_cast<const float*>(b), k, stride, Cin / groups, Cout, groups};
  auto s = static_cast<cudaStream_t>(stream);
  const int npx = Ho * Wo;
  if (Cout <= 32 && groups == 1) {
    constexpr int TN = 32;
    const dim3 grid((npx + Tile<TN>::TM - 1) / Tile<TN>::TM, (Cout + TN - 1) / TN, B);
    int8_conv_kernel<TN><<<grid, kThreads, 0, s>>>(static_cast<const int8_t*>(x), cw, H, W, Cin,
                                                   Ho, Wo, relu, out_f32, out);
  } else {
    constexpr int TN = 64;
    if (groups > 1 && (Cout / groups) % TN != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((npx + Tile<TN>::TM - 1) / Tile<TN>::TM, (Cout + TN - 1) / TN, B);
    int8_conv_kernel<TN><<<grid, kThreads, 0, s>>>(static_cast<const int8_t*>(x), cw, H, W, Cin,
                                                   Ho, Wo, relu, out_f32, out);
  }
  SPE_RETURN_LAUNCH_STATUS();
}
