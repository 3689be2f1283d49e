// K5a: one int8 convolution with its requant epilogue (the per-op int8 site).
//
// Replaces the XLA int8 convs of the JAX package's int8 walks:
// models/hrnet_int8.py _Int8Ops.convbn / final and models/backbone_int8.py
// _conv_i8 (jax.lax.conv_general_dilated with preferred_element_type=int32,
// then f = y * m + b).
//
// x (B, H, W, Cin) int8 NHWC; wk (Cout, k, k, Cin / groups) int8, the
// K-major copy of the HWIO weights that the model packs once when it is
// built; m, b (Cout,) f32. out (B, Ho, Wo, Cout) is int8
// clip(rint(relu?(f)), -127, 127) or, with out_f32, f32 relu?(f).
// Grid: (pixel tiles, channel tiles, B); one 256-thread block per tile of
// 128 output pixels x TN channels, TN = 32 for Cout <= 32, 64 for
// Cout <= 64, else 128 (a grouped conv takes the widest of them that
// divides its output channels per group).
//
// Bound: bytes. Over the 146 sites of a served clip (R101's 104 over
// 4 x 768^2 images, HRNet-W32's 42 over 16 x 512^2 crops) moving each
// activation, weight and output once at 3.35 TB/s takes longer than their
// int8 operations at the tensor cores' 1,979 TOP/s (chip_smoke.py computes
// both from the served inputs). The design: the conv body of int8_mma.cuh, wgmma
// on the int8 tensor cores fed by a ring of 16-byte cp.async copies, the
// weights read as they lie (K-major, 16 bytes a copy), the outputs stored
// 16 bytes a thread. The kernel's first body (dp4a on the CUDA cores, no
// overlap of loads and arithmetic, weights gathered a byte at a time) sat
// at 3.5% of the bound.
#include "int8_mma.cuh"

namespace {

using namespace spe_i8;

template <int TN, bool V16, bool F32>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, ConvW cw, int H, int W, int Cin, int Ho, int Wo,
                 int relu, void* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int img = blockIdx.z;
  const Src s{x + static_cast<int64_t>(img) * H * W * Cin, 0, H, W, Cin};
  const int npx = Ho * Wo;
  const int64_t out_off = static_cast<int64_t>(img) * npx * cw.cout;
  if constexpr (F32) {
    const StoreF32 epi{cw, {static_cast<float*>(out) + out_off, 0, 0, Wo, cw.cout}, relu != 0};
    conv_tile_mma<TN, V16>(s, cw, Region{0, 0, Wo, npx}, blockIdx.x, blockIdx.y, smem, epi);
  } else {
    const StoreRq epi{cw, {static_cast<int8_t*>(out) + out_off, 0, 0, Wo, cw.cout}, relu != 0};
    conv_tile_mma<TN, V16>(s, cw, Region{0, 0, Wo, npx}, blockIdx.x, blockIdx.y, smem, epi);
  }
}

template <int TN, bool V16, bool F32>
int launch(const int8_t* x, const ConvW& cw, int B, int H, int W, int Cin, int Ho, int Wo, int relu,
           void* out, cudaStream_t s) {
  constexpr int smem = MmaCfg<TN>::kSmemBytes;
  if (const int err = allow_smem<int8_conv_kernel<TN, V16, F32>>(smem)) return err;
  const dim3 grid((Ho * Wo + kTM - 1) / kTM, (cw.cout + TN - 1) / TN, B);
  int8_conv_kernel<TN, V16, F32><<<grid, kThreads, smem, s>>>(x, cw, H, W, Cin, Ho, Wo, relu, out);
  SPE_RETURN_LAUNCH_STATUS();
}

template <int TN>
int launch_tn(bool v16, bool f32, const int8_t* x, const ConvW& cw, int B, int H, int W, int Cin,
              int Ho, int Wo, int relu, void* out, cudaStream_t s) {
  if (v16) {
    return f32 ? launch<TN, true, true>(x, cw, B, H, W, Cin, Ho, Wo, relu, out, s)
               : launch<TN, true, false>(x, cw, B, H, W, Cin, Ho, Wo, relu, out, s);
  }
  return f32 ? launch<TN, false, true>(x, cw, B, H, W, Cin, Ho, Wo, relu, out, s)
             : launch<TN, false, false>(x, cw, B, H, W, Cin, Ho, Wo, relu, out, s);
}

}  // namespace

extern "C" int int8_conv_requant(const void* x, const void* wk, const void* m, const void* b,
                                 void* out, int B, int H, int W, int Cin, int Ho, int Wo,
                                 int Cout, int k, int stride, int groups, int relu, int out_f32,
                                 void* stream) {
  if (B == 0 || Ho * Wo == 0 || Cout == 0) return 0;
  if (Cin % 4 != 0 || groups < 1 || Cin % groups != 0 || (Cin / groups) % 4 != 0 || Cout % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cin_g = Cin / groups, cout_g = Cout / groups;
  int tn = mma_tile_n(Cout);
  if (groups > 1) {
    tn = cout_g % 128 == 0 ? 128 : cout_g % 64 == 0 ? 64 : cout_g % 32 == 0 ? 32 : 0;
    if (tn == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool v16 = cin_g % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wk) % 16 == 0;
  const ConvW cw{static_cast<const int8_t*>(wk), static_cast<const float*>(m),
                 static_cast<const float*>(b), k, stride, cin_g, Cout, groups};
  const auto* xp = static_cast<const int8_t*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0;
  switch (tn) {
    case 32: return launch_tn<32>(v16, f32, xp, cw, B, H, W, Cin, Ho, Wo, relu, out, s);
    case 64: return launch_tn<64>(v16, f32, xp, cw, B, H, W, Cin, Ho, Wo, relu, out, s);
    default: return launch_tn<128>(v16, f32, xp, cw, B, H, W, Cin, Ho, Wo, relu, out, s);
  }
}
