// K6 / K6s: HRNet layer1, a chain of int8 Bottlenecks, in one launch.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_blocks.py,
// fused_bottleneck_chain / _bottleneck_chain_kernel and
// fused_bottleneck_chain_strips / _bottleneck_strip_kernel. The two compute
// one function (the strips are how the TPU stays inside VMEM); here `strip`
// is a launch parameter of one kernel. Per block, with the walk's rounding
// points (models/hrnet_int8.py _forward, layer1):
//   t1 = rq(relu(conv1x1(x, w1[blk]) * m1 + b1))
//   t2 = rq(relu(conv3x3(t1, w2[blk]) * m2 + b2))
//   r  = blk == 0 ? rq(conv1x1(x, wd) * md + bd) : x      (projection shortcut)
//   x  = rq(relu(rq(conv1x1(t2, w3[blk]) * m3 + b3) * c0 + r * c1))
// Block 0 reads Cin0 input channels (w1 is packed to the widest input and
// only its first Cin0 rows are read), the others Cout.
//
// A layer1 image is 128 x 128 x 256 int8 at the serving shapes (4 MB), so
// the chain is tiled by rows: each strip of `strip` output rows starts from
// its input rows widened by one halo row per 3x3 conv (nblocks in all), and
// is worked on by a cluster of kCluster blocks that deal each conv's tiles
// among themselves and meet at a cluster barrier between convs. The band's
// running activation (Cout channels) and the two Cm-channel intermediates
// live in a global workspace.
//
// Bound: operations at the serving shapes; see int8_conv_requant.cu.
#include "int8_common.cuh"

namespace {

using namespace spe_i8;

constexpr int kCluster = 8;

struct BottleneckArgs {
  const int8_t* x;
  const int8_t *w1, *w2, *w3, *wd;    // (n, cin_max, cm), (n, 3, 3, cm, cm), (n, cm, cout), (cin0, cout)
  const float *m1, *b1, *m2, *b2, *m3, *b3, *md, *bd;
  const float* coeffs;                // (n, 2)
  int8_t* out;
  int8_t* work;                       // (B, strips, band, W, cout + 2 * cm)
  int H, W, cin0, cin_max, cm, cout, nblocks, strip, band;
};

__global__ void __launch_bounds__(kThreads)
bottleneck_chain_kernel(BottleneckArgs a) {
  __shared__ Smem<64> sm;
  const int rank = blockIdx.x % kCluster;
  const int strip = blockIdx.x / kCluster;
  const int strips = gridDim.x / kCluster;
  const int img = blockIdx.y;
  const int H = a.H, W = a.W, cm = a.cm, cout = a.cout, n = a.nblocks;
  const int r0 = strip * a.strip, r1 = min(H, r0 + a.strip);
  const int base = max(0, r0 - n);
  const int64_t band_px = static_cast<int64_t>(a.band) * W;
  int8_t* X = a.work + (static_cast<int64_t>(img) * strips + strip) * band_px * (cout + 2 * cm);
  int8_t* T1 = X + band_px * cout;
  int8_t* T2 = T1 + band_px * cm;
  const Src x_in{a.x + static_cast<int64_t>(img) * H * W * a.cin0, 0, H, W, a.cin0};
  const Src xs{X, base, H, W, cout};
  const Src t1{T1, base, H, W, cm};
  const Src t2{T2, base, H, W, cm};

  for (int blk = 0; blk < n; ++blk) {
    const Src in{blk == 0 ? x_in.p : X, blk == 0 ? 0 : base, H, W, blk == 0 ? a.cin0 : cout};
    const int cin = in.C;
    const int h1 = n - blk;  // conv1's rows: the block's output rows + 1 halo row
    const int lo1 = max(0, r0 - h1), hi1 = min(H, r1 + h1);
    const int lo2 = max(0, r0 - h1 + 1), hi2 = min(H, r1 + h1 - 1);
    const ConvW c1{a.w1 + static_cast<int64_t>(blk) * a.cin_max * cm, a.m1 + blk * cm,
                   a.b1 + blk * cm, 1, 1, cin, cm, 1};
    const StoreRq e1{c1, {T1, base, 0, W, cm}, true};
    conv_rows<64>(in, c1, lo1, hi1, W, rank, kCluster, sm, e1);
    if (blk == 0) {  // projection shortcut -> X, over the block's output rows
      const ConvW cd{a.wd, a.md, a.bd, 1, 1, a.cin0, cout, 1};
      const StoreRq ed{cd, {X, base, 0, W, cout}, false};
      conv_rows<64>(x_in, cd, lo2, hi2, W, rank, kCluster, sm, ed);
    }
    cluster_barrier();
    const ConvW c2{a.w2 + static_cast<int64_t>(blk) * 9 * cm * cm, a.m2 + blk * cm,
                   a.b2 + blk * cm, 3, 1, cm, cm, 1};
    const StoreRq e2{c2, {T2, base, 0, W, cm}, true};
    conv_rows<64>(t1, c2, lo2, hi2, W, rank, kCluster, sm, e2);
    cluster_barrier();
    const ConvW c3{a.w3 + static_cast<int64_t>(blk) * cm * cout, a.m3 + blk * cout,
                   a.b3 + blk * cout, 1, 1, cm, cout, 1};
    const bool last = blk == n - 1;
    const Dst<int8_t> d3{last ? a.out + static_cast<int64_t>(img) * H * W * cout : X, last ? 0 : base, 0,
                         W, cout};
    const StoreResidualAdd e3{c3, xs, d3, a.coeffs[2 * blk], a.coeffs[2 * blk + 1]};
    conv_rows<64>(t2, c3, lo2, hi2, W, rank, kCluster, sm, e3);
    cluster_barrier();
  }
}

}  // namespace

// x (B, H, W, cin0) int8 -> out (B, H, W, cout) int8. work: B * ceil(H / strip)
// * band * W * (cout + 2 * cm) int8 with band = min(H, strip + 2 * nblocks).
extern "C" int bottleneck_chain(const void* x, const void* w1, const void* m1, const void* b1,
                                const void* w2, const void* m2, const void* b2, const void* w3,
                                const void* m3, const void* b3, const void* wd, const void* md,
                                const void* bd, const void* coeffs, void* out, void* work, int B,
                                int H, int W, int cin0, int cin_max, int cm, int cout,
                                int nblocks, int strip, void* stream) {
  if (B == 0 || H == 0 || W == 0 || nblocks == 0) return 0;
  if (cin0 % 4 != 0 || cm % 4 != 0 || cout % 4 != 0 || strip < 1 ||
      (nblocks > 1 && cin_max < cout) || cin_max < cin0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BottleneckArgs a{
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const int8_t*>(wd), static_cast<const float*>(m1),
      static_cast<const float*>(b1), static_cast<const float*>(m2),
      static_cast<const float*>(b2), static_cast<const float*>(m3),
      static_cast<const float*>(b3), static_cast<const float*>(md),
      static_cast<const float*>(bd), static_cast<const float*>(coeffs),
      static_cast<int8_t*>(out), static_cast<int8_t*>(work), H, W, cin0, cin_max, cm, cout,
      nblocks, strip, min(H, strip + 2 * nblocks)};
  const dim3 grid(kCluster * ((H + strip - 1) / strip), B);
  return launch_clustered(bottleneck_chain_kernel, grid, kCluster, static_cast<cudaStream_t>(stream), a);
}
