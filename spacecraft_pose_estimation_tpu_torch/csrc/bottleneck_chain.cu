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
// Block 0 reads Cin0 input channels, the others Cout.
//
// A layer1 image is 128 x 128 x 256 int8 at the serving shapes (4 MB), so
// the chain is tiled by rows: each strip of `strip` output rows starts from
// its input rows widened by one halo row per 3x3 conv (nblocks in all), and
// is worked on by a cluster of kCluster blocks that deal each conv's tiles
// among themselves and meet at a cluster barrier between convs. The band's
// running activation (Cout channels) and the two Cm-channel intermediates
// live in a global workspace, one band per strip.
//
// Bound: operations at the serving shapes (2 * (Cin0 Cm + 9 Cm^2 + Cm Cout
// + Cin0 Cout) int8 ops per pixel for block 0 against 64 + 256 bytes in and
// out). Every conv runs the tensor-core body of int8_mma.cuh: 128-pixel
// tiles, TN = 64 channels for the Cm-wide conv1 and conv2, TN = 128 for the
// Cout-wide conv3 (with the residual add) and the projection, wgmma on the
// int8 tensor cores over a ring of cp.async.cg copies (L2, never L1: the
// other blocks of the cluster wrote the band). One dynamic shared-memory
// buffer sized for the widest tile serves both widths (2 blocks per SM).
// At Cm = 64 a 1x1 tile is one or two ring stages (K = 64 or 256), so a
// tile's time is its copies' latency and its epilogue, not its multiply.
// The weights are K-major (the model packs them once): w1 holds each
// block's (Cm, Cin) matrix in turn at that block's own Cin (block 0 at
// offset 0, block k >= 1 at Cm (Cin0 + (k - 1) Cout)), so every 1x1 reads
// rows of exactly its K, with no padding to the widest input.
// The workspace is B * strips * band * W * (Cout + 2 Cm) bytes, 126 MB at
// the serving shapes with 32-row strips: more than the 50 MB of L2, so the
// bands of the ~33 clusters resident at once (2 blocks per SM) spill to
// device memory. On the card that costs little: clusters that walked the
// strips in turn, in bands that fit L2, were hardly faster, and were much
// slower wherever they left SMs idle, so every strip keeps its own band.
#include "int8_mma.cuh"

namespace {

using namespace spe_i8;

constexpr int kCluster = 8;
constexpr int kTnMid = 64;   // conv1, conv2: Cm output channels
constexpr int kTnOut = 128;  // conv3, the projection: Cout output channels
constexpr int kSmem = MmaCfg<kTnOut>::kSmemBytes;

struct BottleneckArgs {
  const int8_t* x;
  const int8_t *w1, *w2, *w3, *wd;    // K-major: see above; (n, cm, 3, 3, cm); (n, cout, cm); (cout, cin0)
  const float *m1, *b1, *m2, *b2, *m3, *b3, *md, *bd;
  const float* coeffs;                // (n, 2)
  int8_t* out;
  int8_t* work;                       // (B, strips, band, W, cout + 2 * cm)
  int H, W, cin0, cm, cout, nblocks, strip, band;
};

template <bool V16>
__global__ void __launch_bounds__(kThreads)
bottleneck_chain_kernel(BottleneckArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
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
    const int h1 = n - blk;  // conv1's rows: the block's output rows + 1 halo row
    const int lo1 = max(0, r0 - h1), hi1 = min(H, r1 + h1);
    const int lo2 = max(0, r0 - h1 + 1), hi2 = min(H, r1 + h1 - 1);
    const int64_t w1_off = blk == 0 ? 0 : static_cast<int64_t>(cm) * (a.cin0 + (blk - 1) * cout);
    const ConvW c1{a.w1 + w1_off, a.m1 + blk * cm, a.b1 + blk * cm, 1, 1, in.C, cm, 1, 0, 0};
    const StoreRq e1{c1, {T1, base, 0, W, cm}, true};
    conv_rows_mma<kTnMid, V16>(in, c1, lo1, hi1, W, rank, kCluster, smem, e1);
    if (blk == 0) {  // projection shortcut -> X, over the block's output rows
      const ConvW cd{a.wd, a.md, a.bd, 1, 1, a.cin0, cout, 1, 0, 0};
      const StoreRq ed{cd, {X, base, 0, W, cout}, false};
      conv_rows_mma<kTnOut, V16>(x_in, cd, lo2, hi2, W, rank, kCluster, smem, ed);
    }
    cluster_barrier();
    const ConvW c2{a.w2 + static_cast<int64_t>(blk) * 9 * cm * cm, a.m2 + blk * cm,
                   a.b2 + blk * cm, 3, 1, cm, cm, 1, 1, 1};
    const StoreRq e2{c2, {T2, base, 0, W, cm}, true};
    conv_rows_mma<kTnMid, V16>(t1, c2, lo2, hi2, W, rank, kCluster, smem, e2);
    cluster_barrier();
    const ConvW c3{a.w3 + static_cast<int64_t>(blk) * cm * cout, a.m3 + blk * cout,
                   a.b3 + blk * cout, 1, 1, cm, cout, 1, 0, 0};
    const bool last = blk == n - 1;
    const Dst<int8_t> d3{last ? a.out + static_cast<int64_t>(img) * H * W * cout : X, last ? 0 : base, 0,
                         W, cout};
    const StoreResidualAdd e3{c3, xs, d3, a.coeffs[2 * blk], a.coeffs[2 * blk + 1]};
    conv_rows_mma<kTnOut, V16>(t2, c3, lo2, hi2, W, rank, kCluster, smem, e3);
    cluster_barrier();
  }
}

template <bool V16>
int launch(dim3 grid, cudaStream_t s, const BottleneckArgs& a) {
  if (const int err = allow_smem<bottleneck_chain_kernel<V16>>(kSmem)) return err;
  return launch_clustered(bottleneck_chain_kernel<V16>, grid, kCluster, s, a, kSmem);
}

}  // namespace

// x (B, H, W, cin0) int8 -> out (B, H, W, cout) int8. K-major weights: w1
// cm * (cin0 + (nblocks - 1) * cout) int8, each block's (cm, cin) in turn;
// w2 (n, cm, 3, 3, cm); w3 (n, cout, cm); wd (cout, cin0). work: B *
// ceil(H / strip) * band * W * (cout + 2 * cm) int8 with band = min(H,
// strip + 2 * nblocks).
extern "C" int bottleneck_chain(const void* x, const void* w1, const void* m1, const void* b1,
                                const void* w2, const void* m2, const void* b2, const void* w3,
                                const void* m3, const void* b3, const void* wd, const void* md,
                                const void* bd, const void* coeffs, void* out, void* work, int B,
                                int H, int W, int cin0, int cm, int cout, int nblocks, int strip,
                                void* stream) {
  if (B == 0 || H == 0 || W == 0 || nblocks == 0) return 0;
  if (cin0 % 4 != 0 || cm % 4 != 0 || cout % 4 != 0 || strip < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BottleneckArgs a{
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const int8_t*>(wd), static_cast<const float*>(m1),
      static_cast<const float*>(b1), static_cast<const float*>(m2),
      static_cast<const float*>(b2), static_cast<const float*>(m3),
      static_cast<const float*>(b3), static_cast<const float*>(md),
      static_cast<const float*>(bd), static_cast<const float*>(coeffs),
      static_cast<int8_t*>(out), static_cast<int8_t*>(work), H, W, cin0, cm, cout,
      nblocks, strip, min(H, strip + 2 * nblocks)};
  const dim3 grid(kCluster * ((H + strip - 1) / strip), B);
  auto s = static_cast<cudaStream_t>(stream);
  const bool v16 = cin0 % 16 == 0 && cm % 16 == 0 && cout % 16 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(w2) && aligned16(w3) && aligned16(wd) && aligned16(out) && aligned16(work);
  return v16 ? launch<true>(grid, s, a) : launch<false>(grid, s, a);
}
