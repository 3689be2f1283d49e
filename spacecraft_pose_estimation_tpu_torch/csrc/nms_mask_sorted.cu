// K4: greedy NMS keep-mask over score-sorted boxes, many problems at once.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_nms.py,
// nms_mask_sorted_pallas / _nms_kernel (the semantics of ops/nms.nms_mask
// once sorted): box i suppresses box j != i when i is valid, not itself
// suppressed, and IoU(i, j) > threshold, with IoU 0 when the union is not
// positive (ops/boxes.pairwise_iou). The keep-mask is valid & !suppressed.
//
// Bound: latency, not bytes or operations. The work is at most N^2 / 2 IoUs
// of ~15 FLOP on 21 bytes per box, far below either roofline; the time is
// a launch, three block barriers, the overlaps of each valid row on the one
// SM of its problem, and the greedy walk's dependent steps. The serving
// calls are the RPN's 20 problems of 256 boxes and the box head's 4 of 64.
//
// Design: one block per problem (an image's pyramid level in the RPN, an
// image in the box head or in RetinaNet), N <= 8192, in two phases.
// 1. In parallel, with no order between them: for each valid row i and
//    each j > i, bit j of mask[i] is set when IoU(i, j) > threshold. mask
//    is N x ceil(N / 64) uint64 words in shared memory (8 KB at N = 256,
//    128 KB at 1,024) for N <= 1,024, the serving and evaluation calls.
//    Above that it does not fit an SM (512 KB at 2,048, where training's
//    RPN runs at N = 2,000; 2.49 MB at 4,441, RetinaNet's five levels at
//    800^2; 8 MB at 8,192), so it goes to a global workspace of the same
//    layout, which the wrapper allocates and L2 holds; the kernel is
//    otherwise the same. The tasks (column word wd, row i <= its last box)
//    are dealt to the warps in turn in column-major order; a warp keeps
//    its column's 64 boxes in registers (two per lane), reads each row's
//    box as a broadcast, and builds the word with two __ballot_sync. The
//    intersection and union are computed in the old kernel's operand order
//    (i the row box, fminf(xi1, x1[j]), ai + aj - inter), and the decision
//    RN(inter / u) > threshold, u = fmaxf(uni, 1e-12), is the old one bit
//    for bit: two exact residuals settle it without dividing (see
//    over_threshold). One __syncthreads.
// 2. One warp walks the boxes in order, a 64-box word at a time. Lane l
//    holds removed-words l, l + 32, l + 64 and l + 96 in registers, LW of
//    them (LW = ceil(W / 32), a template argument: 1 up to 2,048 boxes, 3
//    at 4,441, 4 at 8,192); the word's alive (valid, not removed) bits
//    reach every lane with one __shfl_sync. Box b of the word is kept iff
//    still alive when reached; then it clears its later boxes of the word
//    (its row's own word, the same for every lane) and each lane ORs its
//    row's words into those of its later words. The loop over b is
//    unrolled, so each bit test is a constant mask, and a row's loads do
//    not wait for the walk; the walk's chain is two register operations
//    per box, and a quarter of a word with no alive box is skipped. No
//    block barrier inside the walk.
// Shared memory: 21 bytes a box (box, area, valid flag) and the kept words,
// plus the mask up to 1,024 boxes: 173 KB at 8,192, under the 227 KB a
// block may have, which is what caps N there.
//
// Why the bits j > i are enough: if i is kept and a kept j < i had IoU(j, i)
// > threshold, j would have removed i, so a kept i removes no kept j < i;
// and marking a j < i that is not kept changes no keep bit. This needs
// IoU(i, j) == IoU(j, i) bit for bit, which holds for the formula as
// written: fminf, fmaxf and the sum ai + aj all commute.
#include "common.cuh"

namespace {

constexpr int kMaxBoxes = 8192;
constexpr int kMaxSmemBoxes = 1024;  // the largest N whose mask stays in shared memory
constexpr int kMaxWords = kMaxBoxes / 64;
constexpr int kMaxLaneWords = kMaxWords / 32;  // words a lane of the walking warp holds at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(int n, bool mask_in_smem) {
  // the boxes, mask (n x words) unless it is global, the kept words, the areas, the valid flags
  return (mask_in_smem ? static_cast<size_t>(n) * ((n + 63) / 64) * 8 : 0) + kMaxWords * 8 +
         static_cast<size_t>(n) * (sizeof(float4) + sizeof(float) + 1);
}

// Whether RN(inter / u) > t, for u > 0, as the old kernel decided it by
// dividing. fmaf(-t, u, inter) < 0 means inter < t * u exactly, so
// inter / u < t and it rounds to at most t; fmaf(-t_up, u, inter) > 0, with
// t_up the next float above t, means inter / u > t_up, so it rounds to at
// least t_up. Only in between, or on a NaN, is the division needed.
__device__ __forceinline__ bool over_threshold(float inter, float u, float t, float t_up) {
  if (fmaf(-t, u, inter) < 0.f) return false;
  if (fmaf(-t_up, u, inter) > 0.f) return true;
  return inter / u > t;
}

template <int LW>
__global__ void __launch_bounds__(1024)
nms_mask_sorted_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                       bool* __restrict__ keep, uint64_t* gmask, int N, float threshold) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int W = (N + 63) / 64;
  float4* box = reinterpret_cast<float4*>(smem);  // (N,) x0, y0, x1, y1
  // mask (N, W): in shared memory after the boxes, or this problem's slice of gmask
  uint64_t* mask = gmask ? gmask + static_cast<size_t>(blockIdx.x) * N * W
                         : reinterpret_cast<uint64_t*>(box + N);
  uint64_t* kept_s = gmask ? reinterpret_cast<uint64_t*>(box + N)
                           : mask + static_cast<size_t>(N) * W;  // (kMaxWords,)
  float* area = reinterpret_cast<float*>(kept_s + kMaxWords);
  uint8_t* v = reinterpret_cast<uint8_t*>(area + N);

  const int64_t base = static_cast<int64_t>(blockIdx.x) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float* b = boxes + (base + j) * 4;
    box[j] = make_float4(b[0], b[1], b[2], b[3]);
    area[j] = fmaxf(b[2] - b[0], 0.f) * fmaxf(b[3] - b[1], 0.f);
    v[j] = valid[base + j];
  }
  __syncthreads();

  // phase 1: task (wd, i) builds mask[i][wd]; column wd holds the rows
  // i < min(N, 64 (wd + 1)), whose words from their own on are needed.
  // Warp w takes tasks w, w + nwarps, ... in column-major order, so the
  // valid rows, which the score sort puts first, spread over the warps.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float t_up = nextafterf(threshold, __int_as_float(0x7f800000));  // toward +inf
  const bool zero_over = 0.f > threshold;  // the decision where the union is not positive
  float4 bj[2];
  float aj[2];
  int jj[2];
  for (int wd = -1, rows = 0, i = warp;; i += nwarps) {
    if (i >= rows) {  // into a later column: its boxes into registers
      do {
        i -= rows;
        rows = min(N, 64 * (++wd + 1));
      } while (wd < W && i >= rows);
      if (wd >= W) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        jj[hh] = wd * 64 + hh * 32 + lane;
        const int jc = min(jj[hh], N - 1);
        bj[hh] = box[jc];
        aj[hh] = area[jc];
      }
    }
    if (!v[i]) continue;  // warp-uniform; the walk never reads an invalid row
    const float4 bi = box[i];
    const float ai = area[i];
    uint32_t half[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float iw = fmaxf(fminf(bi.z, bj[hh].z) - fmaxf(bi.x, bj[hh].x), 0.f);
      const float ih = fmaxf(fminf(bi.w, bj[hh].w) - fmaxf(bi.y, bj[hh].y), 0.f);
      const float inter = iw * ih;
      const float uni = ai + aj[hh] - inter;
      const bool over = uni > 0.f ? over_threshold(inter, fmaxf(uni, 1e-12f), threshold, t_up) : zero_over;
      half[hh] = __ballot_sync(kFull, over && jj[hh] > i && jj[hh] < N);
    }
    if (lane == 0) mask[static_cast<size_t>(i) * W + wd] = half[0] | (static_cast<uint64_t>(half[1]) << 32);
  }
  __syncthreads();

  // phase 2: one warp walks the boxes in order, a word at a time
  if (warp == 0) {
    uint64_t removed[LW], kept[LW];  // lane l, slot s: word l + 32 s
    int wl[LW];  // the words a lane ORs in; past the row's last, its last one, unused
#pragma unroll
    for (int s = 0; s < LW; ++s) {
      removed[s] = kept[s] = 0;
      wl[s] = min(lane + 32 * s, W - 1);
    }
    for (int wd = 0; wd < W; ++wd) {
      const int j = wd * 64 + lane;
      const uint64_t lo = __ballot_sync(kFull, j < N && v[j]);
      const uint64_t hi = __ballot_sync(kFull, j + 32 < N && v[j + 32]);
      const int ws = wd >> 5;  // the slot of word wd, the same in every lane
      uint64_t removed_wd = 0;
#pragma unroll
      for (int s = 0; s < LW; ++s)
        if (s == ws) removed_wd = removed[s];
      uint64_t alive = (lo | (hi << 32)) & ~__shfl_sync(kFull, removed_wd, wd & 31);
      const int last = min(64, N - wd * 64) - 1;  // rows past it are not there: their bits are 0
#pragma unroll
      for (int q = 0; q < 64; q += 16) {
        if (!(alive >> q & 0xffffull)) continue;  // no alive box in this quarter of the word
#pragma unroll
        for (int b = q; b < q + 16; ++b) {
          // row i = 64 wd + b holds bits j > i only, in its words wd..W-1
          const uint64_t* row = mask + static_cast<size_t>(wd * 64 + min(b, last)) * W;
          const uint64_t own = row[wd];
          uint64_t mine[LW];
#pragma unroll
          for (int s = 0; s < LW; ++s) mine[s] = row[wl[s]];
          if (alive & (1ull << b)) {  // the same in every lane
            alive &= ~own;
#pragma unroll
            for (int s = 0; s < LW; ++s)
              if (lane + 32 * s > wd) removed[s] |= mine[s];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < LW; ++s)
        if (s == ws && lane == (wd & 31)) kept[s] = alive;
    }
#pragma unroll
    for (int s = 0; s < LW; ++s)
      if (lane + 32 * s < W) kept_s[lane + 32 * s] = kept[s];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < N; j += blockDim.x)
    keep[base + j] = (kept_s[j >> 6] >> (j & 63)) & 1;
}

template <int LW>
cudaError_t launch(const void* boxes, const void* valid, void* keep, void* workspace, int P, int N,
                   float threshold, cudaStream_t stream) {
  const bool in_smem = N <= kMaxSmemBoxes;
  // the most shared memory any call asks for: the mask of 1,024 boxes, or the boxes of 8,192
  constexpr size_t most = smem_bytes(kMaxSmemBoxes, true) > smem_bytes(kMaxBoxes, false)
                              ? smem_bytes(kMaxSmemBoxes, true) : smem_bytes(kMaxBoxes, false);
  static_assert(most <= 232448, "more shared memory than a block may have");
  static const cudaError_t attr = cudaFuncSetAttribute(
      nms_mask_sorted_kernel<LW>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
  if (attr != cudaSuccess) return attr;
  // a warp per 8 rows, at most 32 warps
  const int threads = 32 * min(32, (N + 7) / 8);
  nms_mask_sorted_kernel<LW><<<P, threads, smem_bytes(N, in_smem), stream>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<bool*>(keep), in_smem ? nullptr : static_cast<uint64_t*>(workspace), N, threshold);
  return cudaSuccess;
}

}  // namespace

// boxes: (P, N, 4) f32 XYXY, each problem sorted by descending score;
// valid: (P, N) bool; keep: (P, N) bool. All contiguous. workspace: for
// N > 1024, P x N x ceil(N / 64) uint64 words of global memory, 8-byte
// aligned (its contents need not be set); unused, and may be null, below.
extern "C" int nms_mask_sorted(const void* boxes, const void* valid, void* keep, void* workspace,
                               int P, int N, float threshold, void* stream) {
  if (P == 0 || N == 0) return 0;
  if (N > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  if (N > kMaxSmemBoxes && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lane_words = ((N + 63) / 64 + 31) / 32;
  static_assert(kMaxLaneWords == 4, "one instantiation a lane-word count");
  const cudaError_t err =
      lane_words == 1 ? launch<1>(boxes, valid, keep, workspace, P, N, threshold, s)
      : lane_words == 2 ? launch<2>(boxes, valid, keep, workspace, P, N, threshold, s)
      : lane_words == 3 ? launch<3>(boxes, valid, keep, workspace, P, N, threshold, s)
                        : launch<4>(boxes, valid, keep, workspace, P, N, threshold, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  SPE_RETURN_LAUNCH_STATUS();
}
