// K4: greedy NMS keep-mask over score-sorted boxes, many problems at once.
//
// Replaces spacecraft_pose_estimation_tpu/ops/pallas_nms.py,
// nms_mask_sorted_pallas / _nms_kernel (the semantics of ops/nms.nms_mask
// once sorted): box i suppresses box j != i when i is valid, not itself
// suppressed, and IoU(i, j) > threshold, with IoU 0 when the union is not
// positive (ops/boxes.pairwise_iou). The keep-mask is valid & !suppressed.
//
// One block per problem (an image's pyramid level in the RPN, an image in
// the box head), N <= 1024 boxes. The boxes, their areas and the suppressed
// flags live in shared memory; the loop over i is sequential with one
// __syncthreads per step, and a step whose box i is not kept costs only the
// barrier. Threads stride over j.
//
// Bound: latency. The work is (kept boxes) x N IoUs of ~15 FLOP on 21 bytes
// per box, far below either roofline; the N dependent steps with a block
// barrier each are what the time is made of.
#include "common.cuh"

namespace {

__global__ void nms_mask_sorted_kernel(const float* __restrict__ boxes,
                                       const uint8_t* __restrict__ valid,
                                       uint8_t* __restrict__ keep, int N, float threshold) {
  extern __shared__ float smem[];
  float* bx0 = smem;
  float* by0 = bx0 + N;
  float* bx1 = by0 + N;
  float* by1 = bx1 + N;
  float* area = by1 + N;
  int* suppressed = reinterpret_cast<int*>(area + N);
  uint8_t* v = reinterpret_cast<uint8_t*>(suppressed + N);

  const int64_t base = static_cast<int64_t>(blockIdx.x) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float* b = boxes + (base + j) * 4;
    bx0[j] = b[0];
    by0[j] = b[1];
    bx1[j] = b[2];
    by1[j] = b[3];
    area[j] = fmaxf(b[2] - b[0], 0.f) * fmaxf(b[3] - b[1], 0.f);
    suppressed[j] = 0;
    v[j] = valid[base + j];
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    // suppressed[i] was final at the last barrier, and no thread writes it
    // in this step (j != i), so every thread takes the same branch.
    if (v[i] && !suppressed[i]) {
      const float xi0 = bx0[i], yi0 = by0[i], xi1 = bx1[i], yi1 = by1[i], ai = area[i];
      for (int j = threadIdx.x; j < N; j += blockDim.x) {
        if (j == i) continue;
        const float iw = fmaxf(fminf(xi1, bx1[j]) - fmaxf(xi0, bx0[j]), 0.f);
        const float ih = fmaxf(fminf(yi1, by1[j]) - fmaxf(yi0, by0[j]), 0.f);
        const float inter = iw * ih;
        const float uni = ai + area[j] - inter;
        const float iou = uni > 0.f ? inter / fmaxf(uni, 1e-12f) : 0.f;
        if (iou > threshold) suppressed[j] = 1;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < N; j += blockDim.x)
    keep[base + j] = static_cast<uint8_t>(v[j] && !suppressed[j]);
}

}  // namespace

// boxes: (P, N, 4) f32 XYXY, each problem sorted by descending score;
// valid, keep: (P, N) uint8 (0/1). All contiguous.
extern "C" int nms_mask_sorted(const void* boxes, const void* valid, void* keep, int P, int N,
                               float threshold, void* stream) {
  if (P == 0 || N == 0) return 0;
  const size_t smem = static_cast<size_t>(N) * (5 * sizeof(float) + sizeof(int) + 1);
  if (N > 1024 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  nms_mask_sorted_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), N, threshold);
  SPE_RETURN_LAUNCH_STATUS();
}
