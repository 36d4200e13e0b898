// Exact (greedy) NMS keep mask over score-sorted boxes: a bitmask NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel super_gradients_tpu/ops/pallas/nms_kernel.py::pallas_exact_nms_keep
// and the K-step XLA loop super_gradients_tpu/ops/nms.py::_exact_keep_mask, which computes
// the same thing:
//
//   keep[i] = valid[i] && !any_{j<i}(keep[j] && IoU(i, j) > t)
//   IoU(i, j) = inter / (area_i + area_j - inter + 1e-9), widths, heights and areas clamped at 0
//
// Inputs: boxes [B, K, 4] fp32 xyxy (class-offset, score-descending), valid [B, K] uint8.
// Output: keep [B, K] uint8 (0/1). Scratch: mask [B, K, ceil(K/64)] uint64. Any K >= 1.
//
// Pass 1 (nms_mask_kernel) builds the suppression bitmask. Grid (ceil(K/64), ceil(K/64), B),
// 64 threads. A block stages its 64 column boxes in shared memory; thread i writes one 64-bit
// word of row i, with bit j set where j > i and IoU(i, j) > t. Blocks below the diagonal hold
// no such bit and return at once (the sweep never reads their words). That is about K*K/2 IoUs
// per image, 4e6 for B=8 at K=1024: ALU-bound and small.
//
// Pass 2 (nms_sweep_kernel) is the greedy sweep: one warp per image walks i in order, so it is
// latency-bound, one dependent read of a mask row per kept box. The `removed` bit vector lives
// in shared memory; lane l owns words l, l+32, ... Nothing carries over between images, so the
// batch rides the grid of both passes.
//
// Bit-equality with the plain PyTorch version at IoU == t needs IEEE fp32 with no FMA
// contraction: the IoU is written with round-to-nearest intrinsics, and the build passes
// --fmad=false as well. Never build this file with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // boxes per tile = bits per mask word

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ p) {
  return Box{p[0], p[1], p[2], p[3]};
}

__device__ __forceinline__ float area_rn(const Box& a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.x2, a.x1), 0.0f), fmaxf(__fsub_rn(a.y2, a.y1), 0.0f));
}

// Same operation order as ops/bbox.py::box_iou: (area_a + area_b - inter) + eps.
__device__ __forceinline__ float iou_rn(const Box& a, const Box& b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_rn(a), area_rn(b)), inter), 1e-9f);
  return __fdiv_rn(inter, denom);
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, int K, int nwords, float iou_threshold,
                unsigned long long* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;  // every bit here has j < i
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* img = boxes + (size_t)b * K * 4;

  __shared__ Box cols[kTile];
  const int col0 = col_tile * kTile;
  const int ncols = min(K - col0, kTile);
  if (tid < ncols) cols[tid] = load_box(img + (size_t)(col0 + tid) * 4);
  __syncthreads();

  const int row = row_tile * kTile + tid;
  if (row >= K) return;
  const Box mine = load_box(img + (size_t)row * 4);
  unsigned long long bits = 0ULL;
  for (int j = (col_tile == row_tile) ? tid + 1 : 0; j < ncols; ++j) {
    if (iou_rn(mine, cols[j]) > iou_threshold) bits |= 1ULL << j;
  }
  mask[((size_t)b * K + row) * nwords + col_tile] = bits;
}

__global__ void __launch_bounds__(32)
nms_sweep_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int K, int nwords) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* rows = mask + (size_t)b * K * nwords;
  const uint8_t* v = valid + (size_t)b * K;
  uint8_t* out = keep + (size_t)b * K;

  for (int w = lane; w < nwords; w += 32) removed[w] = 0ULL;
  __syncwarp();
  for (int i = 0; i < K; ++i) {
    const int wi = i >> 6;
    const bool kept = v[i] && !((removed[wi] >> (i & 63)) & 1ULL);
    __syncwarp();
    if (kept) {
      // row i only has bits j > i, so words below wi are left alone
      const unsigned long long* row = rows + (size_t)i * nwords;
      for (int w = wi + lane; w < nwords; w += 32) removed[w] |= row[w];
    }
    if (lane == 0) out[i] = kept ? 1 : 0;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success).
int sg_nms_exact_keep(const float* boxes, const uint8_t* valid, uint8_t* keep,
                      unsigned long long* mask, int B, int K, float iou_threshold, void* stream) {
  const int nwords = (K + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nwords, nwords, B), kTile, 0, s>>>(boxes, K, nwords, iou_threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<B, 32, nwords * sizeof(unsigned long long), s>>>(mask, valid, keep, K, nwords);
  return static_cast<int>(cudaGetLastError());
}

const char* sg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
