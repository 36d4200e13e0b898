// Exact (greedy) NMS keep mask over score-sorted boxes: a blocked bitmask NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel super_gradients_tpu/ops/pallas/nms_kernel.py::pallas_exact_nms_keep
// (pl.pallas_call at :93) and the K-step XLA loop super_gradients_tpu/ops/nms.py::_exact_keep_mask,
// which compute the same thing:
//
//   keep[i] = valid[i] && !any_{j<i}(keep[j] && IoU(i, j) > t)
//   IoU(i, j) = inter / (area_i + area_j - inter + 1e-9), widths, heights and areas clamped at 0
//
// Inputs: boxes [B, K, 4] fp32 xyxy (class-offset, score-descending), valid [B, K] uint8.
// Output: keep [B, K] uint8 (0/1). Scratch: mask [B, ceil(K/64), K] uint64. Any K >= 1.
//
// What bounds it. Greedy NMS needs the IoUs of the pairs j < i among the valid boxes, about 13
// fp32 operations each once areas are computed once per box: B*n(n-1)/2 IoUs for n valid boxes,
// 54.5 MFLOP at B=8, K=n=1024, or 0.81 us at the H100's 67 TFLOP/s fp32 (3.26 us at B=32). The
// bytes (boxes and valid in, keep out: 147 KB at B=8) take 0.04 us, so the work is bound by
// operations. The recurrence adds a serial floor: K dependent decisions, a few cycles each when
// they run on registers, about 2 us at K=1024.
//
// Pass 1 (nms_mask_kernel) writes the suppression bitmask: word (c, i) holds bit j where box
// c*64+j > i and IoU(i, c*64+j) > t. One block of 256 threads per (row tile, column tile) pair on
// or above the diagonal, per image: the linear block index maps onto the upper triangle, so no
// block is launched below it. Four threads share a row, each taking every fourth column (so the
// staged boxes are read without bank conflicts), and OR their bits with two shuffles. A word is
// computed only where its row is valid and its column tile holds a valid box: rows of invalid
// boxes are never kept, so the sweep never reads them, and tiles past the last valid box (the
// valid extent) return after reading 128 valid flags. Each block stages its column boxes and
// their areas in shared memory once. A thread first tests its 16 pairs for intersection,
// branch-free; the IEEE division runs only for the pairs that intersect, since any other pair's
// IoU is 0 / denom (+0, or NaN), which is above no threshold t >= 0 (for t < 0 every pair is
// divided). With 80 classes 8192 px apart most pairs do not intersect. The layout keeps the 64
// rows of a tile contiguous within a column tile, so a tile's diagonal words, and its words for
// a later column tile, are each one coalesced 512-byte load in pass 2.
//
// Pass 2 (nms_sweep_kernel) is the greedy sweep, blocked as the Pallas kernel is (resolve a tile
// serially, then suppress the later tiles in parallel). One block of 8 warps per image, over the
// tiles up to the valid extent. For tile t:
//   (a) every warp loads, before the tile is resolved, the words of the tile's valid rows for two
//       later column tiles, and warp 0 loads the next tile's diagonal words. None of these loads
//       depends on the tile's decisions, so their latency overlaps (b);
//   (b) one thread loads the tile's 64 diagonal words from shared memory into registers, then
//       resolves the 64 decisions on a 64-bit `removed` word held in a register: a bit test and
//       a predicated OR a step, two dependent instructions, with no load of any kind in the
//       chain;
//   (c) after one barrier, each warp masks its prefetched words with the tile's keep bits,
//       OR-reduces them across the warp and ORs the result into its column tile's `removed`
//       word in shared memory.
// A tile therefore costs 64 register steps, one barrier and one warp reduction. The `removed`
// word that (b) reads next is written in (c) by warp 0, the warp that resolves, so one barrier
// a tile suffices.
//
// Bit-equality with the plain PyTorch version at IoU == t needs IEEE fp32 with no FMA
// contraction: the IoU is written with round-to-nearest intrinsics in the operation order of
// ops/bbox.py::box_iou, and the build passes --fmad=false as well. Never build this file with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;          // boxes per tile = bits per mask word
constexpr int kMaskThreads = 4 * kTile;  // pass 1: four threads a row
constexpr int kSweepThreads = 256;       // pass 2: 8 warps, one later column tile each per round
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kPrefetchRounds = 2;       // two rounds prefetched: every later tile up to K = 1088

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
__device__ __forceinline__ float iou_rn(const Box& a, float area_a, const Box& b, float area_b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  return __fdiv_rn(inter, denom);
}

// Linear index p over the upper triangle, column by column: (0,0), (0,1), (1,1), (0,2), ...
__device__ __forceinline__ void upper_pair(int p, int& row_tile, int& col_tile) {
  int c = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (c * (c + 1) / 2 > p) --c;
  while ((c + 1) * (c + 2) / 2 <= p) ++c;
  col_tile = c;
  row_tile = p - c * (c + 1) / 2;
}

__device__ __forceinline__ float inter_rn(const Box& a, const Box& b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.0f);
  return __fmul_rn(iw, ih);
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, int K, int nwords,
                float iou_threshold, u64* __restrict__ mask) {
  int row_tile, col_tile;
  upper_pair(blockIdx.x, row_tile, col_tile);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* img = boxes + (size_t)b * K * 4;
  const uint8_t* v = valid + (size_t)b * K;

  const int r = tid >> 2;  // row within the tile
  const int q = tid & 3;   // this thread takes columns q, q+4, ..., q+60
  const int row = row_tile * kTile + r;
  const bool rv = row < K && v[row];
  const Box mine = rv ? load_box(img + (size_t)row * 4) : Box{0.0f, 0.0f, 0.0f, 0.0f};

  // stage the column tile once, with its areas; invalid columns as empty boxes
  __shared__ Box cols[kTile];
  __shared__ float col_area[kTile];
  __shared__ unsigned col_valid[2];
  bool cv = false;
  if (tid < kTile) {  // warps 0 and 1
    const int j = col_tile * kTile + tid;
    cv = j < K && v[j];
    const Box cb = cv ? load_box(img + (size_t)j * 4) : Box{0.0f, 0.0f, 0.0f, 0.0f};
    cols[tid] = cb;
    col_area[tid] = area_rn(cb);
    const unsigned ballot = __ballot_sync(0xffffffffu, cv);
    if ((tid & 31) == 0) col_valid[tid >> 5] = ballot;
  }
  // past the valid extent, or no valid box on one side: no word here is ever read
  if (!__syncthreads_or(rv)) return;
  if (!__syncthreads_or(cv)) return;

  u64 bits = 0ULL;
  if (rv) {
    // the pairs to divide: those that intersect, or all of them if t < 0 (see the note above)
    unsigned todo = 0u;
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) {
      todo |= static_cast<unsigned>(inter_rn(mine, cols[4 * jj + q]) > 0.0f) << jj;
    }
    if (0.0f > iou_threshold) todo = (1u << (kTile / 4)) - 1u;
    const float area = area_rn(mine);
    while (todo) {
      const int j = 4 * (__ffs(todo) - 1) + q;
      todo &= todo - 1u;
      if (iou_rn(mine, area, cols[j], col_area[j]) > iou_threshold) bits |= 1ULL << j;
    }
    bits &= (static_cast<u64>(col_valid[1]) << 32) | col_valid[0];
    if (row_tile == col_tile) bits &= (r == kTile - 1) ? 0ULL : (~0ULL << (r + 1));  // only j > i
  }
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  if (rv && q == 0) mask[((size_t)b * nwords + col_tile) * K + row] = bits;
}

// One step of the chain: rem |= d unless `bit` is set in rem. Written as a predicated OR so that
// a step is two dependent instructions (a bit test into a predicate, then the OR); the compiler's
// own form of the same C++ (shift the bit to a mask, AND, OR) takes four.
__device__ __forceinline__ void keep_step(u64& rem, u64 d, u64 bit) {
  asm("{\n\t.reg .pred p;\n\t.reg .b64 x;\n\t"
      "and.b64 x, %0, %2;\n\tsetp.eq.b64 p, x, 0;\n\t@p or.b64 %0, %0, %1;\n\t}"
      : "+l"(rem)
      : "l"(d), "l"(bit));
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int K, int nwords) {
  extern __shared__ u64 smem[];
  u64* removed = smem;             // [nwords] boxes suppressed by kept boxes of earlier tiles
  u64* vbits = smem + nwords;      // [nwords] valid boxes
  u64* kbits = smem + 2 * nwords;  // [nwords] kept boxes
  __shared__ u64 diag[kTile];      // the current tile's diagonal words; warp 0 only
  __shared__ int extent_tiles;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const u64* words = mask + (size_t)b * nwords * K;  // words[c * K + i]: row i, column tile c
  const uint8_t* v = valid + (size_t)b * K;

  if (tid == 0) extent_tiles = 0;
  __syncthreads();
  for (int w = warp; w < nwords; w += kSweepWarps) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < K && v[i]);
    const unsigned hi = __ballot_sync(0xffffffffu, i + 32 < K && v[i + 32]);
    if (lane == 0) {
      const u64 vb = (static_cast<u64>(hi) << 32) | lo;
      vbits[w] = vb;
      removed[w] = 0ULL;
      kbits[w] = 0ULL;
      if (vb) atomicMax(&extent_tiles, w + 1);
    }
  }
  __syncthreads();
  const int nt = extent_tiles;  // tiles up to the last valid box

  // diagonal words of tile t, rows of valid boxes only (the others were never written)
  auto load_diag = [&](int t, u64& d0, u64& d1) {
    const u64 vb = vbits[t];
    const u64* col = words + (size_t)t * K + t * kTile;
    d0 = ((vb >> lane) & 1ULL) ? col[lane] : 0ULL;
    d1 = ((vb >> (lane + 32)) & 1ULL) ? col[lane + 32] : 0ULL;
  };
  if (warp == 0 && nt > 0) {
    u64 d0, d1;
    load_diag(0, d0, d1);
    diag[lane] = d0;
    diag[lane + 32] = d1;
    __syncwarp();
  }

  for (int t = 0; t < nt; ++t) {
    const u64 vb = vbits[t];
    const bool v0 = (vb >> lane) & 1ULL;
    const bool v1 = (vb >> (lane + 32)) & 1ULL;
    const u64* tile_rows = words + t * kTile + lane;

    // (a) loads independent of this tile's decisions
    u64 w[kPrefetchRounds][2];
#pragma unroll
    for (int m = 0; m < kPrefetchRounds; ++m) {
      const int c = t + 1 + warp + m * kSweepWarps;
      const bool have = c < nt && vbits[c] != 0ULL;
      w[m][0] = have && v0 ? tile_rows[(size_t)c * K] : 0ULL;
      w[m][1] = have && v1 ? tile_rows[(size_t)c * K + 32] : 0ULL;
    }
    u64 d0 = 0ULL, d1 = 0ULL;
    if (warp == 0 && t + 1 < nt) load_diag(t + 1, d0, d1);

    // (b) the serial chain, on registers. Word r of the diagonal has bits above r only, so bit r
    // of `rem` is final once step r is reached, and the kept boxes are the valid ones left unset.
    if (tid == 0 && vb != 0ULL) {
      u64 d[kTile];  // loaded before the chain starts; the words of invalid rows zeroed
#pragma unroll
      for (int r = 0; r < kTile; ++r) d[r] = ((vb >> r) & 1ULL) ? diag[r] : 0ULL;
      u64 rem = removed[t];
#pragma unroll
      for (int r = 0; r < kTile; ++r) keep_step(rem, d[r], 1ULL << r);
      kbits[t] = vb & ~rem;
    }
    if (warp == 0) {
      __syncwarp();  // lane 0 is done with this tile's diagonal
      diag[lane] = d0;
      diag[lane + 32] = d1;
    }
    __syncthreads();

    // (c) suppress the later tiles, one warp per column tile
    const u64 kb = kbits[t];
    if (kb == 0ULL) continue;
    const bool k0 = (kb >> lane) & 1ULL;
    const bool k1 = (kb >> (lane + 32)) & 1ULL;
    auto suppress = [&](int c, u64 x0, u64 x1) {
      if (c >= nt || vbits[c] == 0ULL) return;  // warp-uniform
      const u64 x = warp_or((k0 ? x0 : 0ULL) | (k1 ? x1 : 0ULL));
      if (lane == 0) removed[c] |= x;
    };
#pragma unroll
    for (int m = 0; m < kPrefetchRounds; ++m) suppress(t + 1 + warp + m * kSweepWarps, w[m][0], w[m][1]);
    for (int c = t + 1 + warp + kPrefetchRounds * kSweepWarps; c < nt; c += kSweepWarps) {
      suppress(c, k0 ? tile_rows[(size_t)c * K] : 0ULL, k1 ? tile_rows[(size_t)c * K + 32] : 0ULL);
    }
  }
  __syncthreads();

  uint8_t* out = keep + (size_t)b * K;
  for (int i = tid; i < K; i += kSweepThreads) out[i] = (kbits[i >> 6] >> (i & 63)) & 1ULL;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success).
int sg_nms_exact_keep(const float* boxes, const uint8_t* valid, uint8_t* keep,
                      unsigned long long* mask, int B, int K, float iou_threshold, void* stream) {
  const int nwords = (K + kTile - 1) / kTile;
  const unsigned pairs = static_cast<unsigned>(nwords) * (nwords + 1) / 2;  // tile pairs on or above the diagonal
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(pairs, B), kMaskThreads, 0, s>>>(boxes, valid, K, nwords, iou_threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 3 * nwords * sizeof(u64);  // + 528 static bytes: 24.5 KB at K = 65536
  nms_sweep_kernel<<<B, kSweepThreads, smem, s>>>(mask, valid, keep, K, nwords);
  return static_cast<int>(cudaGetLastError());
}

const char* sg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
