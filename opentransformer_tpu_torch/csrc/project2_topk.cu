// Two-head fused projection -> log-softmax -> top-k for Hopper (sm_90a):
// the per-step consumption of LM shallow fusion in the beam search.
//
// Replaces opentransformer_tpu/ops/project_topk.py:_topk2_kernel (the Pallas
// kernel behind project2_logp_topk_pallas). For each row n it returns the k
// largest values of
//     log_softmax(h1[n] . W1^T + b1) + lam * log_softmax(h2[n] . W2^T + b2)
// with their vocab ids, sorted descending, ties to the smallest id (the
// lax.top_k rule). Neither [N, V] distribution reaches device memory.
// h1 [N, D1] / W1 [V, D1] are the recognizer's head, h2 [N, D2] / W2 [V, D2]
// the language model's; D1 and D2 may differ (decoder 256, LSTM LM 1024).
//
// What bounds it on this card: at the flagship beam step (N = 2560,
// D1 = D2 = 256, V = 4233) the two projections are 11.1 GFLOP against ~7 MB
// of inputs and outputs, so it is bound by operations, not bytes. Like the
// one-head kernel it accumulates in float32 with plain FMA through
// shared-memory tiles (bf16 inputs are widened on load), so its ceiling is
// the 67 TFLOP/s f32 rate; tensor cores are later work.
//
// Design. Per row, logp1 + lam*logp2 = (l1 + lam*l2) - (lse1 + lam*lse2) and
// the subtracted term is a row constant. So the running top-k ranks the raw
// combined logits l1 + lam*l2, each head keeps its own online logsumexp over
// its own logits, and the two normalisers are folded in once, in the merge.
// The block geometry, the vocabulary split across blocks and the per-row
// merge pass are those of project_topk.cu (see there and topk_common.cuh):
// a block computes the tile of head 1, then the tile of head 2 through the
// same staging buffers (two separate D loops), and folds both from
// registers. A partial result carries two (max, sumexp) pairs and one list:
// 4 + k floats and k ints per row and split.
//
// Masking: columns past the vocabulary are never offered to the list and
// add nothing to either sumexp. They are not encoded as a large negative
// combined value: lam may be 0 or negative, and lam * (-1e30) would then
// rank a masked column first.

#include "topk_common.cuh"

namespace {

// Pass 1: one block per (32-row tile, vocab split).
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_topk2_kernel(const T* __restrict__ h1, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ h2,
                     const T* __restrict__ w2, const float* __restrict__ b2, float lam,
                     int n, int d1, int d2, int v, int k, int tiles_per_split,
                     float* __restrict__ part_m1, float* __restrict__ part_s1,
                     float* __restrict__ part_m2, float* __restrict__ part_s2,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* hs = smem;                                   // [kDepth][kRows + 1]
  float* ws = hs + kDepth * (kRows + 1);              // [kDepth][kCols + 1]
  float* lv = smem + kStageFloats;                    // [kRows][k]
  int* li = reinterpret_cast<int*>(lv + kRows * k);   // [kRows][k]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (v + kCols - 1) / kCols;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float m1[kRowsPerWarp], s1[kRowsPerWarp], m2[kRowsPerWarp], s2[kRowsPerWarp];
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m1[i] = m2[i] = kNeg;
    s1[i] = s2[i] = 0.f;
    cnt[i] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kCols;
    float acc1[kRowsPerWarp][kColsPerLane], acc2[kRowsPerWarp][kColsPerLane];
    tile_product(h1, w1, n, d1, v, row0, col0, hs, ws, acc1);
    tile_product(h2, w2, n, d2, v, row0, col0, hs, ws, acc2);

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (row0 + r >= n) continue;  // warp-uniform
      float x1[kColsPerLane], x2[kColsPerLane];
      bool ok[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int g = col0 + lane + 32 * j;
        ok[j] = g < v;
        x1[j] = ok[j] ? acc1[i][j] + b1[g] : kNeg;
        x2[j] = ok[j] ? acc2[i][j] + b2[g] : kNeg;
      }
      online_lse(x1, ok, m1[i], s1[i]);
      online_lse(x2, ok, m2[i], s2[i]);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float combined = ok[j] ? x1[j] + lam * x2[j] : kNeg;
        warp_offer(lv + r * k, li + r * k, k, cnt[i], combined, col0 + lane + 32 * j, ok[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const size_t base = (size_t)split * n + gr;
    if (lane == 0) {
      part_m1[base] = m1[i];
      part_s1[base] = s1[i];
      part_m2[base] = m2[i];
      part_s2[base] = s2[i];
    }
    store_partial_list(lv + r * k, li + r * k, k, cnt[i], part_v, part_i, base);
  }
}

// Pass 2: one warp per row merges the splits' partial results and subtracts
// lse1 + lam * lse2 from the raw combined logits.
__global__ void __launch_bounds__(kThreads)
merge_topk2_kernel(const float* __restrict__ part_m1, const float* __restrict__ part_s1,
                   const float* __restrict__ part_m2, const float* __restrict__ part_s2,
                   const float* __restrict__ part_v, const int* __restrict__ part_i,
                   float lam, int n, int k, int splits, float* __restrict__ vals,
                   int* __restrict__ ids) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // warp-uniform; no block-wide barrier below
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kWarps * k) + warp * k;

  const float lse1 = merged_lse(part_m1, part_s1, n, row, splits);
  const float lse2 = merged_lse(part_m2, part_s2, n, row, splits);
  const float norm = lse1 + lam * lse2;
  merge_lists(part_v, part_i, n, k, row, splits, lv, li);
  for (int j = lane; j < k; j += 32) {
    vals[(size_t)row * k + j] = lv[j] - norm;
    ids[(size_t)row * k + j] = li[j];
  }
}

template <typename T>
int launch(const void* h1, const void* w1, const float* b1, const void* h2, const void* w2,
           const float* b2, float lam, int n, int d1, int d2, int v, int k, int splits,
           int tiles_per_split, float* part, int* part_i, float* vals, int* ids,
           cudaStream_t stream) {
  const size_t smem1 = sizeof(float) * kStageFloats +
                       (sizeof(float) + sizeof(int)) * kRows * k;
  cudaError_t err = cudaFuncSetAttribute(partial_topk2_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const size_t sn = (size_t)splits * n;
  float* part_m1 = part;
  float* part_s1 = part + sn;
  float* part_m2 = part + 2 * sn;
  float* part_s2 = part + 3 * sn;
  float* part_v = part + 4 * sn;
  dim3 grid1((n + kRows - 1) / kRows, splits);
  partial_topk2_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w1), b1,
      static_cast<const T*>(h2), static_cast<const T*>(w2), b2, lam, n, d1, d2, v, k,
      tiles_per_split, part_m1, part_s1, part_m2, part_s2, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (sizeof(float) + sizeof(int)) * kWarps * k;
  merge_topk2_kernel<<<(n + kWarps - 1) / kWarps, kThreads, smem2, stream>>>(
      part_m1, part_s1, part_m2, part_s2, part_v, part_i, lam, n, k, splits, vals, ids);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (h1, w1, h2 and w2 share it; the biases
// are float32). part: float32 scratch of splits * n * (4 + k); part_i: int32
// of splits * n * k. Returns the cudaError_t of the launches (0 on success).
int project2_topk_launch(const void* h1, const void* w1, const float* b1, const void* h2,
                         const void* w2, const float* b2, float lam, int dtype, int n,
                         int d1, int d2, int v, int k, int splits, int tiles_per_split,
                         float* part, int* part_i, float* vals, int* ids, void* stream) {
  if (n <= 0 || d1 <= 0 || d2 <= 0 || k < 1 || k > kMaxK || k > v || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h1, w1, b1, h2, w2, b2, lam, n, d1, d2, v, k, splits,
                         tiles_per_split, part, part_i, vals, ids, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h1, w1, b1, h2, w2, b2, lam, n, d1, d2, v, k, splits,
                                 tiles_per_split, part, part_i, vals, ids, s);
  return (int)cudaErrorInvalidValue;
}

const char* project2_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
