// Fused vocab projection -> log-softmax -> top-k for Hopper (sm_90a).
//
// Replaces opentransformer_tpu/ops/project_topk.py:_topk_kernel (the Pallas
// kernel behind project_logp_topk_pallas). For each row n of h [N, D] it
// returns the k largest values of log_softmax(h[n] . W^T + b) with their
// vocab ids, sorted descending, ties to the smallest id (the lax.top_k
// rule), and the row logsumexp. The [N, V] logits never reach device memory.
//
// What bounds it on this card: at the flagship decode shape (N = B*K = 2560,
// D = 256, V = 4233) the projection is 5.55 GFLOP against ~3.6 MB of inputs
// and outputs, so it is bound by operations, not bytes. This first kernel
// accumulates in float32 with plain FMA through shared-memory tiles (bf16
// inputs are widened on load; their products are exact in f32), so it runs
// at best at the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 tensor-core
// rate. Tensor cores (mma.sync / wgmma with TMA) are later work.
//
// Design, against the TPU kernel: there the vocab axis is a sequential grid
// dimension carrying (max, sumexp, top-k) in VMEM scratch. Blocks on Hopper
// run in no order, so the carry becomes a loop over vocab tiles inside a
// block, and the vocab is also split across blocks (blockIdx.y) so that a
// small N still fills the 132 SMs. A second small kernel merges the partial
// (max, sumexp, top-k) of the splits, one warp per row.
//
// Block of pass 1: 256 threads own 32 rows x 128 vocab columns. Warp w
// computes rows 4w..4w+3; lane l holds columns l, l+32, l+64, l+96. The same
// warp then folds those logits into its rows' online logsumexp and running
// top-k straight from registers, so the tile never goes through memory.
// The running top-k is a sorted list per row in shared memory; a warp offers
// 32 candidates at once, and the few that beat the current k-th entry are
// inserted one at a time with a warp-parallel shift (k <= 128, at most four
// entries per lane). The tile product, the online logsumexp and the list
// functions are shared with the two-head kernel (topk_common.cuh).

#include "topk_common.cuh"

namespace {

// Pass 1: one block per (32-row tile, vocab split). Writes the split's
// partial row max, scaled sumexp and sorted top-k (padded with kNeg/kNoId).
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_topk_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const float* __restrict__ bias, int n, int d, int v, int k,
                    int tiles_per_split, float* __restrict__ part_m,
                    float* __restrict__ part_s, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* hs = smem;                                   // [kDepth][kRows + 1]
  float* ws = hs + kDepth * (kRows + 1);              // [kDepth][kCols + 1]
  float* lv = ws + kDepth * (kCols + 1);              // [kRows][k]
  int* li = reinterpret_cast<int*>(lv + kRows * k);   // [kRows][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (v + kCols - 1) / kCols;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float m_run[kRowsPerWarp], s_run[kRowsPerWarp];
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNeg;
    s_run[i] = 0.f;
    cnt[i] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kCols;
    float acc[kRowsPerWarp][kColsPerLane];
    tile_product(h, w, n, d, v, row0, col0, hs, ws, acc);

    // fold the tile into each row's online logsumexp and running top-k
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (row0 + r >= n) continue;  // warp-uniform
      float x[kColsPerLane];
      bool ok[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int g = col0 + lane + 32 * j;
        ok[j] = g < v;
        x[j] = ok[j] ? acc[i][j] + bias[g] : kNeg;
      }
      online_lse(x, ok, m_run[i], s_run[i]);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        warp_offer(lv + r * k, li + r * k, k, cnt[i], x[j], col0 + lane + 32 * j, ok[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int gr = row0 + r;
    if (gr >= n) continue;
    const size_t base = (size_t)split * n + gr;
    if (lane == 0) {
      part_m[base] = m_run[i];
      part_s[base] = s_run[i];
    }
    store_partial_list(lv + r * k, li + r * k, k, cnt[i], part_v, part_i, base);
  }
}

// Pass 2: one warp per row merges the splits' partial results.
__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                  const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int n, int k, int splits, float* __restrict__ vals,
                  int* __restrict__ ids, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // warp-uniform; no block-wide barrier below
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kWarps * k) + warp * k;

  const float row_lse = merged_lse(part_m, part_s, n, row, splits);
  merge_lists(part_v, part_i, n, k, row, splits, lv, li);
  for (int j = lane; j < k; j += 32) {
    vals[(size_t)row * k + j] = lv[j] - row_lse;
    ids[(size_t)row * k + j] = li[j];
  }
  if (lane == 0) lse[row] = row_lse;
}

template <typename T>
int launch(const void* h, const void* w, const float* bias, int n, int d, int v, int k,
           int splits, int tiles_per_split, float* part, int* part_i, float* vals,
           int* ids, float* lse, cudaStream_t stream) {
  const size_t smem1 = sizeof(float) * kStageFloats +
                       (sizeof(float) + sizeof(int)) * kRows * k;
  cudaError_t err = cudaFuncSetAttribute(partial_topk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return (int)err;
  float* part_m = part;
  float* part_s = part + (size_t)splits * n;
  float* part_v = part + (size_t)2 * splits * n;
  dim3 grid1((n + kRows - 1) / kRows, splits);
  partial_topk_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), bias, n, d, v, k,
      tiles_per_split, part_m, part_s, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (sizeof(float) + sizeof(int)) * kWarps * k;
  merge_topk_kernel<<<(n + kWarps - 1) / kWarps, kThreads, smem2, stream>>>(
      part_m, part_s, part_v, part_i, n, k, splits, vals, ids, lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (h and w share it; bias is float32).
// part: float32 scratch of splits * n * (2 + k); part_i: int32 of splits * n * k.
// Returns the cudaError_t of the launches (0 on success).
int project_topk_launch(const void* h, const void* w, const float* bias, int dtype,
                        int n, int d, int v, int k, int splits, int tiles_per_split,
                        float* part, int* part_i, float* vals, int* ids, float* lse,
                        void* stream) {
  if (n <= 0 || d <= 0 || k < 1 || k > kMaxK || k > v || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h, w, bias, n, d, v, k, splits, tiles_per_split, part, part_i,
                         vals, ids, lse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, bias, n, d, v, k, splits, tiles_per_split, part,
                                 part_i, vals, ids, lse, s);
  return (int)cudaErrorInvalidValue;
}

const char* project_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
