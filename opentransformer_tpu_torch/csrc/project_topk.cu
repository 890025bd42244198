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
// and outputs, so it is bound by operations: 5.6 us at the 989 TFLOP/s bf16
// tensor-core rate, and for float32 inputs three TF32 passes at 495 TFLOP/s
// (33.6 us). The tile product therefore runs on the tensor cores (bf16
// mma.sync, or 3xTF32 for float32), fed by a cp.async ring, and the epilogue
// works from the accumulator registers; topk_common.cuh says how and why.
// Measured, the tensor-core instructions are no longer what takes the time
// (about a tenth of it in bf16, PERF.md): at 255 registers a thread two
// blocks (8 warps) share an SM, and the shared-memory fragment loads, the
// barrier of every depth slice and the epilogue have few warps to hide
// behind.
//
// Design, against the TPU kernel: there the vocab axis is a sequential grid
// dimension carrying (max, sumexp, top-k) in VMEM scratch. Blocks on Hopper
// run in no order, so the carry becomes a loop over 128-column vocab tiles
// inside a block, and the vocabulary is also split across blocks
// (blockIdx.y) so that a small N still fills the 132 SMs. A second small
// kernel merges the partial (max, sumexp, top-k) of the splits, one warp
// per row.
//
// Block of pass 1: one warpgroup (128 threads) owns 64 rows x 128 vocab
// columns per tile; each warp owns 16 rows. The running top-k: for k <= 8
// each lane keeps its own columns' best k in registers and the split's
// top-k is picked from a row's four lane lists at the end; for larger k a
// sorted list per row in shared memory takes each tile's values that beat
// its k-th entry in one rank merge.

#include "topk_common.cuh"

namespace {

constexpr int kStages = 3;   // ring slots
// rows of a warp's buffer: the offers' 8 rows and, for k > kLaneK, 2 rows
// of gathered candidates
constexpr int kBufRows = 10;

// Pass 1: one block per (64-row tile, vocab split). Writes the split's
// partial row max, scaled sumexp and sorted top-k (padded with kNeg/kNoId).
template <typename T, bool kLaneLists>
__global__ void __launch_bounds__(kThreads, 2)
partial_topk_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const float* __restrict__ bias, int n, int d, int v, int k,
                    int tiles_per_split, bool aligned, float* __restrict__ part_m,
                    float* __restrict__ part_s, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char pass1_smem[];
  const Pass1Smem sm = carve_smem(pass1_smem, kStages, kBufRows, k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (v + kCols - 1) / kCols;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  constexpr int kElems = kSliceBytes / sizeof(T);
  const int slices = (d + kElems - 1) / kElems;
  const int steps = max(t_end - t_begin, 0) * slices;

  if constexpr (!kLaneLists) {
    for (int r = threadIdx.x; r < kRows; r += kThreads) sm.cnt[r] = 0;
    __syncthreads();
  }
  const int my_row = 16 * warp + (lane >> 2);
  const bool row_ok[2] = {row0 + my_row < n, row0 + my_row + 8 < n};
  float m_run[2] = {kNeg, kNeg}, s_run[2] = {0.f, 0.f};
  RowThresholds thr;
  LaneLists lanes;
  if constexpr (kLaneLists)
    init_lane_lists(lanes, k);
  else
    init_thresholds(thr);

  // step s: depth slice s % slices of vocab tile t_begin + s / slices
  auto fetch = [&](int s) {
    if (s < steps)
      load_slice<T>(sm.ring + (s % kStages) * kStageBytes, h, w, n, d, v, row0,
                    (t_begin + s / slices) * kCols, (s % slices) * kElems, aligned);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float acc[kNTiles][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s is in; every warp is done with slice s - 1
    fetch(s + kStages - 1);
    const int c = s % slices;
    if (c == 0) zero_acc(acc);
    slice_product<T>(sm.ring + (s % kStages) * kStageBytes, acc);
    if (c == slices - 1) {
      const int col0 = (t_begin + s / slices) * kCols;
      add_bias(acc, bias, col0, v);
      fold_lse(acc, m_run, s_run);
      if constexpr (kLaneLists)
        offer_tile_lanes(acc, col0, v, sm.xs, lanes);
      else
        offer_tile(acc, col0, v, row_ok, sm.lv, sm.li, sm.cnt, k, sm.xs, thr);
    }
  }
  cp_async_wait<0>();

  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!row_ok[r]) continue;
      const size_t base = (size_t)split * n + row0 + my_row + 8 * r;
      part_m[base] = m_run[r];
      part_s[base] = s_run[r];
    }
  }
  if constexpr (kLaneLists)
    store_lane_lists(lanes, sm.xs, k, row0, n, split, part_v, part_i);
  else
    store_warp_lists(sm.lv, sm.li, sm.cnt, k, row0, n, split, part_v, part_i);
}

// Pass 2: one warp per row merges the splits' partial results.
__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                  const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int n, int k, int splits, float* __restrict__ vals,
                  int* __restrict__ ids, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= n) return;  // warp-uniform; no block-wide barrier below
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kMergeWarps * k) + warp * k;

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
  const size_t smem1 = pass1_smem_bytes(kStages, kBufRows, k);
  const auto kernel = k <= kLaneK ? partial_topk_kernel<T, true> : partial_topk_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return (int)err;
  float* part_m = part;
  float* part_s = part + (size_t)splits * n;
  float* part_v = part + (size_t)2 * splits * n;
  dim3 grid1((n + kRows - 1) / kRows, splits);
  kernel<<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), bias, n, d, v, k,
      tiles_per_split, rows_aligned<T>(h, w, d), part_m, part_s, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (sizeof(float) + sizeof(int)) * kMergeWarps * k;
  merge_topk_kernel<<<(n + kMergeWarps - 1) / kMergeWarps, kMergeThreads, smem2, stream>>>(
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
