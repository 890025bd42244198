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
// of inputs and outputs, so it is bound by operations: 11.2 us at the bf16
// tensor-core rate, 67.3 us for float32 as three TF32 passes. As in the
// one-head kernel the products run on the tensor cores (bf16 mma.sync, or
// 3xTF32 for float32) from a cp.async ring, and the epilogue works from the
// accumulator registers (topk_common.cuh). What takes the time is then as
// there: few warps (8 an SM) behind fragment loads, slice barriers and the
// epilogue; the second head doubles the slices of every tile.
//
// Design. Per row, logp1 + lam*logp2 = (l1 + lam*l2) - (lse1 + lam*lse2) and
// the subtracted term is a row constant. So the running top-k ranks the raw
// combined logits l1 + lam*l2, each head keeps its own online logsumexp over
// its own logits, and the two normalisers are folded in once, in the merge.
// The block geometry, the vocabulary split across blocks and the per-row
// merge pass are those of project_topk.cu. For each vocabulary tile the
// ring carries head 1's depth slices, then head 2's: the block computes head
// 1's tile, folds its logsumexp and parks the logits in shared memory,
// then head 2's tile in the same accumulator registers, folds its own and
// offers l1 + lam*l2 (holding both tiles in registers would spill). A
// partial result carries two (max, sumexp) pairs and one list: 4 + k
// floats and k ints per row and split.
//
// Masking: columns past the vocabulary are never offered to the list and
// add nothing to either sumexp. They are not encoded as a large negative
// combined value: lam may be 0 or negative, and lam * (-1e30) would then
// rank a masked column first.

#include "topk_common.cuh"

namespace {

// Two ring slots and a 16-row buffer per warp, which holds head 1's logits
// of the tile while head 2 accumulates (so one accumulator tile is live):
// with three slots two blocks would not fit on an SM.
constexpr int kStages = 2;
constexpr int kBufRows = 16;

// This lane's 64 values of a tile to the warp's buffer (16 x kXsStride).
__device__ __forceinline__ void save_tile(const float (&x)[kNTiles][4], float* buf) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      *reinterpret_cast<float2*>(buf + (g + 8 * r) * kXsStride + 8 * j + 2 * t) =
          make_float2(x[j][2 * r], x[j][2 * r + 1]);
}

// x = (what save_tile left in buf) + lam * x; each lane reads its own values.
__device__ __forceinline__ void combine_tile(float (&x)[kNTiles][4], const float* buf,
                                             float lam) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const float2 x1 = *reinterpret_cast<const float2*>(buf + (g + 8 * r) * kXsStride + 8 * j +
                                                         2 * t);
      x[j][2 * r] = x1.x + lam * x[j][2 * r];
      x[j][2 * r + 1] = x1.y + lam * x[j][2 * r + 1];
    }
}

// Pass 1: one block per (64-row tile, vocab split).
template <typename T, bool kLaneLists>
__global__ void __launch_bounds__(kThreads, 2)
partial_topk2_kernel(const T* __restrict__ h1, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ h2,
                     const T* __restrict__ w2, const float* __restrict__ b2, float lam,
                     int n, int d1, int d2, int v, int k, int tiles_per_split, bool aligned,
                     float* __restrict__ part_m1, float* __restrict__ part_s1,
                     float* __restrict__ part_m2, float* __restrict__ part_s2,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char pass1_smem[];
  const Pass1Smem sm = carve_smem(pass1_smem, kStages, kBufRows, k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (v + kCols - 1) / kCols;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  constexpr int kElems = kSliceBytes / sizeof(T);
  const int slices1 = (d1 + kElems - 1) / kElems;
  const int per_tile = slices1 + (d2 + kElems - 1) / kElems;
  const int steps = max(t_end - t_begin, 0) * per_tile;

  if constexpr (!kLaneLists) {
    for (int r = threadIdx.x; r < kRows; r += kThreads) sm.cnt[r] = 0;
    __syncthreads();
  }
  const int my_row = 16 * warp + (lane >> 2);
  const bool row_ok[2] = {row0 + my_row < n, row0 + my_row + 8 < n};
  float m1[2] = {kNeg, kNeg}, s1[2] = {0.f, 0.f}, m2[2] = {kNeg, kNeg}, s2[2] = {0.f, 0.f};
  RowThresholds thr;
  LaneLists lanes;
  if constexpr (kLaneLists)
    init_lane_lists(lanes, k);
  else
    init_thresholds(thr);

  // step s: vocab tile t_begin + s / per_tile; within it head 1's depth
  // slices, then head 2's
  auto fetch = [&](int s) {
    if (s < steps) {
      const int col0 = (t_begin + s / per_tile) * kCols;
      const int c = s % per_tile;
      unsigned char* slot = sm.ring + (s % kStages) * kStageBytes;
      if (c < slices1)
        load_slice<T>(slot, h1, w1, n, d1, v, row0, col0, c * kElems, aligned);
      else
        load_slice<T>(slot, h2, w2, n, d2, v, row0, col0, (c - slices1) * kElems, aligned);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float acc[kNTiles][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s is in; every warp is done with slice s - 1
    fetch(s + kStages - 1);
    const int c = s % per_tile;
    const int col0 = (t_begin + s / per_tile) * kCols;
    if (c == 0 || c == slices1) zero_acc(acc);
    slice_product<T>(sm.ring + (s % kStages) * kStageBytes, acc);
    if (c == slices1 - 1) {  // head 1's logits: fold, park in the buffer
      add_bias(acc, b1, col0, v);
      fold_lse(acc, m1, s1);
      save_tile(acc, sm.xs);
    } else if (c == per_tile - 1) {  // head 2's: fold, combine, offer
      add_bias(acc, b2, col0, v);
      fold_lse(acc, m2, s2);
      combine_tile(acc, sm.xs, lam);
      if constexpr (kLaneLists) {
        offer_tile_lanes(acc, col0, v, sm.xs, lanes);
      } else {
        __syncwarp();  // offer_tile reuses the buffer
        offer_tile(acc, col0, v, row_ok, sm.lv, sm.li, sm.cnt, k, sm.xs, thr);
      }
    }
  }
  cp_async_wait<0>();

  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!row_ok[r]) continue;
      const size_t base = (size_t)split * n + row0 + my_row + 8 * r;
      part_m1[base] = m1[r];
      part_s1[base] = s1[r];
      part_m2[base] = m2[r];
      part_s2[base] = s2[r];
    }
  }
  if constexpr (kLaneLists)
    store_lane_lists(lanes, sm.xs, k, row0, n, split, part_v, part_i);
  else
    store_warp_lists(sm.lv, sm.li, sm.cnt, k, row0, n, split, part_v, part_i);
}

// Pass 2: one warp per row merges the splits' partial results and subtracts
// lse1 + lam * lse2 from the raw combined logits.
__global__ void __launch_bounds__(kMergeThreads)
merge_topk2_kernel(const float* __restrict__ part_m1, const float* __restrict__ part_s1,
                   const float* __restrict__ part_m2, const float* __restrict__ part_s2,
                   const float* __restrict__ part_v, const int* __restrict__ part_i,
                   float lam, int n, int k, int splits, float* __restrict__ vals,
                   int* __restrict__ ids) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= n) return;  // warp-uniform; no block-wide barrier below
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kMergeWarps * k) + warp * k;

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
  const size_t smem1 = pass1_smem_bytes(kStages, kBufRows, k);
  const auto kernel = k <= kLaneK ? partial_topk2_kernel<T, true> : partial_topk2_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
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
  kernel<<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w1), b1,
      static_cast<const T*>(h2), static_cast<const T*>(w2), b2, lam, n, d1, d2, v, k,
      tiles_per_split, rows_aligned<T>(h1, w1, d1) && rows_aligned<T>(h2, w2, d2), part_m1,
      part_s1, part_m2, part_s2, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (sizeof(float) + sizeof(int)) * kMergeWarps * k;
  merge_topk2_kernel<<<(n + kMergeWarps - 1) / kMergeWarps, kMergeThreads, smem2, stream>>>(
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
