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
// entries per lane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // rows per block
constexpr int kCols = 128;                     // vocab columns per tile
constexpr int kDepth = 32;                     // D per shared-memory stage
constexpr int kRowsPerWarp = kRows / kWarps;   // 4
constexpr int kColsPerLane = kCols / 32;       // 4
constexpr int kMaxK = 128;
constexpr float kNeg = -1e30f;                 // finite: no inf - inf
constexpr int kNoId = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Order of the top-k list: larger value first, then smaller id.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Insert (v, id) into the sorted list lv/li of cnt entries (capacity k).
// Called by all 32 lanes with the same candidate; cnt is warp-uniform. The
// caller guarantees the candidate belongs in the list.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, int& cnt,
                                            float v, int id) {
  const int lane = threadIdx.x & 31;
  int before = 0;
  for (int j = lane; j < cnt; j += 32) before += better(lv[j], li[j], v, id) ? 1 : 0;
  const int pos = warp_sum_int(before);
  const int new_cnt = cnt < k ? cnt + 1 : k;
  float tv[kMaxK / 32];
  int ti[kMaxK / 32];
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < new_cnt) {
      tv[r] = lv[j - 1];
      ti[r] = li[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < new_cnt) {
      lv[j] = tv[r];
      li[j] = ti[r];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
  cnt = new_cnt;
}

__device__ __forceinline__ bool wants(const float* lv, const int* li, int k, int cnt,
                                      float v, int id, bool valid) {
  return valid && (cnt < k || better(v, id, lv[k - 1], li[k - 1]));
}

// Offer one candidate per lane to the list; inserts those that belong.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k, int& cnt,
                                           float v, int id, bool valid) {
  const int lane = threadIdx.x & 31;
  unsigned mask = __ballot_sync(kFull, wants(lv, li, k, cnt, v, id, valid));
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int ci = __shfl_sync(kFull, id, src);
    warp_insert(lv, li, k, cnt, cv, ci);
    if (lane == src) valid = false;
    mask = __ballot_sync(kFull, wants(lv, li, k, cnt, v, id, valid));
  }
}

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
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kDepth) {
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int gr = row0 + r, gc = k0 + c;
        hs[c * (kRows + 1) + r] =
            (gr < n && gc < d) ? to_f32(h[(size_t)gr * d + gc]) : 0.f;
      }
      for (int e = tid; e < kCols * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int gr = col0 + r, gc = k0 + c;
        ws[c * (kCols + 1) + r] =
            (gr < v && gc < d) ? to_f32(w[(size_t)gr * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDepth; ++c) {
        float a[kRowsPerWarp], b[kColsPerLane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          a[i] = hs[c * (kRows + 1) + warp * kRowsPerWarp + i];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) b[j] = ws[c * (kCols + 1) + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold the tile into each row's online logsumexp and running top-k
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (row0 + r >= n) continue;  // warp-uniform
      float x[kColsPerLane];
      bool ok[kColsPerLane];
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int g = col0 + lane + 32 * j;
        ok[j] = g < v;
        x[j] = ok[j] ? acc[i][j] + bias[g] : kNeg;
        tmax = fmaxf(tmax, x[j]);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m_run[i], tmax);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) se += ok[j] ? expf(x[j] - m_new) : 0.f;
      se = warp_sum(se);
      s_run[i] = s_run[i] * expf(m_run[i] - m_new) + se;
      m_run[i] = m_new;
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
    for (int j = lane; j < k; j += 32) {
      const bool have = j < cnt[i];
      part_v[base * k + j] = have ? lv[r * k + j] : kNeg;
      part_i[base * k + j] = have ? li[r * k + j] : kNoId;
    }
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

  float m = kNeg;
  for (int s = lane; s < splits; s += 32) m = fmaxf(m, part_m[(size_t)s * n + row]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const size_t idx = (size_t)s * n + row;
    sum += part_s[idx] * expf(part_m[idx] - m);
  }
  sum = warp_sum(sum);
  const float row_lse = m + logf(sum);

  int cnt = 0;
  const int total = splits * k;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    float cv = kNeg;
    int ci = kNoId;
    if (e < total) {
      const int s = e / k, j = e % k;
      const size_t idx = ((size_t)s * n + row) * k + j;
      cv = part_v[idx];
      ci = part_i[idx];
    }
    warp_offer(lv, li, k, cnt, cv, ci, ci != kNoId);
  }
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
  const size_t smem1 = sizeof(float) * (kDepth * (kRows + 1) + kDepth * (kCols + 1)) +
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
