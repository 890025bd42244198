// Device functions shared by the fused projection -> log-softmax -> top-k
// kernels (project_topk.cu: one head; project2_topk.cu: two heads for LM
// shallow fusion). Both kernels use the same block geometry: 256 threads own
// 32 rows x 128 vocab columns; warp w computes rows 4w..4w+3 and lane l holds
// columns l, l+32, l+64, l+96 of the tile in registers.

#pragma once

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
// floats of shared memory that tile_product stages h and W through
constexpr int kStageFloats = kDepth * (kRows + 1) + kDepth * (kCols + 1);

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

// acc[i][j] = sum over c < d of h[row0 + 4*warp + i][c] * w[col0 + lane + 32*j][c],
// accumulated in float32 with plain FMA. All 256 threads of the block call it
// together; hs [kDepth][kRows + 1] and ws [kDepth][kCols + 1] are the block's
// staging buffers (kStageFloats in all). Rows >= n and columns >= v read as 0.
template <typename T>
__device__ __forceinline__ void tile_product(const T* __restrict__ h, const T* __restrict__ w,
                                             int n, int d, int v, int row0, int col0,
                                             float* hs, float* ws,
                                             float (&acc)[kRowsPerWarp][kColsPerLane]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
}

// Fold one tile of a row's logits (x[j] at this lane's columns; ok[j] false
// and x[j] = kNeg past the vocabulary) into the row's online logsumexp
// (m_run, s_run). Called by the whole warp that owns the row.
__device__ __forceinline__ void online_lse(const float (&x)[kColsPerLane],
                                           const bool (&ok)[kColsPerLane],
                                           float& m_run, float& s_run) {
  float tmax = kNeg;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) tmax = fmaxf(tmax, x[j]);
  tmax = warp_max(tmax);
  const float m_new = fmaxf(m_run, tmax);
  float se = 0.f;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) se += ok[j] ? expf(x[j] - m_new) : 0.f;
  se = warp_sum(se);
  s_run = s_run * expf(m_run - m_new) + se;
  m_run = m_new;
}

// Write one row's partial sorted list (cnt entries, padded to k with
// kNeg/kNoId) to the split's slot. Called by the warp that owns the row.
__device__ __forceinline__ void store_partial_list(const float* lv, const int* li, int k,
                                                   int cnt, float* __restrict__ part_v,
                                                   int* __restrict__ part_i, size_t base) {
  for (int j = (threadIdx.x & 31); j < k; j += 32) {
    const bool have = j < cnt;
    part_v[base * k + j] = have ? lv[j] : kNeg;
    part_i[base * k + j] = have ? li[j] : kNoId;
  }
}

// Merge pass, one warp per row: the row's logsumexp from the splits'
// partial (max, scaled sumexp).
__device__ __forceinline__ float merged_lse(const float* __restrict__ part_m,
                                            const float* __restrict__ part_s, int n,
                                            int row, int splits) {
  const int lane = threadIdx.x & 31;
  float m = kNeg;
  for (int s = lane; s < splits; s += 32) m = fmaxf(m, part_m[(size_t)s * n + row]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const size_t idx = (size_t)s * n + row;
    sum += part_s[idx] * expf(part_m[idx] - m);
  }
  sum = warp_sum(sum);
  return m + logf(sum);
}

// Merge pass, one warp per row: the k best of the splits' partial lists
// into lv/li (sorted, k entries; k <= V guarantees that many candidates).
__device__ __forceinline__ void merge_lists(const float* __restrict__ part_v,
                                            const int* __restrict__ part_i, int n, int k,
                                            int row, int splits, float* lv, int* li) {
  const int lane = threadIdx.x & 31;
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
}

}  // namespace
