// Device code shared by the fused projection -> log-softmax -> top-k
// kernels (project_topk.cu: one head; project2_topk.cu: two heads for LM
// shallow fusion).
//
// What bounds them on this card. At the flagship beam step (N = 2560,
// D = 256, V = 4233) one head's product is 5.55 GFLOP against ~3.6 MB, so
// the kernels are bound by operations, and only the tensor cores reach the
// bound: 989 TFLOP/s for bf16, 495 TFLOP/s for TF32, against 67 TFLOP/s for
// float32 FMA. So the tile product runs on the tensor cores:
//   - bf16 inputs: mma.sync m16n8k16 bf16 -> f32. bf16 x bf16 products are
//     exact in f32 and sum in f32, as in the plain version.
//   - float32 inputs: 3xTF32 through mma.sync m16n8k8. Each operand is split
//     into hi = tf32(x) and lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi
//     accumulate in f32; the dropped lo*lo and the rounding of lo are ~2^-22
//     of each product, where one TF32 pass would be ~2^-11 (a logit of scale
//     20 off by ~1e-2).
// mma.sync, not wgmma: its fragments are plain registers loaded from padded
// shared memory, and at these shapes the product is not what limits the
// kernel once it is on the tensor cores (PERF.md).
//
// Block geometry: 128 threads (4 warps) own 64 rows x 128 vocab columns;
// warp w owns rows 16w..16w+15 and all 128 columns, as 16 m16n8 tiles of 4
// f32 accumulators each. In that layout lane (g = lane/4, t = lane%4) holds
// rows g and g+8, columns 8j + 2t and 8j + 2t + 1 of every n-tile j: a row's
// 128 values sit in the 4 lanes of a quad, 32 each. The epilogue works from
// those registers: two shfl_xor steps (1, 2) give a row's max and sumexp,
// and a lane compares its values with the current k-th (value, id) it keeps
// in registers, so only values that beat it go further. For k <= kLaneK
// (beam search, greedy) they go into the lane's own sorted list in
// registers; for larger k into a per-row list in shared memory, by rank.
// A list insert is a chain of dependent steps; inserting one value at a
// time with the whole warp, as the first version of these kernels did, cost
// more than the product once the product ran on the tensor cores.
//
// Staging: h and W stream through a ring of shared-memory slots, each a
// 128-byte depth slice (64 bf16 or 32 f32) of the block's 64 h rows and
// 128 W rows, filled with 16-byte cp.async (zero-fill past N, V and D)
// while the warps compute the slots before. Rows are padded to 144 bytes,
// so the fragment loads of a warp hit 32 different banks. The slot order
// runs through vocabulary tiles without a break, so the next tile's first
// slices load during a tile's epilogue. (Keeping the h tile resident
// instead, which removes a third of the copies, measured no faster.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;                  // one warpgroup
constexpr int kRows = 64;                      // rows per block, 16 per warp
constexpr int kCols = 128;                     // vocab columns per tile
constexpr int kNTiles = kCols / 8;             // m16n8 tiles per warp
constexpr int kSliceBytes = 128;               // depth slice of a row per stage
constexpr int kRowBytes = kSliceBytes + 16;    // padded shared-memory row
constexpr int kStageBytes = (kRows + kCols) * kRowBytes;
constexpr int kXsStride = kCols + 8;            // row buffer stride (floats)
constexpr int kLaneK = 8;                       // lane-held lists serve k <= kLaneK
constexpr int kMaxK = 128;
constexpr float kNeg = -1e30f;                 // finite: no inf - inf
constexpr int kNoId = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 256;             // merge pass: one warp per row
constexpr int kMergeWarps = kMergeThreads / 32;

// Shared memory of a pass-1 block: a ring of ``stages`` slots, a buffer of
// ``buf_rows`` rows (of kXsStride floats) per warp and, for k > kLaneK, a
// sorted list per row and the lists' lengths.
inline size_t pass1_smem_bytes(int stages, int buf_rows, int k) {
  const size_t lists =
      k > kLaneK ? (sizeof(float) + sizeof(int)) * kRows * k + sizeof(int) * kRows : 0;
  return (size_t)stages * kStageBytes + sizeof(float) * 4 * buf_rows * kXsStride + lists;
}

// The regions of that shared memory.
struct Pass1Smem {
  unsigned char* ring;
  float* xs;   // this warp's buffer
  float* lv;
  int* li;
  int* cnt;
};

__device__ __forceinline__ Pass1Smem carve_smem(unsigned char* smem, int stages, int buf_rows,
                                                int k) {
  Pass1Smem p;
  p.ring = smem;
  float* xs_all = reinterpret_cast<float*>(smem + stages * kStageBytes);
  p.xs = xs_all + (threadIdx.x >> 5) * buf_rows * kXsStride;
  p.lv = xs_all + 4 * buf_rows * kXsStride;
  p.li = reinterpret_cast<int*>(p.lv + kRows * k);
  p.cnt = p.li + kRows * k;
  return p;
}

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

// ------------------------------------------------------------ staging

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage depth slice [c0, c0 + 128 bytes) of h rows row0.. (n rows of d) and
// w rows col0.. (v rows of d) into one ring slot: h rows at 0..63, w rows at
// 64..191, each kRowBytes apart. Rows past n or v and depth past d read as
// zeros. ``aligned`` (every row starts on 16 bytes) allows 16-byte
// cp.async; otherwise the slot is filled with plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_slice(unsigned char* slot, const T* __restrict__ h,
                                           const T* __restrict__ w, int n, int d, int v,
                                           int row0, int col0, int c0, bool aligned) {
  constexpr int kPer = 16 / sizeof(T);                  // elements per 16 bytes
  constexpr int kPieces = kSliceBytes / 16;             // 16-byte pieces per row
  if (aligned) {
    constexpr int kIters = (kRows + kCols) * kPieces / kThreads;
    static_assert(kIters * kThreads == (kRows + kCols) * kPieces, "pieces per thread");
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int r = p / kPieces, q = p % kPieces;
      const bool is_h = r < kRows;
      const T* base = is_h ? h : w;
      const int gr = is_h ? row0 + r : col0 + r - kRows;
      const int gc = c0 + q * kPer;
      const bool ok = gr < (is_h ? n : v) && gc < d;
      cp_async16(slot + r * kRowBytes + q * 16, ok ? base + (size_t)gr * d + gc : base,
                 ok ? 16 : 0);
    }
    return;
  }
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  constexpr int kElems = kSliceBytes / sizeof(T);
  for (int e = threadIdx.x; e < (kRows + kCols) * kElems; e += kThreads) {
    const int r = e / kElems, c = e % kElems;
    const bool is_h = r < kRows;
    const Bits* base = reinterpret_cast<const Bits*>(is_h ? h : w);
    const int gr = is_h ? row0 + r : col0 + r - kRows;
    const int gc = c0 + c;
    const bool ok = gr < (is_h ? n : v) && gc < d;
    reinterpret_cast<Bits*>(slot + r * kRowBytes)[c] = ok ? base[(size_t)gr * d + gc] : Bits(0);
  }
}

// ------------------------------------------------------------ tile product

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  const float x = __uint_as_float(bits);
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void zero_acc(float (&acc)[kNTiles][4]) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

// acc[j] += (this warp's 16 h rows) . (w rows 8j..8j+7)^T over one staged
// depth slice. The fragment of lane (g, t) starts at byte 4t of row g (and
// g + 8) of the slice, for both types: a bf16 k16 step and an f32 k8 step
// both span 32 bytes, with the second half of the fragment 16 bytes on.
template <typename T>
__device__ __forceinline__ void slice_product(const unsigned char* slot,
                                              float (&acc)[kNTiles][4]);

template <>
__device__ __forceinline__ void slice_product<__nv_bfloat16>(const unsigned char* slot,
                                                             float (&acc)[kNTiles][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* a_top = slot + (16 * warp + (lane >> 2)) * kRowBytes + 4 * (lane & 3);
  const unsigned char* a_bot = a_top + 8 * kRowBytes;
  const unsigned char* b = slot + (kRows + (lane >> 2)) * kRowBytes + 4 * (lane & 3);
#pragma unroll
  for (int kb = 0; kb < kSliceBytes; kb += 32) {
    const uint32_t a[4] = {lds32(a_top + kb), lds32(a_bot + kb), lds32(a_top + kb + 16),
                           lds32(a_bot + kb + 16)};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const unsigned char* bj = b + j * 8 * kRowBytes + kb;
      mma_bf16(acc[j], a, lds32(bj), lds32(bj + 16));
    }
  }
}

template <>
__device__ __forceinline__ void slice_product<float>(const unsigned char* slot,
                                                     float (&acc)[kNTiles][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* a_top = slot + (16 * warp + (lane >> 2)) * kRowBytes + 4 * (lane & 3);
  const unsigned char* a_bot = a_top + 8 * kRowBytes;
  const unsigned char* b = slot + (kRows + (lane >> 2)) * kRowBytes + 4 * (lane & 3);
#pragma unroll
  for (int kb = 0; kb < kSliceBytes; kb += 32) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(lds32(a_top + kb), a_hi[0], a_lo[0]);
    split_tf32(lds32(a_bot + kb), a_hi[1], a_lo[1]);
    split_tf32(lds32(a_top + kb + 16), a_hi[2], a_lo[2]);
    split_tf32(lds32(a_bot + kb + 16), a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const unsigned char* bj = b + j * 8 * kRowBytes + kb;
      uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
      split_tf32(lds32(bj), b0_hi, b0_lo);
      split_tf32(lds32(bj + 16), b1_hi, b1_lo);
      // the small terms first, then the large one
      mma_tf32(acc[j], a_lo, b0_hi, b1_hi);
      mma_tf32(acc[j], a_hi, b0_lo, b1_lo);
      mma_tf32(acc[j], a_hi, b0_hi, b1_hi);
    }
  }
}

// ------------------------------------------------------------ epilogue

// This lane's view of its two rows' lists (rows g and g + 8 of its warp's
// 16): the k-th entry, or (-inf, kNoId) while a list holds fewer than k.
// The lists and their lengths live in shared memory.
struct RowThresholds {
  float v[2];
  int id[2];
};

__device__ __forceinline__ void init_thresholds(RowThresholds& thr) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    thr.v[r] = -INFINITY;
    thr.id[r] = kNoId;
  }
}

// Turn a tile's products into logits: add the bias, and set columns past
// the vocabulary to kNeg (they add nothing to a sumexp).
__device__ __forceinline__ void add_bias(float (&x)[kNTiles][4], const float* __restrict__ bias,
                                         int col0, int v) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + 2 * t + e;
      if (col < v) {
        const float b = __ldg(bias + col);
        x[j][e] += b;
        x[j][2 + e] += b;
      } else {
        x[j][e] = x[j][2 + e] = kNeg;
      }
    }
}

// Fold a tile of logits into this lane's two rows' online logsumexp.
__device__ __forceinline__ void fold_lse(const float (&x)[kNTiles][4], float (&m)[2],
                                         float (&s)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tmax = kNeg;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) tmax = fmaxf(tmax, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
    const float m_new = fmaxf(m[r], tmax);
    float se = 0.f;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      se += expf(x[j][2 * r] - m_new) + expf(x[j][2 * r + 1] - m_new);
    se += __shfl_xor_sync(kFull, se, 1);
    se += __shfl_xor_sync(kFull, se, 2);
    s[r] = s[r] * expf(m[r] - m_new) + se;
    m[r] = m_new;
  }
}

// k > kLaneK: a sorted list per row in shared memory. Offer a tile's
// values x to the rows' lists (columns past v and rows past n excluded).
// Each lane first compares its 32 values of a row with the row's k-th entry
// in its registers; a value that cannot enter costs one compare. Only the
// rows where some value can are written to the warp's buffer xs (rows
// 0..7 of kXsStride floats) and merged, a row at a time: the values that
// beat the k-th entry are gathered in xs rows 8..9 (128 values, 128 ids),
// every lane counts, for its candidates and its list entries, the members
// of the union that rank before them, and each member whose count is below
// k is written to that place. The lists: lv/li [kRows][k], their lengths
// cnt [kRows].
__device__ __forceinline__ void offer_tile(const float (&x)[kNTiles][4], int col0, int v,
                                           const bool (&row_ok)[2], float* lv, int* li,
                                           int* cnt, int k, float* xs, RowThresholds& thr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* cand_v = xs + 8 * kXsStride;
  int* cand_i = reinterpret_cast<int*>(cand_v + kCols);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      any |= (x[j][2 * r] >= thr.v[r]) | (x[j][2 * r + 1] >= thr.v[r]);
    // bit g: row g + 8r of the warp has a value that may enter
    unsigned rows = 0;
    const unsigned lanes = __ballot_sync(kFull, any && row_ok[r]);
#pragma unroll
    for (int q = 0; q < 8; ++q) rows |= ((lanes >> (4 * q)) & 0xfu) ? 1u << q : 0u;
    if (rows == 0) continue;  // warp-uniform
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      *reinterpret_cast<float2*>(xs + g * kXsStride + 8 * j + 2 * t) =
          make_float2(x[j][2 * r], x[j][2 * r + 1]);
    __syncwarp();
    while (rows) {
      const int q = __ffs(rows) - 1;
      rows &= rows - 1;
      const int row = 16 * warp + q + 8 * r;
      float* rv = lv + row * k;
      int* ri = li + row * k;
      const int c = cnt[row];
      const float kv = c == k ? rv[k - 1] : -INFINITY;
      const int ki = c == k ? ri[k - 1] : kNoId;
      // gather the candidates
      int n_cand = 0;
#pragma unroll
      for (int base = 0; base < kCols; base += 32) {
        const float val = xs[q * kXsStride + base + lane];
        const int id = col0 + base + lane;
        const bool want = id < v && better(val, id, kv, ki);
        const unsigned m = __ballot_sync(kFull, want);
        if (want) {
          const int pos = n_cand + __popc(m & ((1u << lane) - 1));
          cand_v[pos] = val;
          cand_i[pos] = id;
        }
        n_cand += __popc(m);
      }
      __syncwarp();
      // this lane's candidates and list entries: slots lane + 32 i
      float mv[4], lvv[4];
      int mi[4], lii[4], rank_c[4], rank_l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = lane + 32 * i;
        mv[i] = p < n_cand ? cand_v[p] : -INFINITY;
        mi[i] = p < n_cand ? cand_i[p] : kNoId;
        lvv[i] = p < c ? rv[p] : -INFINITY;
        lii[i] = p < c ? ri[p] : kNoId;
        rank_c[i] = 0;
        rank_l[i] = p;  // the list is sorted
      }
      for (int cc = 0; cc < n_cand; ++cc) {
        const float ov = cand_v[cc];
        const int oi = cand_i[cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) rank_c[i] += better(ov, oi, mv[i], mi[i]) ? 1 : 0;
      }
      if (c > 0) {
        for (int cc = 0; cc < n_cand; ++cc) {
          const float ov = cand_v[cc];
          const int oi = cand_i[cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) rank_l[i] += better(ov, oi, lvv[i], lii[i]) ? 1 : 0;
        }
        for (int p = 0; p < c; ++p) {
          const float ov = rv[p];
          const int oi = ri[p];
#pragma unroll
          for (int i = 0; i < 4; ++i) rank_c[i] += better(ov, oi, mv[i], mi[i]) ? 1 : 0;
        }
      }
      __syncwarp();  // every lane has read the old list
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = lane + 32 * i;
        if (p < n_cand && rank_c[i] < k) {
          rv[rank_c[i]] = mv[i];
          ri[rank_c[i]] = mi[i];
        }
        if (p < c && rank_l[i] < k) {
          rv[rank_l[i]] = lvv[i];
          ri[rank_l[i]] = lii[i];
        }
      }
      const int c_new = min(k, c + n_cand);
      if (lane == 0) cnt[row] = c_new;
      __syncwarp();
      if (g == q) {
        thr.v[r] = c_new == k ? rv[k - 1] : -INFINITY;
        thr.id[r] = c_new == k ? ri[k - 1] : kNoId;
      }
    }
    __syncwarp();
  }
}

// k <= kLaneK: every lane keeps the best k (value, id) of its own columns
// of its two rows, sorted, in registers. A row's top-k lies in the union of
// its four lanes' lists, so nothing else is kept until the end. The list
// has kLaneK slots; the first kLaneK - k hold (+inf, kSentinel), which
// nothing displaces, so the lane's k-th entry, the bar a new value must
// clear, is always the last slot (a constant index keeps the list in
// registers).
constexpr int kSentinel = -1;

struct LaneLists {
  float v[2][kLaneK];
  int id[2][kLaneK];
};

__device__ __forceinline__ void init_lane_lists(LaneLists& L, int k) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) {
      L.v[r][e] = e < kLaneK - k ? INFINITY : -INFINITY;
      L.id[r][e] = e < kLaneK - k ? kSentinel : kNoId;
    }
}

// Replace the last entry with (val, id) and bubble it up to its place.
__device__ __forceinline__ void lane_insert(float (&lv)[kLaneK], int (&li)[kLaneK], float val,
                                            int id) {
  lv[kLaneK - 1] = val;
  li[kLaneK - 1] = id;
#pragma unroll
  for (int i = kLaneK - 1; i > 0; --i) {
    const bool up = better(lv[i], li[i], lv[i - 1], li[i - 1]);
    const float tv = lv[i];
    const int ti = li[i];
    lv[i] = up ? lv[i - 1] : tv;
    li[i] = up ? li[i - 1] : ti;
    lv[i - 1] = up ? tv : lv[i - 1];
    li[i - 1] = up ? ti : li[i - 1];
  }
}

// Offer row slot R's values of a tile (columns past v excluded) to this
// lane's list of that row. The lane marks the values that clear its bar,
// parks its values in its own slots of the warp's buffer xs (row g), and
// inserts only the marked ones, reading them back by index: the warp's time
// is that of the lane with the most insertions, not of every value some
// lane inserts. R is a template argument so that the list stays in
// registers.
template <int R>
__device__ __forceinline__ void offer_row_lanes(const float (&x)[kNTiles][4], int col0, int v,
                                                float* xs, float (&lv)[kLaneK],
                                                int (&li)[kLaneK]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned hits = 0;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int id = col0 + 8 * j + 2 * t + e;
      if (id < v && better(x[j][2 * R + e], id, lv[kLaneK - 1], li[kLaneK - 1]))
        hits |= 1u << (2 * j + e);
    }
  if (hits == 0) return;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    *reinterpret_cast<float2*>(xs + g * kXsStride + 8 * j + 2 * t) =
        make_float2(x[j][2 * R], x[j][2 * R + 1]);
  while (hits) {
    const int b = __ffs(hits) - 1;
    hits &= hits - 1;
    const int col = 8 * (b >> 1) + 2 * t + (b & 1);
    const float val = xs[g * kXsStride + col];
    const int id = col0 + col;
    if (better(val, id, lv[kLaneK - 1], li[kLaneK - 1])) lane_insert(lv, li, val, id);
  }
}

// Offer a tile's values to this lane's lists of both its rows.
__device__ __forceinline__ void offer_tile_lanes(const float (&x)[kNTiles][4], int col0, int v,
                                                 float* xs, LaneLists& L) {
  offer_row_lanes<0>(x, col0, v, xs, L.v[0], L.id[0]);
  offer_row_lanes<1>(x, col0, v, xs, L.v[1], L.id[1]);
}

// The split's sorted top-k of each of this warp's rows below n, from the
// 4 x kLaneK candidates of the row's quad: the candidates go through the
// warp's buffer buf (16 rows x 33 values, then 16 x 33 ids), lane c of the
// warp takes candidate c of a row, counts the candidates that rank before
// it, and writes itself to that place if it is below k. Placeholders
// (-inf, kNoId) rank after every real candidate and among themselves by
// slot; they are written as (kNeg, kNoId).
__device__ __forceinline__ void store_lane_lists(const LaneLists& L, float* buf, int k, int row0,
                                                 int n, int split, float* __restrict__ part_v,
                                                 int* __restrict__ part_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* bv = buf;
  int* bi = reinterpret_cast<int*>(buf + 16 * 33);
  __syncwarp();  // the warp may still read what buf held
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) {
      const bool sentinel = L.id[r][e] == kSentinel;
      bv[(g + 8 * r) * 33 + t * kLaneK + e] = sentinel ? -INFINITY : L.v[r][e];
      bi[(g + 8 * r) * 33 + t * kLaneK + e] = sentinel ? kNoId : L.id[r][e];
    }
  __syncwarp();
  for (int q = 0; q < 16; ++q) {
    const int row = row0 + 16 * warp + q;
    if (row >= n) break;  // warp-uniform
    const float mv = bv[q * 33 + lane];
    const int mi = bi[q * 33 + lane];
    int rank = 0;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float cv = bv[q * 33 + c];
      const int ci = bi[q * 33 + c];
      rank += (better(cv, ci, mv, mi) || (cv == mv && ci == mi && c < lane)) ? 1 : 0;
    }
    if (rank < k) {
      const size_t base = ((size_t)split * n + row) * k + rank;
      part_v[base] = mi == kNoId ? kNeg : mv;
      part_i[base] = mi;
    }
  }
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

// Every row of this warp's 16 that is below n: its partial list to part_v /
// part_i at (split, row).
__device__ __forceinline__ void store_warp_lists(const float* lv, const int* li, const int* cnt,
                                                 int k, int row0, int n, int split,
                                                 float* __restrict__ part_v,
                                                 int* __restrict__ part_i) {
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < 16; ++q) {
    const int row = 16 * warp + q;
    if (row0 + row >= n) break;  // warp-uniform
    store_partial_list(lv + row * k, li + row * k, k, cnt[row], part_v, part_i,
                       (size_t)split * n + row0 + row);
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
// Up to 32 candidates (the flagship beam step has 6 splits of 5), lane e
// holds candidate e, counts through shuffles the candidates that rank
// before it, and writes itself to that place if it is below k; the padding
// (kNeg, kNoId) ranks after every real candidate and is not written. More
// candidates are offered to the list 32 at a time.
__device__ __forceinline__ void merge_lists(const float* __restrict__ part_v,
                                            const int* __restrict__ part_i, int n, int k,
                                            int row, int splits, float* lv, int* li) {
  const int lane = threadIdx.x & 31;
  const int total = splits * k;
  if (total <= 32) {  // warp-uniform
    float mv = kNeg;
    int mi = kNoId;
    if (lane < total) {
      const size_t idx = ((size_t)(lane / k) * n + row) * k + lane % k;
      mv = part_v[idx];
      mi = part_i[idx];
    }
    int rank = 0;
#pragma unroll
    for (int o = 1; o < 32; ++o) {
      const int src = (lane + o) & 31;
      rank += better(__shfl_sync(kFull, mv, src), __shfl_sync(kFull, mi, src), mv, mi) ? 1 : 0;
    }
    if (mi != kNoId && rank < k) {
      lv[rank] = mv;
      li[rank] = mi;
    }
    __syncwarp();
    return;
  }
  int cnt = 0;
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

// Whether rows of d elements of h and w start on 16 bytes (cp.async).
template <typename T>
inline bool rows_aligned(const void* h, const void* w, int d) {
  return (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace
