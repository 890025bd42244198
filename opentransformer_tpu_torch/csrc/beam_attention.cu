// Attention of the beam step over its caches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA's
// einsums (opentransformer_tpu/models/modules.py, attend_beamed and
// ancestral_decode_context). It was added because PyTorch's eager form of
// those einsums spent most of the beam step's device time moving the caches
// rather than attending: every step and block cast the bf16 cross keys and
// values to float32 as strided copies, gathered each beam's lineage of the
// self caches into a new tensor and cast that too, then multiplied in float32
// (two thirds of the offline decode's busy time in a traced 30 s window on
// an H100: generic strided copies, the ancestry gather, float32 SIMT batched
// products). Here each cache byte is read once a step, in place, in its own
// type.
//
// Function. For the K beams of utterance b and head h, with queries q_k:
//   s[k, p] = (q_k . key_p) * (1 / sqrt(Dh))  float32 products and sums
//   s[k, p] = -1e9 where the key padding mask is False (masked_fill)
//   w[k, :] = softmax(s[k, :]) in float32, rounded to the output type
//   ctx[k]  = sum_p w[k, p] value_p           summed in float32, stored in
//                                             the output type
// (the one-pass entry rounds the unnormalised weights exp(s - max) to bf16
// instead and divides the float32 sum of the weighted values by the float32
// sum of the weights: the one bf16 rounding of the weights at another point)
// Cross entry: key_p and value_p are frame p of the utterance's cross keys
// and values [B, H, T, Dh] (any strides, Dh innermost); every beam reads
// every frame. Self entry: the caches [B*K, H, U_max, Dh] are append-only;
// beam k reads position p < index from row src[b, k, p] of the utterance
// and position index from its own new key and value, which the kernel also
// writes at `index` of its row of the caches.
//
// What bounds both designs on this card: bytes. A block does ~2K operations
// for each (bf16: 4K/2) byte of keys and values it reads, K = 5 here, far
// below the ~295 operations a byte at which the tensor cores would become
// the limit. The least time is the bytes that must be read over 3.35 TB/s:
// each utterance's valid cross keys and values once, each distinct (row,
// position) of the self caches once, q and the context. Two designs reach
// for it, split by what a call shows (ops/beam_attention.py _cross_plan):
//
// One-pass cross entry (beam_attention_kernel_online; bf16 q, caches and
// output, Dh 32, 64, 96 or 128). One block of four warps serves one
// (utterance, head) and up to 16 of its beams, the rows of an m16n8k16 tile
// (a wider beam is split into chunks, each a block that reads the rows
// again). The warps split the frames in tiles of 16 (warp w takes tiles w,
// w + 4, ...); each warp streams its tiles' keys and values through its own
// ring of stages in shared memory by 16-byte cp.async copies (any strides,
// rows past the last weighed frame zero-filled), a few tiles ahead, and
// waits on its own copies alone: no barrier of the block holds the warps in
// step. The scores are bf16 mma.sync products (q, loaded once into A
// fragments, against K read by ldmatrix), exact products summed in float32,
// scaled by 1/sqrt(Dh) in float32; the softmax is online (a running float32
// max and sum a beam, the context rescaled when the max moves); the
// unnormalised weights exp(s - m), rounded to bf16, are the A operand of
// the P.V product in registers, with V read by ldmatrix.trans. No score is
// ever stored, on chip or in device memory, so no length of the caches
// needs a threshold. At the end the four warps' (max, sum, context) are
// merged in shared memory in a fixed order (a result does not vary from
// run to run) and the context divided by the float32 sum. Rows are padded
// by 16 bytes in shared memory, so ldmatrix's eight rows fall in eight bank
// groups. The key mask is read once a block first: a mask of a valid prefix
// reduces to a number of frames (tiles past it are not read), other masks
// are read a frame at a time, and a row with no valid frame weighs all its
// frames alike, as masked_fill leaves it. The products on the tensor cores
// take the instructions that bounded the two-pass design off the CUDA cores.
//
// Two-pass design (beam_attention_kernel: float32 cross calls, whose
// products on the tensor cores would be TF32, below the configuration's
// float32; the self entry, whose lineage gather and cache writes are
// another need and whose scores fit on chip at the steps a search takes).
// The products run as float32 FMAs on the CUDA cores; with the FMAs, the
// shuffles that sum them and the addressing, the instructions come close to
// the byte bound at the beam step's shapes (K = 5, Dh = 64). One block of
// 128 threads serves one (utterance, head) and all its beams (up to
// kMaxBeams; a wider beam is split into chunks); four blocks share an SM. A
// row of Dh elements is read by a group of g lanes, one 16-byte vector a
// lane (8 bf16 or 4 float32), the groups walking the block's items: a frame
// (cross), or a (position, row) pair of the utterance (self). A table built
// first in shared memory (the frames' mask; for the self entry, which of the
// block's beams read each (position, row)) says which items are read: a
// padded frame is not, nor a row that no lineage of the block holds at that
// position, and a row shared by several lineages is read once; the self
// entry lists the items read (a scan of the table), so the groups walk only
// those, in order. Each lane holds its slice of the K queries; a row gives K
// partial dots, which the group sums by exchanging halves (a reduce-scatter:
// lane vi ends with beam vi's sum when g = 8), and the scores go to shared
// memory, [position][P] with P the beams rounded up to a power of two (to a
// scratch buffer in device memory when they do not fit in
// SCORES_ON_CHIP_BYTES of ops/beam_attention.py). Each lane keeps four
// items' loads in flight while it sums the four before. One warp a beam
// takes the softmax, while the values' first loads are in flight. The second
// pass reads the values the same way, the weights of an item in one or two
// vector loads, accumulates the K contexts in registers, sums them over the
// groups by shuffles and over the warps in shared memory in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // items a lane keeps in flight
constexpr int kMaxBeams = 8;               // beams a block serves
constexpr int kMaxShared = 100 * 1024;     // dynamic shared memory a block may ask for
constexpr float kNegInf = -1.0e9f;         // ops/masks.py NEG_INF

struct Params {
  const void* q;               // [B*K, H, Dh] in T
  long long q_row, q_head;
  const void* k;               // cross: [B, H, T, Dh]; self: the step's keys [B*K, H, Dh]
  const void* v;               // the same layout as k
  long long kv_b, kv_h, kv_t;  // element strides of k and v (self: row, head, -)
  void* cache_k;               // self: [B*K, H, U_max, Dh], contiguous
  void* cache_v;
  const long long* src;        // self: [B, K, src_len]; null for the cross entry
  const unsigned char* mask;   // cross: bool key padding mask, or null
  long long mask_b, mask_t;
  float* scratch;              // the scores in device memory, or null: in shared memory
  void* out;                   // [B*K, H, Dh], contiguous, in float32 or bf16
  int K, H, dh, n_pos, index, u_max, src_len, kc, group, out_bf16, table, list;
  float inv_scale;
};

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // bf16 -> float is exact: the 16 bits are the float's upper half; the
  // element at the lower address sits in the lower half of each word
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// What the block of (b, h) and beams c0 .. c0 + kc - 1 keeps of its place.
struct Block {
  int b, h, c0, kc;
  bool any_valid;   // cross: some frame is not padding
  long long kv;     // cross: offset of the utterance's and head's rows in k and v
  float inv_k;      // self: 1 / K, for n -> (position, row)
};

// An item's flags beside its readers (bit j: beam c0 + j): kPad, a padded
// frame (scores NEG_INF); kOwn, the step's key and value of one of the
// block's rows (its row in bits 16 and up); kLoad, its rows are read.
constexpr unsigned kPad = 1u << 8, kOwn = 1u << 9, kLoad = 1u << 10;

// Item n: its flags and readers, its position and where its rows lie. The
// cross entry's items are the frames, every beam reading each; a padded
// frame is not read (unless every frame is padding: then the softmax is
// uniform over all of them, as masked_fill leaves it, and all are read in
// the values' pass). The self entry's items are (position n / K, row n % K)
// pairs of the utterance, read by the beams of the block's table; at
// `index` a row is the step's own key and value.
template <typename T>
__device__ __forceinline__ unsigned item(const Params& p, const Block& blk,
                                         const unsigned char* table, int n, int& pos,
                                         const T*& key, const T*& value) {
  if (p.src == nullptr) {
    pos = n;
    const long long off = blk.kv + n * p.kv_t;
    key = static_cast<const T*>(p.k) + off;
    value = static_cast<const T*>(p.v) + off;
    const bool pad = p.mask != nullptr && table[n] == 0;
    return ((1u << blk.kc) - 1u) | (pad ? kPad : kLoad);
  }
  int at = __float2int_rz(__int2float_rn(n) * blk.inv_k);  // n / K, then corrected
  int r = n - at * p.K;
  if (r < 0) {
    --at;
    r += p.K;
  } else if (r >= p.K) {
    ++at;
    r -= p.K;
  }
  pos = at;
  const long long row = static_cast<long long>(blk.b) * p.K + r;
  const unsigned users = table[n];
  if (at == p.index) {
    const long long off = row * p.kv_b + blk.h * p.kv_h;
    key = static_cast<const T*>(p.k) + off;
    value = static_cast<const T*>(p.v) + off;
    return users | (users != 0u ? kOwn | kLoad : 0u) | (static_cast<unsigned>(r) << 16);
  }
  const long long off = ((row * p.H + blk.h) * p.u_max + at) * p.dh;
  key = static_cast<const T*>(p.cache_k) + off;
  value = static_cast<const T*>(p.cache_v) + off;
  return users | (users != 0u ? kLoad : 0u);
}

// The step's key or value of an item of the block's row r at `index` into
// the cache, from the registers it was loaded into.
template <typename T>
__device__ __forceinline__ void write_own(const Params& p, const Block& blk, void* cache, int r,
                                          int e, uint4 raw) {
  const long long row = static_cast<long long>(blk.b) * p.K + r;
  *reinterpret_cast<uint4*>(static_cast<T*>(cache) +
                            ((row * p.H + blk.h) * p.u_max + p.index) * p.dh + e) = raw;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums the P partial dots of a group of g lanes, scattered over the lanes:
// halves are exchanged while a lane holds more than one value (lane vi
// keeps the upper half where bit `off` of vi is set), then the one value
// is summed by a butterfly. Afterwards v[0 .. width - 1] hold the sums for
// beams first .. first + width - 1 (scatter_of); when g > P, g / P lanes
// hold each sum, the same float (each addition is taken in both orders).
template <int P>
__device__ __forceinline__ void group_sum(float (&v)[P], int g, int vi) {
  int off = g >> 1;
#pragma unroll
  for (int half = P / 2; half >= 1; half >>= 1) {
    if (off >= 1) {
      const bool up = (vi & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      off >>= 1;
    }
  }
  for (; off >= 1; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

// (first, width) of group_sum's result in lane vi.
template <int P>
__device__ __forceinline__ void scatter_of(int g, int vi, int& first, int& width) {
  int off = g >> 1;
  first = 0;
  width = P;
#pragma unroll
  for (int half = P / 2; half >= 1; half >>= 1) {
    if (off >= 1) {
      first += (vi & off) != 0 ? half : 0;
      width = half;
      off >>= 1;
    }
  }
}

// grid (B * H, chunks of beams); KC >= the chunk's beams. Shared memory:
// the item table (p.table bytes, 16-aligned), the self entry's item list,
// then the scores [n_pos][P] unless they are in scratch; after the values'
// pass, the warps' partial contexts.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 4) beam_attention_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  constexpr int P = pow2_at_least(KC);
  extern __shared__ __align__(16) unsigned char shared[];
  Block blk;
  blk.b = blockIdx.x / p.H;
  blk.h = blockIdx.x % p.H;
  blk.c0 = blockIdx.y * p.kc;
  blk.kc = min(p.kc, p.K - blk.c0);
  blk.kv = blk.b * p.kv_b + blk.h * p.kv_h;
  blk.inv_k = 1.0f / static_cast<float>(p.K);
  const int kc = blk.kc;
  const int g = p.group;  // lanes a row, a power of two <= 32
  const int lanes = p.dh / kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vi = lane & (g - 1);
  const bool on = vi < lanes;
  const int e0 = vi * kVec;  // this lane's elements of a row
  const int group = threadIdx.x / g, n_groups = kThreads / g, stride = n_groups * kUnroll;
  int first, width;  // the beams whose scores this lane writes
  scatter_of<P>(g, vi, first, width);
  const bool writer = g <= P || (vi & (g / P - 1)) == 0;
  const int n_pos = p.n_pos;
  unsigned char* table = shared;
  float* scores = p.scratch == nullptr
                      ? reinterpret_cast<float*>(shared + p.list)
                      : p.scratch + (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) *
                                        P * n_pos;

  // 0. the item table: the frames' mask (cross), each (position, row)'s
  // readers among the block's beams (self)
  int valid = 0;
  if (p.src != nullptr) {
    const long long* lineage = p.src + (static_cast<long long>(blk.b) * p.K + blk.c0) * p.src_len;
    for (int pos = threadIdx.x; pos < n_pos; pos += kThreads) {
      unsigned char* at = table + pos * p.K;
      for (int r = 0; r < p.K; ++r) at[r] = 0;
      for (int j = 0; j < kc; ++j) {
        const long long r =
            pos == p.index ? blk.c0 + j
                           : __ldg(lineage + static_cast<long long>(j) * p.src_len + pos);
        at[r] |= 1u << j;
      }
    }
  } else if (p.mask != nullptr) {
    for (int pos = threadIdx.x; pos < n_pos; pos += kThreads) {
      table[pos] = p.mask[blk.b * p.mask_b + pos * p.mask_t];
      valid |= table[pos];
    }
  }

  float qf[KC][kVec];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j < kc && on)
      raw = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.q) + (static_cast<long long>(blk.b) * p.K + blk.c0 + j) *
                                           p.q_row +
          blk.h * p.q_head + e0));
    E::unpack(raw, qf[j]);
  }
  blk.any_valid = __syncthreads_or(valid) != 0 || p.mask == nullptr || p.src != nullptr;

  // self: the items some beam of the block reads, in order (a row shared by
  // several lineages once, a row of no lineage of the block not at all):
  // each thread lists a contiguous range of positions after the ones
  // before it, by a scan of the counts
  const int* list = nullptr;
  int n_items = n_pos;
  if (p.src != nullptr) {
    int* made = reinterpret_cast<int*>(shared + p.table);
    const int per = (n_pos + kThreads - 1) / kThreads;
    const int lo = min(n_pos, static_cast<int>(threadIdx.x) * per), hi = min(n_pos, lo + per);
    int count = 0;
    for (int n = lo * p.K; n < hi * p.K; ++n) count += table[n] != 0;
    int before = count;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, before, off);
      if (lane >= off) before += x;
    }
    __shared__ int warp_total[kWarps];
    if (lane == 31) warp_total[warp] = before;
    __syncthreads();
    n_items = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_total[w];
      n_items += warp_total[w];
    }
    int at = before - count;
    for (int n = lo * p.K; n < hi * p.K; ++n)
      if (table[n] != 0) made[at++] = n;
    __syncthreads();
    list = made;
  }

  // 1. scores: this lane's slice of every beam's query against its rows;
  // the next items' rows are loaded while these are summed
  {
    uint4 raw[kUnroll];
    unsigned info[kUnroll];
    int pos[kUnroll];
    auto fetch = [&](int base) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int m = base + u * n_groups + group;
        const T *key, *value;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        info[u] = 0u;
        pos[u] = 0;
        if (m < n_items) {
          info[u] = item<T>(p, blk, table, list == nullptr ? m : list[m], pos[u], key, value);
          if ((info[u] & kLoad) && on) raw[u] = __ldg(reinterpret_cast<const uint4*>(key + e0));
        }
      }
    };
    fetch(0);
    for (int base = 0; base < n_items; base += stride) {
      uint4 cur[kUnroll];
      unsigned cinfo[kUnroll];
      int cpos[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        cur[u] = raw[u];
        cinfo[u] = info[u];
        cpos[u] = pos[u];
      }
      if (base + stride < n_items) fetch(base + stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[kVec];
        E::unpack(cur[u], f);
        float d[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float a = 0.0f;
          if (j < KC) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) a = fmaf(qf[j < KC ? j : 0][e], f[e], a);
          }
          d[j] = a;
        }
        group_sum<P>(d, g, vi);
        float* at = scores + cpos[u] * P + first;
        const unsigned readers = cinfo[u] >> first;
        if (writer && cinfo[u] != 0u) {
          if (width == 1) {  // g >= P: one beam a lane
            if (first < kc) {
              if (cinfo[u] & kPad)
                at[0] = kNegInf;
              else if (readers & 1u)
                at[0] = d[0] * p.inv_scale;
            }
          } else {
#pragma unroll
            for (int i = 0; i < P; ++i) {
              if (i < width && first + i < kc) {
                if (cinfo[u] & kPad)
                  at[i] = kNegInf;
                else if ((readers >> i) & 1u)
                  at[i] = d[i] * p.inv_scale;
              }
            }
          }
        }
        if ((cinfo[u] & kOwn) && on)
          write_own<T>(p, blk, p.cache_k, cinfo[u] >> 16, e0, cur[u]);
      }
    }
  }
  // the values' first items are loaded now, while the softmax runs
  uint4 raw[kUnroll];
  unsigned info[kUnroll];
  int pos[kUnroll];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = base + u * n_groups + group;
      const T *key, *value;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      info[u] = 0u;
      pos[u] = 0;
      if (m < n_items) {
        info[u] = item<T>(p, blk, table, list == nullptr ? m : list[m], pos[u], key, value);
        if (!blk.any_valid) info[u] |= kLoad;  // every frame padding: all weigh alike
        if ((info[u] & kLoad) && on) raw[u] = __ldg(reinterpret_cast<const uint4*>(value + e0));
      }
    }
  };
  fetch(0);
  __syncthreads();

  // 2. softmax, one warp a beam; the weights rounded to the output type
  for (int j = warp; j < kc; j += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < n_pos; i += 32) m = fmaxf(m, scores[i * P + j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int i = lane; i < n_pos; i += 32) {
      const float e = expf(scores[i * P + j] - m);
      scores[i * P + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int i = lane; i < n_pos; i += 32) {
      const float w = scores[i * P + j] / sum;
      scores[i * P + j] = p.out_bf16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
    }
  }
  __syncthreads();

  // 3. contexts: the weighted values, summed in float32
  float acc[KC][kVec];
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.0f;
  for (int base = 0; base < n_items; base += stride) {
    uint4 cur[kUnroll];
    unsigned cinfo[kUnroll];
    int cpos[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cur[u] = raw[u];
      cinfo[u] = info[u];
      cpos[u] = pos[u];
    }
    if (base + stride < n_items) fetch(base + stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!(cinfo[u] & kLoad)) continue;
      float w[P];
      const float* at = scores + cpos[u] * P;
      if (P % 4 == 0) {
#pragma unroll
        for (int i = 0; i < P; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(at + i);
          w[i] = x.x;
          w[(i + 1) % P] = x.y;
          w[(i + 2) % P] = x.z;
          w[(i + 3) % P] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) w[i] = at[i];
      }
      float f[kVec];
      E::unpack(cur[u], f);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        // a beam that does not read this row (self), or past the chunk
        const float wj = (j < kc && ((cinfo[u] >> j) & 1u)) ? w[j] : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(wj, f[e], acc[j][e]);
      }
      if ((cinfo[u] & kOwn) && on)
        write_own<T>(p, blk, p.cache_v, cinfo[u] >> 16, e0, cur[u]);
    }
  }
  // over the groups of a warp, then over the warps in a fixed order
  for (int off = g; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
  }
  __syncthreads();  // the table and scores are read: shared memory takes the warps' sums
  float* red = reinterpret_cast<float*>(shared);  // [kWarps][KC][dh]
  if (lane < g && on) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (j < kc) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) red[(warp * KC + j) * p.dh + e0 + e] = acc[j][e];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kc * p.dh; i += kThreads) {
    const int j = i / p.dh, d = i % p.dh;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * KC + j) * p.dh + d];
    const long long o =
        ((static_cast<long long>(blk.b) * p.K + blk.c0 + j) * p.H + blk.h) * p.dh + d;
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(p.out)[o] = s;
  }
}

template <typename T, int KC>
int launch_kc(Params& p, int blocks, int chunks, cudaStream_t stream) {
  constexpr int P = pow2_at_least(KC);
  const size_t red = sizeof(float) * kWarps * KC * p.dh;
  const size_t items = p.src != nullptr ? static_cast<size_t>(p.n_pos) * p.K
                                        : (p.mask != nullptr ? p.n_pos : 0);
  p.table = static_cast<int>((items + 15) / 16 * 16);
  const size_t list = p.src != nullptr ? (sizeof(int) * items + 15) / 16 * 16 : 0;
  p.list = p.table + static_cast<int>(list);  // the scores start after the list
  const size_t scores = p.scratch == nullptr ? sizeof(float) * P * p.n_pos : 0;
  const size_t front = p.list + scores;
  const size_t shared = red > front ? red : front;
  if (shared > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_attention_kernel<T, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_attention_kernel<T, KC><<<dim3(blocks, chunks), kThreads, shared, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(Params& p, int blocks, int chunks, cudaStream_t stream) {
  if (p.kc <= 1) return launch_kc<T, 1>(p, blocks, chunks, stream);
  if (p.kc <= 2) return launch_kc<T, 2>(p, blocks, chunks, stream);
  if (p.kc <= 4) return launch_kc<T, 4>(p, blocks, chunks, stream);
  if (p.kc <= 5) return launch_kc<T, 5>(p, blocks, chunks, stream);
  return launch_kc<T, kMaxBeams>(p, blocks, chunks, stream);
}

// Checks what both entries share, completes p, and launches.
int launch(Params& p, int batch, int dtype, int chunks, void* stream) {
  if (batch <= 0 || p.K <= 0 || p.H <= 0 || p.n_pos <= 0 || (dtype != 0 && dtype != 1) ||
      p.kc < 1 || p.kc > kMaxBeams || chunks < 1 || chunks * p.kc < p.K ||
      (chunks - 1) * p.kc >= p.K || static_cast<long long>(batch) * p.H > 0x7fffffffLL ||
      chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == 1 ? 8 : 4;
  const int lanes = p.dh / vec;
  if (p.dh <= 0 || p.dh % vec != 0 || lanes > 32) return static_cast<int>(cudaErrorInvalidValue);
  int g = 1;
  while (g < lanes) g <<= 1;
  p.group = g;
  // the scores are multiplied by 1/sqrt(Dh) in float32, as PyTorch computes
  // the division of a CUDA tensor by a number
  p.inv_scale = 1.0f / static_cast<float>(sqrt(static_cast<double>(p.dh)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_typed<__nv_bfloat16>(p, batch * p.H, chunks, s)
                    : launch_typed<float>(p, batch * p.H, chunks, s);
}


// ---- the one-pass cross entry (bf16, on the tensor cores) ----

constexpr int kOnlineWarps = 4;
constexpr int kOnlineThreads = 32 * kOnlineWarps;
constexpr int kTileFrames = 16;      // frames a warp takes at a time
constexpr int kOnlineMaxBeams = 16;  // the rows of an mma tile
constexpr float kLog2e = 1.4426950408889634f;

// A frame tile's K (then V) rows in a warp's ring: Dh bf16 padded by one
// 16-byte chunk, so the eight rows an ldmatrix reads start in eight bank
// groups (Dh / 8 + 1 chunks a row is odd for Dh a multiple of 16). Stages
// keep a warp's next tiles in flight while it multiplies one.
template <int Dh>
struct Online {
  static constexpr int kChunks = Dh / 8;
  static constexpr int kRowBytes = Dh * 2 + 16;
  static constexpr int kTileBytes = kTileFrames * kRowBytes;
  static constexpr int kStages = Dh <= 32 ? 4 : Dh <= 64 ? 3 : 2;
  static constexpr int kWarpBytes = kStages * 2 * kTileBytes;
  static constexpr int kShared = kOnlineWarps * kWarpBytes;
  static constexpr int kMinBlocks = Dh <= 64 ? 4 : 3;
  static_assert(Dh % 16 == 0 && (kTileFrames * kChunks) % 32 == 0, "whole chunks a lane");
  // the warps' partial contexts [warp][16][Dh] and (max, sum) [warp][16][2]
  // take the rings' place at the end
  static_assert(kShared >= kOnlineWarps * 16 * (Dh + 2) * 4, "room to merge");
};

struct OnlineParams {
  const __nv_bfloat16* q;      // [B*K, H, Dh] (row and head strides)
  long long q_row, q_head;
  const __nv_bfloat16* k;      // [B, H, T, Dh] (shared strides kv_b, kv_h, kv_t)
  const __nv_bfloat16* v;
  long long kv_b, kv_h, kv_t;
  const unsigned char* mask;   // bool [B, T] (strides mask_b, mask_t), or null
  long long mask_b, mask_t;
  __nv_bfloat16* out;          // [B*K, H, Dh], contiguous
  int K, H, t, kc;
  float inv_scale;
};

// How a block treats its utterance's key mask.
enum FrameMode { kAllFrames = 0, kMaskedFrames = 1, kUniformFrames = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, round to nearest even; lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&two);
}

// elements e, e + 1 of q's row `row0 + row` at head h (zero past the chunk's beams)
__device__ __forceinline__ uint32_t q_pair(const OnlineParams& p, long long row0, int row, int kc,
                                           int h, int e) {
  if (row >= kc) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(p.q + (row0 + row) * p.q_row + h * p.q_head + e));
}

// grid (B * H, chunks of beams). Thread (warp w, lane 4 g + tq) holds the
// scores and context of the chunk's beams g and g + 8 at the columns the
// mma fragments give it (frames or elements 2 tq, 2 tq + 1 of each 8).
template <int Dh>
__global__ void __launch_bounds__(kOnlineThreads, Online<Dh>::kMinBlocks)
    beam_attention_kernel_online(const __grid_constant__ OnlineParams p) {
  using S = Online<Dh>;
  constexpr int kKSteps = Dh / 16;  // depth steps of the scores
  constexpr int kDn = Dh / 8;       // n-tiles of the context
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char shared[];
  __shared__ int s_count, s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int c0 = blockIdx.y * p.kc;
  const int kc = min(p.kc, p.K - c0);
  const int t = p.t;
  const long long kv_t = p.kv_t;
  const __nv_bfloat16* kg = p.k + b * p.kv_b + h * p.kv_h;
  const __nv_bfloat16* vg = p.v + b * p.kv_b + h * p.kv_h;
  const uint32_t ring = smem_addr(shared) + warp * S::kWarpBytes;

  // this warp's n-th tile (frames (warp + 4 n) * 16 ...) into its slot of
  // the warp's ring: K rows, then V rows; frames at or past `limit` zero
  auto load = [&](int n, int limit) {
    const int f0 = (warp + n * kOnlineWarps) * kTileFrames;
    const uint32_t dst = ring + (n % kStages) * 2 * S::kTileBytes;
#pragma unroll
    for (int i = 0; i < kTileFrames * S::kChunks / 32; ++i) {
      const int idx = lane + 32 * i, r = idx / S::kChunks, c = idx % S::kChunks;
      const bool ok = f0 + r < limit;
      const long long off = ok ? (f0 + r) * kv_t + c * 8 : 0;
      const uint32_t at = dst + r * S::kRowBytes + c * 16;
      cp_async16(at, kg + off, ok);
      cp_async16(at + S::kTileBytes, vg + off, ok);
    }
  };

  // each warp's first tile loads while q and the mask are read
  if (threadIdx.x == 0) {
    s_count = 0;
    s_last = -1;
  }
  load(0, t);
  cp_async_commit();

  // q: the chunk's beams g and g + 8 as A fragments, once
  const long long row0 = static_cast<long long>(b) * p.K + c0;
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int e = ks * 16 + 2 * tq;
    qa[ks][0] = q_pair(p, row0, g, kc, h, e);
    qa[ks][1] = q_pair(p, row0, g + 8, kc, h, e);
    qa[ks][2] = q_pair(p, row0, g, kc, h, e + 8);
    qa[ks][3] = q_pair(p, row0, g + 8, kc, h, e + 8);
  }

  // the utterance's key mask, read once: how many frames are valid and the
  // last one; frames past it weigh exactly 0 and are not read
  int mode = kAllFrames, kv_len = t;
  const unsigned char* mrow = p.mask + b * p.mask_b;
  const long long mask_t = p.mask_t;
  if (p.mask != nullptr) {
    __syncthreads();  // s_count and s_last are set
    int count = 0, last = -1;
    constexpr int kScan = 8;  // bytes in flight a thread
    for (int f0 = threadIdx.x; f0 < t; f0 += kScan * kOnlineThreads) {
      unsigned char valid[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int f = f0 + u * kOnlineThreads;
        valid[u] = f < t ? mrow[f * mask_t] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (valid[u]) {
          ++count;
          last = f0 + u * kOnlineThreads;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_xor_sync(0xffffffffu, count, off);
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    }
    if (lane == 0) {
      atomicAdd(&s_count, count);
      atomicMax(&s_last, last);
    }
    __syncthreads();
    count = s_count;
    last = s_last;
    if (count == 0) {
      mode = kUniformFrames;  // every score -1e9: equal weights over all T frames
    } else {
      kv_len = last + 1;
      if (count != kv_len) mode = kMaskedFrames;  // not a valid prefix: read per frame
    }
  }
  const int n_tiles = (kv_len + kTileFrames - 1) / kTileFrames;
  const int mine = n_tiles > warp ? (n_tiles - warp + kOnlineWarps - 1) / kOnlineWarps : 0;
#pragma unroll
  for (int n = 1; n < kStages - 1; ++n) {
    if (n < mine) load(n, kv_len);
    cp_async_commit();
  }

  // where a lane's ldmatrix rows start in a slot: K frames 0-7 / 8-15 at
  // chunks 2 ks, 2 ks + 1; V (transposed) frames 0-7 / 8-15 at chunks 2 dp,
  // 2 dp + 1
  const uint32_t k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * S::kRowBytes + ((lane >> 3) & 1) * 16;
  const uint32_t v_lane =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * S::kRowBytes + (lane >> 4) * 16;
  const bool upper = kc > 8;  // the chunk has beams 8 .. 15
  const float inv_scale = p.inv_scale;
  float o[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.0f, 0.0f};

  for (int n = 0; n < mine; ++n) {
    // tile n + kStages - 1 takes the slot of tile n - 1, whose reads ended
    // with the last iteration
    if (n + kStages - 1 < mine) load(n + kStages - 1, kv_len);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile n has landed
    __syncwarp();
    const uint32_t ks_a = ring + (n % kStages) * 2 * S::kTileBytes, vs_a = ks_a + S::kTileBytes;

    // the scores of the tile's 16 frames: two n-tiles of 8
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks_a + k_lane + ks * 32);
      mma_bf16(s[0], qa[ks], bk[0], bk[1]);
      mma_bf16(s[1], qa[ks], bk[2], bk[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] *= inv_scale;
    const int f0 = (warp + n * kOnlineWarps) * kTileFrames;
    if (mode != kAllFrames || f0 + kTileFrames > kv_len) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + nt * 8 + 2 * tq + e;
          const bool weighed = f < kv_len && (mode != kMaskedFrames || mrow[f * mask_t]);
          const bool keep = weighed && mode != kUniformFrames;
          const float fill = weighed ? 0.0f : -INFINITY;
          s[nt][e] = keep ? s[nt][e] : fill;
          s[nt][e + 2] = keep ? s[nt][e + 2] : fill;
        }
    }

    // the online softmax of each beam: its running max over the quad's
    // frames, the factor that rescales its context and sum, and its
    // unnormalised weights in s
    float alpha[2] = {1.0f, 1.0f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf == 1 && !upper) {  // no beams 8 .. 15: zero weights
        s[0][2] = s[0][3] = s[1][2] = s[1][3] = 0.0f;
        continue;
      }
      float mx = fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                       fmaxf(s[1][2 * hf], s[1][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, row_max[hf]);
      // a beam that has met no weighed frame yet keeps -inf: subtract 0 then
      const float base = mx == -INFINITY ? 0.0f : mx;
      alpha[hf] = mx == row_max[hf] ? 1.0f : ex2((row_max[hf] - base) * kLog2e);
      row_max[hf] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = ex2((s[nt][2 * hf + e] - base) * kLog2e);
          s[nt][2 * hf + e] = w;
          sum += w;
        }
      row_sum[hf] = row_sum[hf] * alpha[hf] + sum;
    }
    if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
    }
    // the weights in bf16 as the A fragment of P.V, its depth the 16 frames
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < kDn / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs_a + v_lane + dp * 32);
      mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();  // every lane's reads of the slot are done: it may be reloaded
  }

  // the warps' (max, sum, context), merged in a fixed order
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row_sum[hf] += __shfl_xor_sync(0xffffffffu, row_sum[hf], 1);
    row_sum[hf] += __shfl_xor_sync(0xffffffffu, row_sum[hf], 2);
  }
  cp_async_wait<0>();  // tiles loaded ahead and never used land first
  __syncthreads();     // every ring is done: shared memory takes the partial results
  float* part = reinterpret_cast<float*>(shared);  // [warp][16][Dh]
  float* stat = part + kOnlineWarps * 16 * Dh;     // [warp][16] (max, sum)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    if (tq == 0) {
      stat[(warp * 16 + r) * 2] = row_max[hf];
      stat[(warp * 16 + r) * 2 + 1] = row_sum[hf];
    }
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      *reinterpret_cast<float2*>(part + (warp * 16 + r) * Dh + dn * 8 + 2 * tq) =
          make_float2(o[dn][2 * hf], o[dn][2 * hf + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kc * Dh; i += kOnlineThreads) {
    const int r = i / Dh, d = i % Dh;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kOnlineWarps; ++w) m = fmaxf(m, stat[(w * 16 + r) * 2]);
    float sum = 0.0f, ctx = 0.0f;
#pragma unroll
    for (int w = 0; w < kOnlineWarps; ++w) {
      // 0 for a warp that weighed no frame of this beam
      const float f = ex2((stat[(w * 16 + r) * 2] - m) * kLog2e);
      sum += stat[(w * 16 + r) * 2 + 1] * f;
      ctx += part[(w * 16 + r) * Dh + d] * f;
    }
    p.out[((row0 + r) * p.H + h) * Dh + d] = __float2bfloat16_rn(ctx / sum);
  }
}

template <int Dh>
int launch_online(const OnlineParams& p, int blocks, int chunks, cudaStream_t stream) {
  constexpr int kShared = Online<Dh>::kShared;
  // the attribute holds for one device: set once for each
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kShared > 48 * 1024 && (dev >= 64 || !allowed[dev])) {
    err = cudaFuncSetAttribute(beam_attention_kernel_online<Dh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = true;
  }
  beam_attention_kernel_online<Dh><<<dim3(blocks, chunks), kOnlineThreads, kShared, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The cross entry. q [B*K, H, Dh] (row and head strides q_row, q_head), k and
// v [B, H, T, Dh] (shared strides kv_b, kv_h, kv_t), all with unit stride
// along Dh, in float32 (dtype 0) or bf16 (1), 16-byte aligned rows; mask a
// bool [B, T] (strides mask_b, mask_t) or null; out a contiguous [B*K, H,
// Dh] in out_dtype, which the weights are rounded to. Beams in chunks of
// kc (ops/beam_attention.py beam_plan); scratch holds B*H*chunks*P*T
// floats (P: kc rounded up to a power of two), or is null when P*T*4 bytes
// fit in shared memory. Returns the cudaError_t of the launch.
int beam_attention_cross_launch(const void* q, long long q_row, long long q_head, const void* k,
                                const void* v, long long kv_b, long long kv_h, long long kv_t,
                                const void* mask, long long mask_b, long long mask_t, int batch,
                                int beams, int heads, int t, int dh, int dtype, int out_dtype,
                                int kc, int chunks, float* scratch, void* out, void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.q_row = q_row;
  p.q_head = q_head;
  p.k = k;
  p.v = v;
  p.kv_b = kv_b;
  p.kv_h = kv_h;
  p.kv_t = kv_t;
  p.mask = static_cast<const unsigned char*>(mask);
  p.mask_b = mask_b;
  p.mask_t = mask_t;
  p.scratch = scratch;
  p.out = out;
  p.K = beams;
  p.H = heads;
  p.dh = dh;
  p.n_pos = t;
  p.kc = kc;
  p.out_bf16 = out_dtype;
  return launch(p, batch, dtype, chunks, stream);
}

// The one-pass cross entry. q [B*K, H, Dh] (row and head strides q_row,
// q_head), k and v [B, H, T, Dh] (shared strides kv_b, kv_h, kv_t), all bf16
// with unit stride along Dh and 16-byte aligned rows; mask a bool [B, T]
// (strides mask_b, mask_t) or null; out a contiguous bf16 [B*K, H, Dh]. Dh
// 32, 64, 96 or 128; beams in chunks of kc <= 16 (ops/beam_attention.py
// beam_plan); no scratch. Returns the cudaError_t of the launch.
int beam_attention_cross_online_launch(const void* q, long long q_row, long long q_head,
                                       const void* k, const void* v, long long kv_b,
                                       long long kv_h, long long kv_t, const void* mask,
                                       long long mask_b, long long mask_t, int batch, int beams,
                                       int heads, int t, int dh, int kc, int chunks, void* out,
                                       void* stream) {
  if (batch <= 0 || beams <= 0 || heads <= 0 || t <= 0 || kc < 1 || kc > kOnlineMaxBeams ||
      chunks < 1 || chunks > 65535 || static_cast<long long>(chunks) * kc < beams ||
      static_cast<long long>(chunks - 1) * kc >= beams ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  OnlineParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_row = q_row;
  p.q_head = q_head;
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kv_b = kv_b;
  p.kv_h = kv_h;
  p.kv_t = kv_t;
  p.mask = static_cast<const unsigned char*>(mask);
  p.mask_b = mask_b;
  p.mask_t = mask_t;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.K = beams;
  p.H = heads;
  p.t = t;
  p.kc = kc;
  // as the two-pass design scales: 1/sqrt(Dh) in float32
  p.inv_scale = 1.0f / static_cast<float>(sqrt(static_cast<double>(dh)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = batch * heads;
  switch (dh) {
    case 32: return launch_online<32>(p, blocks, chunks, s);
    case 64: return launch_online<64>(p, blocks, chunks, s);
    case 96: return launch_online<96>(p, blocks, chunks, s);
    case 128: return launch_online<128>(p, blocks, chunks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The self entry. q, k_t, v_t [B*K, H, Dh] (k_t and v_t share strides kv_row,
// kv_head), the caches contiguous [B*K, H, u_max, Dh], src a contiguous
// int64 [B, K, src_len] with entries in [0, K), everything in one type
// (dtype), 16-byte aligned rows; out a contiguous [B*K, H, Dh] in that type.
// Writes k_t and v_t at position index of every row of the caches. Chunks
// and scratch as the cross entry's, over the index + 1 positions; the
// block's table and item list take 5 * K * (index + 1) bytes of shared
// memory, which with the scores on chip must stay within kMaxShared.
int beam_attention_self_launch(const void* q, long long q_row, long long q_head, const void* k_t,
                               const void* v_t, long long kv_row, long long kv_head,
                               void* cache_k, void* cache_v, const long long* src, int src_len,
                               int index, int u_max, int batch, int beams, int heads, int dh,
                               int dtype, int kc, int chunks, float* scratch, void* out,
                               void* stream) {
  if (src == nullptr || index < 0 || index >= u_max || index >= src_len)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.q_row = q_row;
  p.q_head = q_head;
  p.k = k_t;
  p.v = v_t;
  p.kv_b = kv_row;
  p.kv_h = kv_head;
  p.cache_k = cache_k;
  p.cache_v = cache_v;
  p.src = src;
  p.src_len = src_len;
  p.index = index;
  p.u_max = u_max;
  p.scratch = scratch;
  p.out = out;
  p.K = beams;
  p.H = heads;
  p.dh = dh;
  p.n_pos = index + 1;
  p.kc = kc;
  p.out_bf16 = dtype;
  return launch(p, batch, dtype, chunks, stream);
}

const char* beam_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
