// Self-attention of an encoder at inference, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (opentransformer_tpu/models/modules.py, attention_context). It was added
// because PyTorch's eager form of that function wrote the scores to device
// memory several times over: q and k cast to float32, a float32 product on
// the CUDA cores (TF32 is off), masked_fill, softmax, the weights cast to
// bf16 and back, a second float32 product, the context cast to bf16. At
// Whisper large-v3's 1,500 positions and 20 heads that is [B, 20, 1500, 1500]
// float32 scores a layer, and it took most of the encoder's device time.
// Here the scores never leave the chip.
//
// Function. For row b, head h and query t, over the keys p < T_k:
//   s[t, p] = q_t . k_p                 bf16 products summed in float32 on
//                                       the tensor cores (a product of two
//                                       bf16 values is exact in float32)
//   s[t, p] = -1e9 where the key mask is False (masked_fill, after the
//             1/sqrt(Dh) scale)
//   w[t, :] = softmax(s[t, :] / sqrt(Dh)) in float32, as an online max and
//             sum over tiles of keys, the running context rescaled
//   ctx[t]  = (sum_p bf16(e[t, p]) v_p) / sum_p e[t, p], e the unnormalised
//             float32 weights: the products on the tensor cores summed in
//             float32, the quotient stored in bf16.
// The scale enters the exponent: e = 2^(s * log2(e)/sqrt(Dh) - m * log2(e)
// /sqrt(Dh)), m the running maximum of s, one FMA and one ex2 an element
// (float32 throughout). A masked key's weight exp(-1e9 - m) is exactly 0
// in float32 once its row has met a valid key, so such keys are given 0
// directly (a score of -inf), and keys past a row's last valid key are not
// read. A row with no valid key gets the softmax of equal scores: uniform
// weights over every key, as the masked_fill composition gives.
//
// What bounds it on this card: operations. A block reads each key and value
// of its (row, head) once for its 192 queries: 4·192·Dh operations for each
// 4·Dh bytes, far above the ~295 operations a byte at which the tensor cores
// bind. Next to the products, each score takes one ex2 on the SFU (16 a
// clock an SM), which at Dh = 64 costs about as much time as the products at
// the full bf16 rate: the design overlaps the two.
//
// Design. One block serves one (row, head, tile of queries) with three
// warpgroups of 64 queries each at Dh 32 and 64 (two at Dh 128, for
// registers). The products are warpgroup MMAs (wgmma, bf16 in, float32 out):
// the scores of a tile of 128 keys read Q and K from shared memory, the
// context reads the bf16 weights from registers and V from shared memory
// (transposed). Every tile lies in shared memory in the 128-byte (Dh 32:
// 64-byte) swizzle the MMAs read. K and V tiles pass through a ring of slots,
// loaded by the tensor memory accelerator (one thread issues a tile's boxes
// from tensor maps of the strided K and V views, rows past T_k zero-filled) a
// few tiles ahead, with an mbarrier a slot for "landed" (the tile's bytes have
// arrived) and one for "free" (an arrival from every warp once its products
// that read the slot are done), so that no barrier of the whole block holds
// the warpgroups in step. Within a warpgroup the scores of tile j and the
// context of tile j - 1 are issued together, and the softmax of tile j (max,
// rescale, ex2, sums, in registers, the row's max and sum shared by the four
// lanes of a quad through shuffles) runs while the tensor cores take the
// context. The warpgroups take their turns at the tensor cores in a fixed
// cycle (named barriers), so that one issues its products while the others
// take their softmax: in step, all three would wait for the tensor cores
// together and then for the SFU together. The key mask is read first, once a
// block: a mask of all-True keys, or of a valid prefix, reduces to a number of
// keys, and only other masks are read a key at a time. The context is staged
// through shared memory and written with 16-byte stores into [B, T_q, H, Dh]
// storage.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 128;       // keys a tile
constexpr int kNT = kBlockN / 8;   // n-tiles of 8 keys in a score tile
constexpr int kPK = kBlockN / 16;  // k-steps of 16 keys in the context product

struct Params {
  CUtensorMap k_map, v_map;  // K and V [B, H, T_k, Dh] as boxes of kBlockN rows by a swizzle atom
  const __nv_bfloat16* q;  // [B, H, T_q, Dh], element strides q_b, q_h, q_t
  const __nv_bfloat16* k;  // [B, H, T_k, Dh]
  const __nv_bfloat16* v;
  long long q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t;
  const unsigned char* mask;  // bool key mask [B or 1, T_k] (strides mask_b, mask_t), or null
  long long mask_b, mask_t;
  __nv_bfloat16* out;  // [B, T_q, H, Dh], contiguous
  int heads, tq, tk, q_tiles;
  float scale_log2;  // log2(e) / sqrt(Dh)
};

// Dh-dependent shape: warpgroups a block, and where 16-byte chunk c of row
// r of a tile of `rows` rows lies. A row of Dh bf16 is cut into swizzle
// atoms of 128 bytes (Dh 32: one of 64), each atom column of the tile
// stored as its own [rows][atom] array, chunks XOR-swizzled by the row as
// the MMAs' descriptors expect (Swizzle<3,4,3>; Dh 32: <2,4,3>).
template <int Dh>
struct Shape {
  static constexpr int kGroups = Dh >= 128 ? 2 : 3;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlockM = 64 * kGroups;
  static constexpr int kStages = Dh >= 128 ? 3 : 5;  // tiles of K and of V in the ring
  static constexpr int kAhead = kStages - 2;         // tile j + kAhead loads during tile j
  static constexpr int kAtomBytes = Dh * 2 < 128 ? Dh * 2 : 128;
  static constexpr int kSwizzle = kAtomBytes == 128 ? 1 : 2;  // the descriptor's code
  static constexpr int kAtomChunks = kAtomBytes / 16;
  static constexpr int kAtomElems = kAtomBytes / 2;
  static constexpr int kChunks = Dh / 8;
  static __device__ __forceinline__ int offset(int rows, int r, int c) {
    const int atom = c / kAtomChunks, cc = c % kAtomChunks;
    const int sw = kAtomBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return (atom * rows + r) * kAtomBytes + ((cc ^ sw) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// this thread's shared-memory writes made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across the
// asynchronous products that use it
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A shared-memory matrix descriptor for wgmma: the start address, the
// leading and stride byte offsets, and the swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, round to nearest even; lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d (+)= a · b, m64n128k16: a and b in shared memory, both K-major; d is
// overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a · b, m64n32k16: a in registers, b in shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a · b, m64n64k16: a in registers, b in shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a · b, m64n128k16: a in registers, b in shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int Dh>
__device__ __forceinline__ void wgmma_rs(float (&d)[Dh / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (Dh == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (Dh == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// How a block treats its row's key mask.
enum KeyMode { kAllKeys = 0, kMasked = 1, kUniform = 2 };

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// this thread's arrival on bar, which then also waits for `bytes` to land
__device__ __forceinline__ void mbar_expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// a box of a 4-d tensor map at coordinates (c0 innermost .. c3) -> shared
// memory at dst, its bytes counted on bar
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// named barriers 1.. order the warpgroups' turns at the tensor cores
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int Dh>
__global__ void __launch_bounds__(Shape<Dh>::kThreads, 1) encoder_attention_fwd(const __grid_constant__ Params p) {
  using S = Shape<Dh>;
  constexpr int BM = S::kBlockM, kThreads = S::kThreads, kGroups = S::kGroups;
  constexpr int kTileBytes = kBlockN * Dh * 2;
  constexpr int kStages = S::kStages;
  constexpr int kAhead = S::kAhead;
  static_assert(kAhead <= kStages - 2, "a slot is reloaded a tile after its context is done");
  constexpr int DN = Dh / 8;   // n-tiles of the context
  constexpr int kKSteps = Dh / 16;
  constexpr int kStepsPerAtom = S::kAtomBytes / 32;
  constexpr uint32_t kGroupBytes = 8 * S::kAtomBytes;  // 8 rows of an atom column

  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_count, s_last;
  // per slot of the ring: full (the slot's K and V tiles have landed: an
  // arrival from every thread) and empty (every warp's products that read
  // them are done: an arrival from each warp)
  __shared__ __align__(8) unsigned long long s_full[kStages], s_empty[kStages];
  // the tiles start on 1024 bytes: the swizzle is a function of the address
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* sq = smem_raw + pad;  // BM rows of Q (then of the context)
  const uint32_t sq_a = raw + pad;
  const uint32_t sk_a = sq_a + BM * Dh * 2;           // kStages tiles of K
  const uint32_t sv_a = sk_a + kStages * kTileBytes;  // kStages tiles of V
  const uint32_t full_a = smem_addr(s_full), empty_a = smem_addr(s_empty);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int qt = blockIdx.x % p.q_tiles;
  const int bh = blockIdx.x / p.q_tiles;
  const int h = bh % p.heads, b = bh / p.heads;
  const int q0 = qt * BM;

  const __nv_bfloat16* qg = p.q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kg = p.k + b * p.k_b + h * p.k_h;
  const __nv_bfloat16* vg = p.v + b * p.v_b + h * p.v_h;
  // the parameters the lambdas below read, as locals (a reference to the
  // kernel's parameter block would put it in local memory)
  const int tk = p.tk;
  const long long mask_t = p.mask_t;
  const float scale_log2 = p.scale_log2;

  if (tid == 0) {
    s_count = 0;
    s_last = -1;
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_a + 8 * i, 1);
      mbar_init(empty_a + 8 * i, kThreads / 32);
    }
  }
  __syncthreads();

  // Q tile -> shared (rows past T_q zero), one cp.async group
#pragma unroll
  for (int i = 0; i < (BM * S::kChunks + kThreads - 1) / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx / S::kChunks, c = idx % S::kChunks;
    if (idx < BM * S::kChunks) {
      const bool ok = q0 + r < p.tq;
      cp_async16(sq_a + S::offset(BM, r, c), qg + (ok ? (q0 + r) * p.q_t + c * 8 : 0), ok);
    }
  }
  cp_async_commit();

  // K and V tile t -> slot t % kStages by the tensor memory accelerator,
  // issued by one thread once every warp is done with the slot's last tile;
  // the slot's full barrier completes when the bytes have landed. Rows past
  // T_k are zero; rows past a row's last valid key are loaded but weigh
  // exactly 0 (the first loads start before the mask is read; the block
  // waits for those it does not use before it exits).
  auto load_tile = [&](int t) {
    if (tid != 0) return;
    const int slot = t % kStages;
    if (t >= kStages) mbar_wait(empty_a + 8 * slot, ((t / kStages) + 1) & 1);
    const uint32_t full = full_a + 8 * slot;
    mbar_expect_bytes(full, 2 * kTileBytes);
#pragma unroll
    for (int a = 0; a < Dh / S::kAtomElems; ++a) {
      const uint32_t off = slot * kTileBytes + a * kBlockN * S::kAtomBytes;
      tma_rows(sk_a + off, &p.k_map, a * S::kAtomElems, t * kBlockN, h, b, full);
      tma_rows(sv_a + off, &p.v_map, a * S::kAtomElems, t * kBlockN, h, b, full);
    }
  };
  const int load_tiles = (tk + kBlockN - 1) / kBlockN;
#pragma unroll
  for (int t = 0; t < kAhead; ++t)
    if (t < load_tiles) load_tile(t);

  // the row's key mask, read once: how many keys are valid and the last one
  int mode = kAllKeys, kv_len = tk;
  if (p.mask != nullptr) {
    const unsigned char* mg = p.mask + b * p.mask_b;
    int count = 0, last = -1;
    // kScan bytes in flight a thread: the loads' latencies overlap
    constexpr int kScan = 8;
    for (int c0 = tid; c0 < tk; c0 += kScan * kThreads) {
      unsigned char valid[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int c = c0 + u * kThreads;
        valid[u] = c < tk ? mg[c * mask_t] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (valid[u]) {
          ++count;
          last = c0 + u * kThreads;
        }
      }
    }
    if (count) {
      atomicAdd(&s_count, count);
      atomicMax(&s_last, last);
    }
    __syncthreads();
    count = s_count;
    last = s_last;
    if (count == 0) {
      mode = kUniform;          // every score -1e9: equal weights over all T_k keys
    } else {
      kv_len = last + 1;        // keys past the last valid one weigh exactly 0
      if (count != kv_len) mode = kMasked;  // not a valid prefix: read per key
    }
  }
  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;
  const unsigned char* mrow = p.mask + b * p.mask_b;

  // descriptors: Q (this warpgroup's 64 rows) and K read K-major, V
  // MN-major (its rows are the product's depth)
  const uint32_t q_rows = sq_a + group * 64 * S::kAtomBytes;
  auto q_desc = [&](int ks) {
    return gmma_desc(q_rows + (ks / kStepsPerAtom) * BM * S::kAtomBytes + (ks % kStepsPerAtom) * 32,
                     16, kGroupBytes, S::kSwizzle);
  };
  auto k_desc = [&](int tile, int ks) {
    return gmma_desc(sk_a + (tile % kStages) * kTileBytes +
                         (ks / kStepsPerAtom) * kBlockN * S::kAtomBytes + (ks % kStepsPerAtom) * 32,
                     16, kGroupBytes, S::kSwizzle);
  };
  auto v_desc = [&](int tile, int kk) {
    return gmma_desc(sv_a + (tile % kStages) * kTileBytes + kk * 16 * S::kAtomBytes,
                     kBlockN * S::kAtomBytes, kGroupBytes, S::kSwizzle);
  };

  float s[kNT * 4];   // this thread's scores: rows lane/4 and lane/4 + 8 of its warp's 16
  float o[Dh / 2];    // its context
  uint32_t pa[kPK][4];  // its bf16 weights as the context product's A fragments
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) o[i] = 0.f;

  // the warpgroups take turns to issue their products, in a cycle: each
  // waits for the one before it, issues, and lets the next one go, so that
  // one warpgroup's softmax runs while another's products do
  const int turn = 1 + group, next_turn = 1 + (group + 1) % kGroups;
  auto scores = [&](int tile) {
    mbar_wait(full_a + 8 * (tile % kStages), (tile / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) wgmma_ss_n128(s, q_desc(ks), k_desc(tile, ks), ks > 0);
    wgmma_commit();
  };
  auto context = [&](int tile) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) wgmma_rs<Dh>(o, pa[kk], v_desc(tile, kk));
    wgmma_commit();
  };
  // every warp's products that read the tile are done: its slot may be reloaded
  auto release = [&](int tile) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * (tile % kStages));
  };

  // the online softmax of tile j's scores: keys not weighed (past kv_len,
  // masked, or all equal in kUniform), the running max, the factor alpha
  // that rescales the context and sum, and the unnormalised weights in s
  auto softmax = [&](int j) {
    const int k0 = j * kBlockN;
    if (mode != kAllKeys || k0 + kBlockN > kv_len) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + nt * 8 + (lane & 3) * 2 + e;
          const bool weighed =
              col < kv_len && (mode != kMasked || mrow[(col < kv_len ? col : 0) * mask_t]);
          const float fill = weighed ? 0.f : -INFINITY;
          const bool keep = weighed && mode != kUniform;
          s[nt * 4 + e] = keep ? s[nt * 4 + e] : fill;
          s[nt * 4 + e + 2] = keep ? s[nt * 4 + e + 2] : fill;
        }
    }
    // the max and the sum as trees over the 32 keys a thread holds of each
    // row (short dependency chains), then over the quad
    float mx[2], base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float t[kNT / 2];
#pragma unroll
      for (int i = 0; i < kNT / 2; ++i)
        t[i] = fmaxf(fmaxf(s[8 * i + 2 * hf], s[8 * i + 2 * hf + 1]),
                     fmaxf(s[8 * i + 4 + 2 * hf], s[8 * i + 5 + 2 * hf]));
#pragma unroll
      for (int w = kNT / 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
      mx[hf] = fmaxf(row_max[hf], t[0]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      // a row that has met no weighed key yet keeps -inf: subtract 0 then
      base[hf] = mx[hf] == -INFINITY ? 0.f : mx[hf] * scale_log2;
      alpha[hf] = mx[hf] == row_max[hf] ? 1.f : ex2(row_max[hf] * scale_log2 - base[hf]);
      row_max[hf] = mx[hf];
    }
#pragma unroll
    for (int i = 0; i < kNT * 4; ++i) s[i] = ex2(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float t[kNT / 2];
#pragma unroll
      for (int i = 0; i < kNT / 2; ++i)
        t[i] = (s[8 * i + 2 * hf] + s[8 * i + 2 * hf + 1]) +
               (s[8 * i + 4 + 2 * hf] + s[8 * i + 5 + 2 * hf]);
#pragma unroll
      for (int w = kNT / 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) t[i] += t[i + w];
      row_sum[hf] = row_sum[hf] * alpha[hf] + t[0];
    }
    // the results held here, so that the softmax runs while the context
    // product does and is not moved past the wait for it
    fence_operands(s);
    fence_operands(row_sum);
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  cp_async_wait<0>();  // Q (the K and V copies are tracked by the barriers)
  fence_async_shared();
  __syncthreads();
  if (group == kGroups - 1) named_arrive(1);  // the first warpgroup goes first

  // tile 0: its scores and softmax
  named_sync(turn);
  scores(0);
  named_arrive(next_turn);
  wgmma_wait<0>();
  fence_operands(s);
  softmax(0);
  pack();
  if (kAhead < n_tiles) load_tile(kAhead);
  // tile j: its scores with tile j - 1's context, its softmax while that
  // context is summed, then the rescale of the context by the new max
  for (int j = 1; j < n_tiles; ++j) {
    named_sync(turn);
    scores(j);
    context(j - 1);
    named_arrive(next_turn);
    wgmma_wait<1>();  // the scores; the context product runs on
    fence_operands(s);
    softmax(j);
    wgmma_wait<0>();
    fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) fence_operands(pa[kk]);
    release(j - 1);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn * 4] *= alpha[0];
        o[dn * 4 + 1] *= alpha[0];
        o[dn * 4 + 2] *= alpha[1];
        o[dn * 4 + 3] *= alpha[1];
      }
    }
    pack();
    if (j + kAhead < n_tiles) load_tile(j + kAhead);
  }
  // the last tile's context; the last warpgroup's turn ends the cycle
  named_sync(turn);
  context(n_tiles - 1);
  if (group != kGroups - 1) named_arrive(next_turn);
  wgmma_wait<0>();
  fence_operands(o);

  // the row sums over the quad, the quotient in bf16, staged in this
  // warpgroup's rows of the Q tile (its products are done) and stored 16
  // bytes a lane
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = row_sum[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int r = group * 64 + wq * 16 + (lane >> 2) + hf * 8;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const uint32_t packed = pack_bf16(o[dn * 4 + 2 * hf] * inv, o[dn * 4 + 2 * hf + 1] * inv);
      *reinterpret_cast<uint32_t*>(sq + S::offset(BM, r, dn) + (lane & 3) * 4) = packed;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * S::kChunks / 32; ++i) {
    const int idx = lane + i * 32, rr = idx / S::kChunks, c = idx % S::kChunks;
    const int r = group * 64 + wq * 16 + rr, t = q0 + r;
    if (t < p.tq) {
      const uint4 val = *reinterpret_cast<const uint4*>(sq + S::offset(BM, r, c));
      __nv_bfloat16* dst =
          p.out + ((static_cast<long long>(b) * p.tq + t) * p.heads + h) * Dh + c * 8;
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
  // tiles loaded before the mask was read and past the row's last valid
  // key: their copies must land before the block exits, since the next
  // block on this SM takes over the shared memory and the barriers
  if (tid == 0) {
    const int loaded = kAhead < load_tiles ? kAhead : load_tiles;
    for (int t = n_tiles; t < loaded; ++t) mbar_wait(full_a + 8 * (t % kStages), (t / kStages) & 1);
  }
}

// cuTensorMapEncodeTiled of the driver, looked up once
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// a bf16 [B, H, T, Dh] view (element strides s_b, s_h, s_t) as a 4-d tensor
// map read in boxes of kBlockN rows by one swizzle atom, rows past T zero;
// a dimension of one element takes any stride the map accepts
template <int Dh>
bool rows_map(CUtensorMap* map, const void* base, int batch, int heads, int t, long long s_b,
              long long s_h, long long s_t) {
  using S = Shape<Dh>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = 2ull * s_t, head = heads > 1 ? 2ull * s_h : row * t;
  cuuint64_t dims[4] = {Dh, static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {row, head, batch > 1 ? 2ull * s_b : head * heads};
  cuuint32_t box[4] = {S::kAtomElems, kBlockN, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                S::kAtomBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dh>
int launch_dh(Params& p, int batch, cudaStream_t stream) {
  if (!rows_map<Dh>(&p.k_map, p.k, batch, p.heads, p.tk, p.k_b, p.k_h, p.k_t) ||
      !rows_map<Dh>(&p.v_map, p.v, batch, p.heads, p.tk, p.v_b, p.v_h, p.v_t))
    return static_cast<int>(cudaErrorInvalidValue);
  using S = Shape<Dh>;
  // the tiles, and up to 1 KB to start them on 1024 bytes
  const int shared = S::kBlockM * Dh * 2 + 2 * S::kStages * kBlockN * Dh * 2 + 1024;
  // set at every launch: the attribute holds for the current device only
  const cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_fwd<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.q_tiles = (p.tq + S::kBlockM - 1) / S::kBlockM;
  const long long blocks = static_cast<long long>(batch) * p.heads * p.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  encoder_attention_fwd<Dh><<<static_cast<unsigned>(blocks), S::kThreads, shared, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v [B, H, T, Dh] bf16 (element strides *_b, *_h, *_t; unit stride
// along Dh; 16-byte aligned rows), T_q queries and T_k keys; mask a bool key
// mask [B or 1, T_k] (strides mask_b, mask_t; mask_b 0 when it is shared by
// every row) or null; out a contiguous bf16 [B, T_q, H, Dh]. Dh 32, 64 or
// 128. Returns the cudaError_t of the launch.
int encoder_attention_launch(const void* q, long long q_b, long long q_h, long long q_t,
                             const void* k, long long k_b, long long k_h, long long k_t,
                             const void* v, long long v_b, long long v_h, long long v_t,
                             const void* mask, long long mask_b, long long mask_t, void* out,
                             int batch, int heads, int tq, int tk, int dh, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_b = q_b;
  p.q_h = q_h;
  p.q_t = q_t;
  p.k_b = k_b;
  p.k_h = k_h;
  p.k_t = k_t;
  p.v_b = v_b;
  p.v_h = v_h;
  p.v_t = v_t;
  p.mask = static_cast<const unsigned char*>(mask);
  p.mask_b = mask_b;
  p.mask_t = mask_t;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(dh)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dh<32>(p, batch, s);
    case 64: return launch_dh<64>(p, batch, s);
    case 128: return launch_dh<128>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* encoder_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
