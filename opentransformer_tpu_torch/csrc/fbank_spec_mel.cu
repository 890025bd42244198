// Fused FFT -> power -> mel -> log of kaldi log-fbank for Hopper (sm_90a).
//
// Replaces opentransformer_tpu/ops/fbank_pallas.py:_spec_mel_kernel (the
// Pallas kernel behind fbank_pallas / fbank_pallas_batch). For each windowed
// frame x (a row of frames [F, W], W = 400 samples at 16 kHz) it computes
//   X[q] = sum_k x[k] e^{-2 pi i k q / 512}        (q < 257, a 512-point real DFT)
//   out[m] = log(max(sum_q |X[q]|^2 mel_t[q][m], EPSILON))    (M <= 128 bins)
// The TPU kernel writes the DFT as two dense products against 400 x 257
// cos/sin bases, the form its matrix unit runs; here it is an FFT. Neither
// the spectrum nor the power spectrum reaches device memory.
//
// What bounds it on this card: a 512-point real FFT is ~11.5k float32 flops a
// frame, power and mel ~1.8k more, so at the training shape (16 utterances of
// 10 s, F = 15,968 frames, M = 40) the function is 0.21 GFLOP (3 us at 67
// TFLOP/s) against 25.5 MB of frames read once and 2.6 MB of output: it is
// bound by bytes, ~8.4 us at 3.35 TB/s.
//
// Design. One warp transforms one frame at a time, and warps walk the frames
// in a grid-stride loop over a grid sized to fill every SM once (persistent
// blocks, two of 8 warps an SM). The 400 real samples are read as a
// 256-point complex sequence z[n] = x[2n] + i x[2n+1] (zero from n = 200 on)
// with coalesced 16-byte loads: lane L holds z[2L + e + 64i] (e < 2, i < 4).
// The next frame's loads are issued before the current frame is transformed,
// so each warp keeps one frame (1,600 bytes) in flight in registers while it
// computes: 16 warps an SM keep ~3.4 MB in flight over the card, which covers
// HBM's latency, so no shared-memory staging or cp.async is needed. The
// complex FFT is a four-step 4 x 8 x 8 decomposition in registers:
//   pass A  radix-4 over i (n = a + 64i), times W256^(a k1), two per lane;
//   pass B  radix-8 over c (a = b + 8c) for lane (k1, b), times W64^(b u);
//   pass C  radix-8 over b for lane (k1, u): Z[k1 + 4u + 32v], v < 8.
// The two transposes go through a per-warp shared slab whose row strides (72
// and 33 floats) make every access conflict-free. Lane L then holds
// Z[L + 32v]; the real-FFT post-step
//   X[k] = (Z[k] + Z*[256-k])/2 - i e^{-2 pi i k/512} (Z[k] - Z*[256-k])/2
// takes Z[256-k] from lane (32 - L) mod 32 by shuffles. |X[k]|^2 goes to a
// per-warp power row in shared memory, and lane m sums mel bin m over its own
// nonzero range [lo_m, hi_m) of mel_t in ascending q, from weights packed
// into shared memory once per block; then logf(fmaxf(., EPSILON)). Twiddles
// come from a float32 table (float64 trig cast, made once per device by the
// wrapper); each lane keeps the 21 it needs in registers for the whole loop
// (118 registers, two blocks an SM: with three blocks an SM the registers
// spill and the kernel runs slower, tools/torch_fbank_ablate.py).
// Arithmetic: float32 on the CUDA cores, no tensor cores, no TF32, no
// library call. On the H100 the FFT and the mel step each take about a
// quarter of the kernel's time, and the loads and the rest the other half
// (tools/torch_fbank_ablate.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps per block, one frame each
constexpr int kThreads = 32 * kWarps;
constexpr int kFft = 512;                  // real transform size
constexpr int kFreq = kFft / 2 + 1;        // 257 frequencies
constexpr int kMaxMel = 128;               // mel bins lane + 32 j, j < 4
constexpr int kMaxWeights = 2 * kFreq;     // each frequency feeds <= 2 kaldi bins
constexpr int kRow1 = 72;                  // pass A -> B slab: 4 rows of 64 (+8)
constexpr int kRow2 = 33;                  // pass B -> C slab: 8 rows of 32 (+1)
constexpr int kSlab = 4 * kRow1;           // 288 floats >= 8 * kRow2
constexpr int kPowerRow = 260;             // 257 floats, padded
constexpr int kWarpFloats = 2 * kSlab + kPowerRow;
constexpr int kMaxDevices = 64;
constexpr float kEpsilon = 1.1920928955078125e-07f;  // kaldi's log floor

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// v[k] = sum_i v[i] W4^(ik), in place
__device__ __forceinline__ void dft4(float2 (&v)[4]) {
  const float2 a0 = add(v[0], v[2]), a2 = sub(v[0], v[2]);
  const float2 a1 = add(v[1], v[3]), a3 = mul_neg_i(sub(v[1], v[3]));
  v[0] = add(a0, a1);
  v[1] = add(a2, a3);
  v[2] = sub(a0, a1);
  v[3] = sub(a2, a3);
}

// v[u] = sum_c v[c] W8^(cu), in place; c = float32(sqrt(1/2)) from the table
__device__ __forceinline__ void dft8(float2 (&v)[8], float c) {
  float2 a[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = add(v[j], v[j + 4]);
    a[j + 4] = sub(v[j], v[j + 4]);
  }
  a[5] = make_float2(c * (a[5].x + a[5].y), c * (a[5].y - a[5].x));    // * W8
  a[6] = mul_neg_i(a[6]);                                               // * W8^2
  a[7] = make_float2(c * (a[7].y - a[7].x), -c * (a[7].x + a[7].y));   // * W8^3
  float2 b[8];
  b[0] = add(a[0], a[2]);
  b[1] = add(a[1], a[3]);
  b[2] = sub(a[0], a[2]);
  b[3] = mul_neg_i(sub(a[1], a[3]));
  b[4] = add(a[4], a[6]);
  b[5] = add(a[5], a[7]);
  b[6] = sub(a[4], a[6]);
  b[7] = mul_neg_i(sub(a[5], a[7]));
  v[0] = add(b[0], b[1]);
  v[4] = sub(b[0], b[1]);
  v[2] = add(b[2], b[3]);
  v[6] = sub(b[2], b[3]);
  v[1] = add(b[4], b[5]);
  v[5] = sub(b[4], b[5]);
  v[3] = add(b[6], b[7]);
  v[7] = sub(b[6], b[7]);
}

// a bin's range [lo, hi) lies in the spectrum and its packed weights in the table
__device__ __forceinline__ bool range_ok(int lo, int hi, int start) {
  return 0 <= lo && lo <= hi && hi <= kFreq && 0 <= start && start + (hi - lo) <= kMaxWeights;
}

// lane's 16-byte pieces L + 32 i of frame f (zeros past the window or F)
__device__ __forceinline__ void load_frame(const float* __restrict__ frames, int f, int n_frames,
                                           int chunks, int lane, float4 (&v)[4]) {
  const float4* row = reinterpret_cast<const float4*>(frames) + (size_t)f * chunks;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < n_frames && c < chunks) v[i] = __ldcs(row + c);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
spec_mel_fft_kernel(const float* __restrict__ frames, const float* __restrict__ mel_t,
                    const float2* __restrict__ tw, const int* __restrict__ ranges,
                    int n_frames, int window, int n_mel, float* __restrict__ out) {
  __shared__ __align__(16) float slabs[kWarps * kWarpFloats];
  __shared__ int bins[3 * kMaxMel];
  __shared__ float weights[kMaxWeights];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = window >> 2;
  const int stride = gridDim.x * kWarps;
  int f = blockIdx.x * kWarps + warp;

  float4 next[4];
  load_frame(frames, f, n_frames, chunks, lane, next);

  // mel ranges and the packed nonzero weights of mel_t, once per block
  for (int e = threadIdx.x; e < 3 * n_mel; e += kThreads) bins[e] = ranges[e];
  __syncthreads();
  for (int m = warp; m < n_mel; m += kWarps) {
    const int lo = bins[3 * m], hi = bins[3 * m + 1], start = bins[3 * m + 2];
    if (!range_ok(lo, hi, start)) continue;
    for (int q = lo + lane; q < hi; q += 32) weights[start + q - lo] = mel_t[(size_t)q * n_mel + m];
  }

  // this lane's twiddles, held in registers for the whole loop: pass A
  // W256^(a k1) = tw[2 a k1] for a = 2 lane + e; pass B W64^(b u) = tw[8 b u]
  // for b = lane & 7; the post-step's tw[lane + 32 v]
  float2 tw_a[2][3], tw_b[7], tw_p[8];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1) tw_a[e][k1 - 1] = tw[2 * (2 * lane + e) * k1];
#pragma unroll
  for (int u = 1; u < 8; ++u) tw_b[u - 1] = tw[8 * (lane & 7) * u];
#pragma unroll
  for (int v = 0; v < 8; ++v) tw_p[v] = tw[lane + 32 * v];
  const float c8 = tw[64].x;
  __syncthreads();

  float* slab_re = slabs + warp * kWarpFloats;
  float* slab_im = slab_re + kSlab;
  float* power = slab_im + kSlab;
  const int row_b = (lane >> 3) * kRow1 + (lane & 7);   // pass B lane (k1, b)
  const int row_c = (lane >> 2) * kRow2 + 8 * (lane & 3);  // pass C lane (k1, u)
  const int partner = (32 - lane) & 31;

  for (; f < n_frames; f += stride) {
    float2 z[2][4];  // z[e][i] = z[2 lane + e + 64 i]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[0][i] = make_float2(next[i].x, next[i].y);
      z[1][i] = make_float2(next[i].z, next[i].w);
    }
    load_frame(frames, f + stride, n_frames, chunks, lane, next);

    // pass A, then slab[k1][a]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dft4(z[e]);
#pragma unroll
      for (int k1 = 1; k1 < 4; ++k1) z[e][k1] = cmul(z[e][k1], tw_a[e][k1 - 1]);
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      *reinterpret_cast<float2*>(slab_re + k1 * kRow1 + 2 * lane) = make_float2(z[0][k1].x, z[1][k1].x);
      *reinterpret_cast<float2*>(slab_im + k1 * kRow1 + 2 * lane) = make_float2(z[0][k1].y, z[1][k1].y);
    }
    __syncwarp();

    // pass B: lane (k1 = lane >> 3, b = lane & 7) over a = b + 8 c
    float2 w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = make_float2(slab_re[row_b + 8 * c], slab_im[row_b + 8 * c]);
    dft8(w, c8);
#pragma unroll
    for (int u = 1; u < 8; ++u) w[u] = cmul(w[u], tw_b[u - 1]);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      slab_re[u * kRow2 + lane] = w[u].x;
      slab_im[u * kRow2 + lane] = w[u].y;
    }
    __syncwarp();

    // pass C: lane (k1 = lane & 3, u = lane >> 2) over b -> w[v] = Z[lane + 32 v]
#pragma unroll
    for (int b = 0; b < 8; ++b) w[b] = make_float2(slab_re[row_c + b], slab_im[row_c + b]);
    dft8(w, c8);

    // real-FFT post-step and power; Z[256 - k] from lane (32 - lane) mod 32
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float2 send = lane == 0 ? w[(8 - v) & 7] : w[7 - v];
      const float pr = __shfl_sync(0xffffffffu, send.x, partner);
      const float pi = __shfl_sync(0xffffffffu, send.y, partner);
      const float2 e = make_float2((w[v].x + pr) * 0.5f, (w[v].y - pi) * 0.5f);
      const float2 d = make_float2((w[v].x - pr) * 0.5f, (w[v].y + pi) * 0.5f);
      const float2 wd = cmul(tw_p[v], d);
      const float xr = e.x + wd.y, xi = e.y - wd.x;
      power[lane + 32 * v] = fmaf(xr, xr, xi * xi);
    }
    if (lane == 0) {
      const float x256 = w[0].x - w[0].y;
      power[kFreq - 1] = x256 * x256;
    }
    __syncwarp();

    // mel bins lane + 32 j over their own ranges, then the log
    float* orow = out + (size_t)f * n_mel;
    for (int m = lane; m < n_mel; m += 32) {
      const int lo = bins[3 * m], hi = bins[3 * m + 1], start = bins[3 * m + 2];
      if (!range_ok(lo, hi, start)) {  // a range the kernel cannot hold: NaN, never a value
        orow[m] = __int_as_float(0x7fc00000);
        continue;
      }
      const float* wt = weights + start - lo;
      float acc = 0.f;
#pragma unroll 4
      for (int q = lo; q < hi; ++q) acc = fmaf(power[q], wt[q], acc);
      orow[m] = logf(fmaxf(acc, kEpsilon));
    }
  }
}

}  // namespace

extern "C" {

// frames f32[n_frames, window] (16-byte aligned, window a multiple of 4 and
// <= n_fft), mel_t f32[n_freq, n_mel] with n_mel <= 128, twiddles
// f32[n_fft, 2] = e^{-2 pi i j / n_fft}, ranges i32[n_mel, 3] = (lo, hi,
// start) of each bin's nonzero rows of mel_t, out f32[n_frames, n_mel]; all
// contiguous on the current device. n_fft must be 512 and n_freq 257.
// Returns the cudaError_t of the launch.
int fbank_spec_mel_launch(const float* frames, const float* mel_t, const float* twiddles,
                          const int* ranges, int n_frames, int window, int n_fft, int n_freq,
                          int n_mel, float* out, void* stream) {
  if (n_frames <= 0 || n_fft != kFft || n_freq != kFreq || window <= 0 || window > kFft ||
      window % 4 != 0 || n_mel < 1 || n_mel > kMaxMel)
    return (int)cudaErrorInvalidValue;
  // resident blocks of the current device, asked once per device
  static int resident_blocks[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int resident = device < kMaxDevices ? resident_blocks[device] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spec_mel_fft_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kMaxDevices) resident_blocks[device] = resident;
  }
  const int wanted = (n_frames + kWarps - 1) / kWarps;
  const int grid = wanted < resident ? wanted : resident;
  spec_mel_fft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, mel_t, reinterpret_cast<const float2*>(twiddles), ranges, n_frames, window, n_mel,
      out);
  return (int)cudaGetLastError();
}

const char* fbank_spec_mel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
