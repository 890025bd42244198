// Fused DFT -> power -> mel -> log of kaldi log-fbank for Hopper (sm_90a).
//
// Replaces opentransformer_tpu/ops/fbank_pallas.py:_spec_mel_kernel (the
// Pallas kernel behind fbank_pallas / fbank_pallas_batch). For each windowed
// frame x (a row of frames [F, W], W = 400 samples at 16 kHz) it computes
//   re[q] = sum_k x[k] cos[k][q],  im[q] = sum_k x[k] sin[k][q]
//   power[q] = re[q]^2 + im[q]^2                  (Q = 257 real frequencies)
//   out[m] = log(max(sum_q power[q] mel_t[q][m], EPSILON))    (M <= 128 bins)
// where cos/sin are the real DFT bases of a 512-point transform of the
// W-sample window. The [F, Q] power spectrum never reaches device memory.
//
// Arithmetic: true float32 FMA on the CUDA cores. No tensor cores (TF32
// keeps ~10 mantissa bits; the TPU kernel's note records that reduced
// precision passes cost ~0.5 in log-mel), no library product.
//
// What bounds it on this card: at the training shape (16 utterances of 10 s,
// F = 15,968 frames, M = 40) the dense DFT and mel products are ~0.43 MFLOP
// a frame, 6.9 GFLOP in all, against ~29 MB of frames, bases and output, so
// it is bound by operations: ~0.10 ms at the 67 TFLOP/s float32 rate.
//
// Design, against the TPU kernel: there one grid step holds a 128-frame block
// and all of C, S (lane-padded to 512 x 384) and the mel matrix in VMEM, and
// the MXU does three matmuls. Here a block owns 64 frames and walks the 257
// frequencies in tiles of 32: for each tile it accumulates re and im in
// registers over the window, staged through shared memory 32 samples at a
// time, squares and adds them into a shared power tile, and folds that tile
// into its mel accumulators, which stay in registers for the whole block.
// The log is taken once at the end. Thread (ty, tx) of the 16 x 16 grid owns
// frames ty + 16 i (i < 4), DFT frequencies 2 tx and 2 tx + 1 of the tile
// (read as one float2 per basis) and mel bins tx + 16 j (j < MG, a template
// argument, so M = 40 runs 3 groups and not 8). Padding past W, Q, F and M
// is zero-filled on load, so no branch sits in the inner loops. This is the
// simple kernel: no cp.async double buffering, no 3xTF32 tensor-core split,
// no FFT formulation; those are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;      // frames per block
constexpr int kFreqs = 32;       // DFT frequencies per tile
constexpr int kDepth = 32;       // window samples per staged chunk
constexpr int kMaxMelGroups = 8; // mel bins tx + 16 j, j < groups: M <= 128
constexpr float kEpsilon = 1.1920928955078125e-07f;  // kaldi's log floor

template <int MG>
__global__ void __launch_bounds__(kThreads, 2)
spec_mel_kernel(const float* __restrict__ frames, const float* __restrict__ cos_b,
                const float* __restrict__ sin_b, const float* __restrict__ mel_t,
                int n_frames, int window, int n_freq, int n_mel,
                float* __restrict__ out) {
  __shared__ float fs[kFrames][kDepth + 1];
  __shared__ __align__(16) float cs[kDepth][kFreqs];
  __shared__ __align__(16) float ss[kDepth][kFreqs];
  __shared__ float ps[kFrames][kFreqs + 1];
  __shared__ float ms[kFreqs][16 * MG];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int f0 = blockIdx.x * kFrames;

  float acc[4][MG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MG; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < n_freq; q0 += kFreqs) {
    float re[4][2], im[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      re[i][0] = re[i][1] = 0.f;
      im[i][0] = im[i][1] = 0.f;
    }
    for (int k0 = 0; k0 < window; k0 += kDepth) {
      // stage frames [f0, f0 + 64) x [k0, k0 + 32) and the bases' chunk
      for (int e = tid; e < kFrames * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int f = f0 + r, k = k0 + c;
        fs[r][c] = (f < n_frames && k < window) ? frames[(size_t)f * window + k] : 0.f;
      }
      for (int e = tid; e < kDepth * kFreqs; e += kThreads) {
        const int r = e / kFreqs, c = e % kFreqs;
        const int k = k0 + r, q = q0 + c;
        const bool ok = k < window && q < n_freq;
        cs[r][c] = ok ? cos_b[(size_t)k * n_freq + q] : 0.f;
        ss[r][c] = ok ? sin_b[(size_t)k * n_freq + q] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepth; ++kk) {
        const float2 c = *reinterpret_cast<const float2*>(&cs[kk][2 * tx]);
        const float2 s = *reinterpret_cast<const float2*>(&ss[kk][2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = fs[ty + 16 * i][kk];
          re[i][0] = fmaf(a, c.x, re[i][0]);
          re[i][1] = fmaf(a, c.y, re[i][1]);
          im[i][0] = fmaf(a, s.x, im[i][0]);
          im[i][1] = fmaf(a, s.y, im[i][1]);
        }
      }
      __syncthreads();
    }

    // this tile's power spectrum and mel rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ps[ty + 16 * i][2 * tx + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    for (int e = tid; e < kFreqs * 16 * MG; e += kThreads) {
      const int r = e / (16 * MG), c = e % (16 * MG);
      const int q = q0 + r;
      ms[r][c] = (q < n_freq && c < n_mel) ? mel_t[(size_t)q * n_mel + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kFreqs; ++q) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < MG; ++j) {
        const float w = ms[q][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int m = tx + 16 * j;
      if (m < n_mel) out[(size_t)f * n_mel + m] = logf(fmaxf(acc[i][j], kEpsilon));
    }
  }
}

template <int MG>
void launch(const float* frames, const float* cos_b, const float* sin_b,
            const float* mel_t, int n_frames, int window, int n_freq, int n_mel,
            float* out, cudaStream_t stream) {
  const dim3 grid((n_frames + kFrames - 1) / kFrames);
  spec_mel_kernel<MG><<<grid, kThreads, 0, stream>>>(frames, cos_b, sin_b, mel_t, n_frames,
                                                     window, n_freq, n_mel, out);
}

}  // namespace

extern "C" {

// frames f32[n_frames, window], cos_b / sin_b f32[window, n_freq],
// mel_t f32[n_freq, n_mel] with n_mel <= 128, out f32[n_frames, n_mel]; all
// contiguous on the same device. Returns the cudaError_t of the launch.
int fbank_spec_mel_launch(const float* frames, const float* cos_b, const float* sin_b,
                          const float* mel_t, int n_frames, int window, int n_freq,
                          int n_mel, float* out, void* stream) {
  if (n_frames <= 0 || window <= 0 || n_freq <= 0 || n_mel < 1 ||
      n_mel > 16 * kMaxMelGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n_mel + 15) / 16) {
    case 1: launch<1>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 2: launch<2>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 3: launch<3>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 4: launch<4>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 5: launch<5>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 6: launch<6>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    case 7: launch<7>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
    default: launch<8>(frames, cos_b, sin_b, mel_t, n_frames, window, n_freq, n_mel, out, s); break;
  }
  return (int)cudaGetLastError();
}

const char* fbank_spec_mel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
