// Kaldi log-mel fbank, one kernel from PCM to features (snip_edges framing).
//
// Replaces: speech2text_tpu/ops/pallas/fbank_kernel.py:fbank_pallas
// (kernel body _fbank_kernel, operands from build_operands).
//
// Computes, per frame t of utterance b (frame = pcm[b, t*shift : t*shift+flen]):
// remove the DC offset, preemphasis (prev[0] = f[0]), window, the power
// spectrum through the same f32 cos/sin DFT matrices as the JAX code
// (flen x n_bins, zero padding to the FFT size folded in), the mel
// projection (n_mels x n_bins) and log(max(mel, FLT_EPSILON)).
//
// What bounds it on the card: arithmetic. The two DFT products are
// 4*flen*n_bins flop per frame (411 kflop at 400 x 257) against 1.6 kB of
// PCM in and 320 B of features out, and they run in full f32 (the JAX code
// asks for Precision.HIGHEST), so the tensor cores' TF32 is not allowed:
// the bound is the card's f32 FMA rate.
//
// Design: one block per (32 frames, utterance). The block frames the PCM by
// index (no hop-shifted views, no padding to 384 bins / 128 mels: those were
// TPU layout workarounds), keeps its 32 frames in shared memory and
// preprocesses them there (one warp per frame). For the DFT each thread owns
// one frequency bin and keeps 32 real and 32 imaginary sums in registers, so
// one coalesced read of a cos/sin matrix entry feeds 32 FMAs, and the frame
// samples come from shared memory as broadcast float4 reads. The power
// spectrum then replaces the frames in shared memory, and the mel
// projection reads it with a stride of n_bins (odd: no bank conflicts).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FT = 32;        // frames per block
constexpr int MAX_PER_LANE = 16;  // flen <= 32 * 16
constexpr int MAX_THREADS = 288;  // one thread per bin: n_bins <= 288

__global__ void __launch_bounds__(MAX_THREADS) fbank_kernel(const float* __restrict__ pcm, int N,
                             int max_frames,
                             const float* __restrict__ window,
                             const float* __restrict__ dft_cos,
                             const float* __restrict__ dft_sin,
                             const float* __restrict__ banks,
                             float* __restrict__ out, int flen, int ldf,
                             int shift, int n_bins, int n_mels,
                             float preemph, int remove_dc, float eps) {
  extern __shared__ float4 smem4[];
  float* fr = reinterpret_cast<float*>(smem4);  // [FT][ldf], ldf % 4 == 0
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int nf = min(FT, max_frames - t0);
  const float* x = pcm + (size_t)b * N;

  // 1. frames by index; rows past nf and columns past flen are zero
  for (int i = threadIdx.x; i < FT * ldf; i += blockDim.x) {
    const int f = i / ldf, n = i - f * ldf;
    fr[i] = (f < nf && n < flen) ? x[(size_t)(t0 + f) * shift + n] : 0.f;
  }
  __syncthreads();

  // 2. DC removal, preemphasis, window: one warp per frame
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int f = warp; f < nf; f += nwarps) {
    float* row = fr + f * ldf;
    float mean = 0.f;
    if (remove_dc) {
      float s = 0.f;
      for (int n = lane; n < flen; n += 32) s += row[n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / (float)flen;
    }
    float v[MAX_PER_LANE];
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      const int n = lane + 32 * i;
      if (n < flen) {
        const float cur = row[n] - mean;
        const float prev = row[n > 0 ? n - 1 : 0] - mean;
        v[i] = (cur - preemph * prev) * window[n];
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      const int n = lane + 32 * i;
      if (n < flen) row[n] = v[i];
    }
  }
  __syncthreads();

  // 3. real DFT: thread k owns bin k for all FT frames
  const int k = threadIdx.x;
  float re[FT], im[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
  if (k < n_bins) {
    const int n4 = flen & ~3;
    for (int n = 0; n < n4; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(dft_cos + (size_t)(n + j) * n_bins + k);
        s[j] = __ldg(dft_sin + (size_t)(n + j) * n_bins + k);
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float4 a = *reinterpret_cast<const float4*>(fr + f * ldf + n);
        re[f] = fmaf(a.x, c[0], re[f]);
        im[f] = fmaf(a.x, s[0], im[f]);
        re[f] = fmaf(a.y, c[1], re[f]);
        im[f] = fmaf(a.y, s[1], im[f]);
        re[f] = fmaf(a.z, c[2], re[f]);
        im[f] = fmaf(a.z, s[2], im[f]);
        re[f] = fmaf(a.w, c[3], re[f]);
        im[f] = fmaf(a.w, s[3], im[f]);
      }
    }
    for (int n = n4; n < flen; ++n) {
      const float c = __ldg(dft_cos + (size_t)n * n_bins + k);
      const float s = __ldg(dft_sin + (size_t)n * n_bins + k);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        re[f] = fmaf(fr[f * ldf + n], c, re[f]);
        im[f] = fmaf(fr[f * ldf + n], s, im[f]);
      }
    }
  }
  __syncthreads();  // every thread is done with the frames

  // 4. power spectrum over the frames' storage: pw[f][k], row stride n_bins
  float* pw = fr;
  if (k < n_bins) {
#pragma unroll
    for (int f = 0; f < FT; ++f)
      pw[f * n_bins + k] = __fadd_rn(__fmul_rn(re[f], re[f]),
                                     __fmul_rn(im[f], im[f]));
  }
  __syncthreads();

  // 5. mel projection and log; consecutive threads take consecutive frames
  for (int i = threadIdx.x; i < FT * n_mels; i += blockDim.x) {
    const int m = i / FT, f = i - m * FT;
    if (f >= nf) continue;
    const float* p = pw + f * n_bins;
    const float* w = banks + (size_t)m * n_bins;
    float acc = 0.f;
    for (int j = 0; j < n_bins; ++j) acc = fmaf(p[j], __ldg(w + j), acc);
    out[((size_t)b * max_frames + t0 + f) * n_mels + m] = logf(fmaxf(acc, eps));
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pcm (B, N) f32; window (flen); dft_cos, dft_sin (flen, n_bins);
// banks (n_mels, n_bins); out (B, max_frames, n_mels) f32, all contiguous.
// Returns cudaGetLastError() after the launch.
int fbank_forward(const void* pcm, const void* window, const void* dft_cos,
                  const void* dft_sin, const void* banks, void* out, int B,
                  int N, int max_frames, int flen, int shift, int n_bins,
                  int n_mels, float preemph, int remove_dc, float eps,
                  void* stream) {
  if (B <= 0 || max_frames <= 0 || flen > 32 * MAX_PER_LANE || n_bins > MAX_THREADS ||
      n_mels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldf = (flen + 3) & ~3;
  const int threads = ((n_bins + 31) / 32) * 32;
  size_t smem = sizeof(float) * (size_t)FT * ldf;
  const size_t smem_pw = sizeof(float) * (size_t)FT * n_bins;
  if (smem_pw > smem) smem = smem_pw;
  cudaError_t e = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((max_frames + FT - 1) / FT, B);
  fbank_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcm), N, max_frames,
      static_cast<const float*>(window), static_cast<const float*>(dft_cos),
      static_cast<const float*>(dft_sin), static_cast<const float*>(banks),
      static_cast<float*>(out), flen, ldf, shift, n_bins, n_mels, preemph,
      remove_dc, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
