// Kaldi log-mel fbank, one kernel from PCM to features (snip_edges framing).
//
// Replaces: speech2text_tpu/ops/pallas/fbank_kernel.py:fbank_pallas
// (kernel body _fbank_kernel, operands from build_operands).
//
// Computes, per frame t of utterance b (frame = pcm[b, t*shift : t*shift+flen]):
// remove the DC offset, preemphasis (prev[0] = f[0]), window, the power
// spectrum of the frame zero-padded to 512 samples (bins 0..256), the mel
// projection and log(max(mel, FLT_EPSILON)).
//
// The JAX code takes the power spectrum as a product with f32 cos/sin DFT
// matrices, which are the 512-point DFT of the zero-padded frame kept for
// bins 0..256. A 512-point real FFT gives the same spectrum with about 12
// kflop per frame instead of the product's 411 kflop: the frame is packed
// as 256 complex samples z[m] = x[2m] + i x[2m+1], transformed by a radix-4
// Stockham FFT (4 stages, natural order out) and split into the real
// spectrum, X[k] = (Z[k] + conj Z[256-k])/2 + W512^k (Z[k] - conj Z[256-k])/2i.
// Everything stays in f32 (the JAX code asks for Precision.HIGHEST); the
// twiddles W512^k are built once in float64 on the host and passed as f32.
//
// Mel: each kaldi filter has one contiguous run of non-zero bins (found once
// on the host); the sum runs over that run only, in ascending bin order. An
// fmaf(x, 0, acc) leaves acc as it was for finite x >= 0, so this is the
// dense sequential product bit for bit.
//
// What bounds it on the card: bytes, nearly. At B=16 and 10 s the PCM read
// once (10.2 MB) and the features written once (5.1 MB) take 4.6 us at
// 3.35 TB/s; the FFT and sparse mel take about 3 us at the 67 TFLOP/s f32
// rate.
//
// Design: one block of 8 warps per (32 frames, utterance). The block loads
// its frames' PCM span once (frames overlap by flen - shift samples), the
// twiddles and the window into shared memory; each warp then takes one frame
// at a time through preprocessing, FFT, split, mel and log, in one
// 256-complex buffer of its own (each FFT stage reads its inputs into
// registers before it writes), with __syncwarp between steps. 43 KB of
// shared memory per block lets 5 blocks share an SM, so the 512 blocks of
// B=16 at 10 s run in one wave. What holds it back (PERF.md, measured with
// tools/ablate.py): neither bytes (the PCM load and the feature stores cost
// 2% and under 1% of its time) nor flop, but the per-frame chain of
// shared-memory passes and warp synchronisations: the FFT stages take about
// a third of its time and the mel sums a quarter.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FB = 32;          // frames per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NC = 256;         // complex FFT size: the real FFT is 512
constexpr int N_FFT = 2 * NC;
constexpr int N_BINS = NC + 1;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

size_t smem_bytes(int flen, int shift) {
  const int span = (FB - 1) * shift + flen;
  return sizeof(float2) * (N_FFT + (size_t)WARPS * NC) +
         sizeof(float) * (size_t)(((span + 3) & ~3) + ((flen + 3) & ~3));
}

__global__ void __launch_bounds__(THREADS)
    fbank_fft_kernel(const float* __restrict__ pcm, int N, int max_frames,
                     const float* __restrict__ window,
                     const float2* __restrict__ twiddles,
                     const int* __restrict__ runs,  // (n_mels, 3): lo, len, off
                     const float* __restrict__ mel_w,
                     float* __restrict__ out, int flen, int shift, int n_mels,
                     float preemph, int remove_dc, float eps) {
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);      // [N_FFT]: W512^k
  float2* bufs = tw + N_FFT;                          // [WARPS][NC]
  float* win = reinterpret_cast<float*>(bufs + WARPS * NC);
  float* span = win + ((flen + 3) & ~3);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FB;
  const int nf = min(FB, max_frames - t0);
  const int nspan = (nf - 1) * shift + flen;
  const float* x = pcm + (size_t)b * N + (size_t)t0 * shift;
  for (int i = threadIdx.x; i < nspan; i += THREADS) span[i] = x[i];
  for (int i = threadIdx.x; i < N_FFT; i += THREADS) tw[i] = twiddles[i];
  for (int i = threadIdx.x; i < flen; i += THREADS) win[i] = window[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* A = bufs + warp * NC;
  for (int f = warp; f < nf; f += WARPS) {
    const float* fr = span + f * shift;

    // 1. DC offset, preemphasis and window; pack z[m] = v[2m] + i v[2m+1]
    float mean = 0.f;
    if (remove_dc) {
      float s = 0.f;
      for (int n = lane; n < flen; n += 32) s += fr[n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / (float)flen;
    }
#pragma unroll
    for (int i = 0; i < NC / 32; ++i) {
      const int m = lane + 32 * i;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * m + e;
        v[e] = 0.f;
        if (n < flen) {
          const float cur = fr[n] - mean;
          const float prev = fr[n > 0 ? n - 1 : 0] - mean;
          v[e] = (cur - preemph * prev) * win[n];
        }
      }
      A[m] = make_float2(v[0], v[1]);
    }
    __syncwarp();

    // 2. 256-point complex FFT, radix-4 Stockham: stage st has stride
    //    s = 4^st and span n = 256 / s; butterfly i = p*s + q reads
    //    i, i+64, i+128, i+192 and writes q + s*(4p + r), r = 0..3.
    //    Each lane reads its two butterflies' inputs into registers before
    //    any lane writes, so one buffer serves as source and destination.
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int ls = 2 * st;
      float2 in[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) in[h][r] = A[lane + 32 * h + 64 * r];
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        const int p = i >> ls, q = i & ((1 << ls) - 1);
        const float2 apc = cadd(in[h][0], in[h][2]), amc = csub(in[h][0], in[h][2]);
        const float2 bpd = cadd(in[h][1], in[h][3]), bmd = csub(in[h][1], in[h][3]);
        const float2 jbmd = make_float2(-bmd.y, bmd.x);  // i (b - d)
        const int ps = p << ls;  // W256^(p s) = W512^(2 p s)
        float2* o = A + q + (p << (ls + 2));
        o[0] = cadd(apc, bpd);
        if (st < 3) {
          o[1 << ls] = cmul(tw[2 * ps], csub(amc, jbmd));
          o[2 << ls] = cmul(tw[4 * ps], csub(apc, bpd));
          o[3 << ls] = cmul(tw[6 * ps], cadd(amc, jbmd));
        } else {  // the last stage has p = 0: every twiddle is 1
          o[1 << ls] = csub(amc, jbmd);
          o[2 << ls] = csub(apc, bpd);
          o[3 << ls] = cadd(amc, jbmd);
        }
      }
      __syncwarp();
    }

    // 3. split into the real spectrum; the power of bins 0..256 replaces
    //    the spectrum in A once every lane has read its bins
    float pk[(N_BINS + 31) / 32];
#pragma unroll
    for (int i = 0; i < (N_BINS + 31) / 32; ++i) {
      const int k = lane + 32 * i;
      if (k < N_BINS) {
        const float2 zk = A[k & (NC - 1)], zn = A[(NC - k) & (NC - 1)];
        const float2 fe = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
        const float2 fo = make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x));
        const float2 X = cadd(fe, cmul(tw[k], fo));
        pk[i] = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
      }
    }
    __syncwarp();
    float* pw = reinterpret_cast<float*>(A);
#pragma unroll
    for (int i = 0; i < (N_BINS + 31) / 32; ++i)
      if (lane + 32 * i < N_BINS) pw[lane + 32 * i] = pk[i];
    __syncwarp();

    // 4. mel over each filter's run of bins, log
    float* orow = out + ((size_t)b * max_frames + t0 + f) * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = __ldg(runs + 3 * m), len = __ldg(runs + 3 * m + 1),
                off = __ldg(runs + 3 * m + 2);
      float acc = 0.f;
      for (int j = 0; j < len; ++j)
        acc = fmaf(pw[lo + j], __ldg(mel_w + off + j), acc);
      orow[m] = logf(fmaxf(acc, eps));
    }
    __syncwarp();  // A is free for the next frame
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pcm (B, N) f32; window (flen) f32; twiddles (512, 2) f32, row k =
// (cos, -sin)(2 pi k / 512); runs (n_mels, 3) int32 = first bin, number of
// bins, offset into mel_w; mel_w f32, each filter's run of weights;
// out (B, max_frames, n_mels) f32; all contiguous. flen <= 512.
// Returns cudaGetLastError() after the launch.
int fbank_forward(const void* pcm, const void* window, const void* twiddles,
                  const void* runs, const void* mel_w, void* out, int B,
                  int N, int max_frames, int flen, int shift, int n_mels,
                  float preemph, int remove_dc, float eps, void* stream) {
  static bool done[MAX_DEVICES];
  if (B <= 0 || max_frames <= 0 || flen <= 0 || flen > N_FFT || shift <= 0 ||
      n_mels <= 0 || (size_t)(max_frames - 1) * shift + flen > (size_t)N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(flen, shift);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !done[dev]) {
    e = cudaFuncSetAttribute(fbank_fft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) done[dev] = true;
  }
  dim3 grid((max_frames + FB - 1) / FB, B);
  fbank_fft_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcm), N, max_frames,
      static_cast<const float*>(window), static_cast<const float2*>(twiddles),
      static_cast<const int*>(runs), static_cast<const float*>(mel_w),
      static_cast<float*>(out), flen, shift, n_mels, preemph, remove_dc, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
