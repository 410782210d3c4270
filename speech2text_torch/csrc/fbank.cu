// Kaldi log-mel fbank, one kernel from PCM to features, at every FFT size
// from 128 to 2048 points, with either framing and optional dither.
//
// Replaces: speech2text_tpu/ops/pallas/fbank_kernel.py:fbank_pallas
// (kernel body _fbank_kernel, operands from build_operands), and the jnp
// route of speech2text_tpu/data/frontend.py:_fbank_impl that the JAX
// package takes for centred framing and dither.
//
// Computes, per frame t of utterance b: the frame (snip_edges: samples
// t*shift .. t*shift+flen-1; centred: from t*shift + shift/2 - flen/2,
// indices reflected at both edges as frame_signal reflects them), plus
// dither * noise[b, t, :] when a noise operand is given, then the DC
// offset removed, preemphasis (prev[0] = f[0]), window, the power
// spectrum of the frame zero-padded to n_fft samples (bins 0..n_fft/2),
// the mel projection and log(max(mel, FLT_EPSILON)).
//
// The JAX code takes the power spectrum as a product with f32 cos/sin DFT
// matrices, which are the n_fft-point DFT of the zero-padded frame kept
// for bins 0..n_fft/2. A real FFT gives the same spectrum with a small
// share of the product's operations (12 against 411 kflop per frame at 512
// points): the frame is packed as NC = n_fft/2 complex samples
// z[m] = x[2m] + i x[2m+1], transformed by a Stockham FFT (radix-4 stages,
// then one radix-2 stage where NC is not a power of four; natural order
// out) and split into the real spectrum,
// X[k] = (Z[k] + conj Z[NC-k])/2 + W^k (Z[k] - conj Z[NC-k])/2i, W the
// n_fft-th root of unity. Everything stays in f32 (the JAX code asks for
// Precision.HIGHEST); the twiddles W^k are built once in float64 on the
// host and passed as f32. One kernel per NC (64 .. 1024) is instantiated;
// the entry picks it from n_fft.
//
// Mel: each kaldi filter has one contiguous run of non-zero bins (found once
// on the host); the sum runs over that run only, in ascending bin order. An
// fmaf(x, 0, acc) leaves acc as it was for finite x >= 0, so this is the
// dense sequential product bit for bit.
//
// What bounds it on the card: bytes, nearly. At B=16 and 10 s of 16 kHz the
// PCM read once (10.2 MB) and the features written once (5.1 MB) take
// 4.6 us at 3.35 TB/s; the FFT and sparse mel take about 3 us at the
// 67 TFLOP/s f32 rate. Dither adds its noise operand, (B, frames, flen)
// f32, read once: 2.5 times the PCM's bytes at 25 ms / 10 ms framing.
//
// Design: one block of 8 warps per (FB frames, utterance), FB = 32 unless
// the block's shared memory would pass 227 KB (then halved until it fits).
// The block loads its frames' PCM span once through the framing's index
// map (frames overlap by flen - shift samples), the twiddles and the window
// into shared memory; each warp then takes one frame at a time through
// dither, preprocessing, FFT, split, mel and log, in one NC-complex buffer
// of its own (each step reads its inputs into registers before it writes),
// with __syncwarp between steps. With dither the warp first writes the
// frame plus its noise into that buffer, so the DC mean and preemphasis's
// previous sample both see the dithered values. At 512 points, 43 KB of
// shared memory per block lets 5 blocks share an SM, so the 512 blocks of
// B=16 at 10 s run in one wave. What holds it back there (PERF.md,
// measured with tools/ablate.py): neither bytes (the PCM load and the
// feature stores cost 2% and under 1% of its time) nor flop, but the
// per-frame chain of shared-memory passes and warp synchronisations: the
// FFT stages take about a third of its time and the mel sums a quarter.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FB_MAX = 32;      // frames per block where shared memory allows
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_N_FFT = 128;
constexpr int MAX_N_FFT = 2048;
constexpr size_t SMEM_LIMIT = 227 * 1024;
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

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

size_t smem_bytes(int nc, int fb, int flen, int shift) {
  const int span = (fb - 1) * shift + flen;
  return sizeof(float2) * (2 * (size_t)nc + (size_t)WARPS * nc) +
         sizeof(float) * (size_t)(((span + 3) & ~3) + ((flen + 3) & ~3));
}

// The sample that signal position j reads: snip_edges framing stays in
// range; centred framing reflects below 0 (-j-1) and at N or above
// (2N-1-j), in that order, then clamps, as frame_signal does.
__device__ __forceinline__ int frame_index(int j, int N, int snip) {
  if (!snip) {
    j = j < 0 ? -j - 1 : j;
    j = j >= N ? 2 * N - 1 - j : j;
  }
  return min(max(j, 0), N - 1);
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
    fbank_fft_kernel(const float* __restrict__ pcm, int N, int max_frames,
                     int fb, int snip, const float* __restrict__ noise,
                     float dither, const float* __restrict__ window,
                     const float2* __restrict__ twiddles,
                     const int* __restrict__ runs,  // (n_mels, 3): lo, len, off
                     const float* __restrict__ mel_w,
                     float* __restrict__ out, int flen, int shift, int n_mels,
                     float preemph, int remove_dc, float eps) {
  constexpr int N_FFT = 2 * NC;
  constexpr int N_BINS = NC + 1;
  constexpr int BFLY = NC / 4;                 // radix-4 butterflies a stage
  constexpr int H = (BFLY + 31) / 32;          // of them per lane
  constexpr int R4_STAGES = ilog2(NC) / 2;
  constexpr bool RADIX2 = ilog2(NC) % 2 == 1;  // NC = 2 * 4^R4_STAGES
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);      // [N_FFT]: W^k
  float2* bufs = tw + N_FFT;                          // [WARPS][NC]
  float* win = reinterpret_cast<float*>(bufs + WARPS * NC);
  float* span = win + ((flen + 3) & ~3);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * fb;
  const int nf = min(fb, max_frames - t0);
  const int nspan = (nf - 1) * shift + flen;
  const float* x = pcm + (size_t)b * N;
  const int first = t0 * shift + (snip ? 0 : shift / 2 - flen / 2);
  for (int i = threadIdx.x; i < nspan; i += THREADS)
    span[i] = x[frame_index(first + i, N, snip)];
  for (int i = threadIdx.x; i < N_FFT; i += THREADS) tw[i] = twiddles[i];
  for (int i = threadIdx.x; i < flen; i += THREADS) win[i] = window[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* A = bufs + warp * NC;
  float* Af = reinterpret_cast<float*>(A);  // 2 NC = N_FFT >= flen floats
  for (int f = warp; f < nf; f += WARPS) {
    const float* fr = span + f * shift;

    // 0. dither: the frame plus its noise, into the warp's buffer
    if (noise) {
      const float* nz = noise + ((size_t)b * max_frames + t0 + f) * flen;
      for (int n = lane; n < flen; n += 32)
        Af[n] = __fadd_rn(fr[n], __fmul_rn(dither, __ldg(nz + n)));
      __syncwarp();
      fr = Af;
    }

    // 1. DC offset, preemphasis and window; pack z[m] = v[2m] + i v[2m+1]
    //    (read into registers first: fr may be the buffer written here)
    float mean = 0.f;
    if (remove_dc) {
      float s = 0.f;
      for (int n = lane; n < flen; n += 32) s += fr[n];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / (float)flen;
    }
    float2 z[NC / 32];
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
      z[i] = make_float2(v[0], v[1]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NC / 32; ++i) A[lane + 32 * i] = z[i];
    __syncwarp();

    // 2. NC-point complex FFT, Stockham: radix-4 stage st has stride
    //    s = 4^st and span n = NC / s; butterfly i = p*s + q reads
    //    i + r*NC/4 (r = 0..3) and writes q + s*(4p + r) times W_n^(p r)
    //    = W^(2 p s r). Each lane reads its butterflies' inputs into
    //    registers before any lane writes, so one buffer serves as source
    //    and destination.
#pragma unroll
    for (int st = 0; st < R4_STAGES; ++st) {
      const int ls = 2 * st;
      float2 in[H][4];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int i = lane + 32 * h;
        if (BFLY % 32 == 0 || i < BFLY)
#pragma unroll
          for (int r = 0; r < 4; ++r) in[h][r] = A[i + BFLY * r];
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int i = lane + 32 * h;
        if (BFLY % 32 != 0 && i >= BFLY) continue;
        const int p = i >> ls, q = i & ((1 << ls) - 1);
        const float2 apc = cadd(in[h][0], in[h][2]), amc = csub(in[h][0], in[h][2]);
        const float2 bpd = cadd(in[h][1], in[h][3]), bmd = csub(in[h][1], in[h][3]);
        const float2 jbmd = make_float2(-bmd.y, bmd.x);  // i (b - d)
        const int ps = p << ls;
        float2* o = A + q + (p << (ls + 2));
        o[0] = cadd(apc, bpd);
        if ((NC >> ls) > 4) {
          o[1 << ls] = cmul(tw[2 * ps], csub(amc, jbmd));
          o[2 << ls] = cmul(tw[4 * ps], csub(apc, bpd));
          o[3 << ls] = cmul(tw[6 * ps], cadd(amc, jbmd));
        } else {  // a stage of span 4 has p = 0: every twiddle is 1
          o[1 << ls] = csub(amc, jbmd);
          o[2 << ls] = csub(apc, bpd);
          o[3 << ls] = cadd(amc, jbmd);
        }
      }
      __syncwarp();
    }
    if constexpr (RADIX2) {  // the last stage: stride NC/2, span 2, p = 0
#pragma unroll
      for (int h = 0; h < NC / 64; ++h) {   // in place: a lane's own pairs
        const int i = lane + 32 * h;
        const float2 a = A[i], c = A[i + NC / 2];
        A[i] = cadd(a, c);
        A[i + NC / 2] = csub(a, c);
      }
      __syncwarp();
    }

    // 3. split into the real spectrum; the power of bins 0..NC replaces
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
    float* pw = Af;
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

template <int NC>
cudaError_t launch(int fb, size_t smem, cudaStream_t stream,
                   const float* pcm, int B, int N, int max_frames, int snip,
                   const float* noise, float dither, const float* window,
                   const float2* twiddles, const int* runs,
                   const float* mel_w, float* out, int flen, int shift,
                   int n_mels, float preemph, int remove_dc, float eps) {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !done[dev]) {
    e = cudaFuncSetAttribute(fbank_fft_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) done[dev] = true;
  }
  dim3 grid((max_frames + fb - 1) / fb, B);
  fbank_fft_kernel<NC><<<grid, THREADS, smem, stream>>>(
      pcm, N, max_frames, fb, snip, noise, dither, window, twiddles, runs,
      mel_w, out, flen, shift, n_mels, preemph, remove_dc, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pcm (B, N) f32; window (flen) f32; twiddles (n_fft, 2) f32, row k =
// (cos, -sin)(2 pi k / n_fft); runs (n_mels, 3) int32 = first bin, number
// of bins, offset into mel_w; mel_w f32, each filter's run of weights;
// out (B, max_frames, n_mels) f32; noise (B, max_frames, flen) f32 or null
// (no dither); all contiguous. n_fft a power of two in [128, 2048],
// flen <= n_fft; snip != 0 frames with snip_edges, else centred.
// Returns cudaGetLastError() after the launch.
int fbank_forward(const void* pcm, const void* window, const void* twiddles,
                  const void* runs, const void* mel_w, void* out,
                  const void* noise, int B, int N, int max_frames, int flen,
                  int shift, int n_mels, int n_fft, int snip, float preemph,
                  int remove_dc, float eps, float dither, void* stream) {
  if (B <= 0 || N <= 0 || max_frames <= 0 || flen <= 0 || shift <= 0 ||
      n_mels <= 0 || n_fft < MIN_N_FFT || n_fft > MAX_N_FFT ||
      (n_fft & (n_fft - 1)) != 0 || flen > n_fft)
    return static_cast<int>(cudaErrorInvalidValue);
  if (snip ? (size_t)(max_frames - 1) * shift + flen > (size_t)N
           : max_frames > (N + shift / 2) / shift)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = n_fft / 2;
  int fb = FB_MAX;
  while (fb > 1 && smem_bytes(nc, fb, flen, shift) > SMEM_LIMIT) fb /= 2;
  const size_t smem = smem_bytes(nc, fb, flen, shift);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pcm);
  const float* nz = static_cast<const float*>(noise);
  const float* w = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddles);
  const int* r = static_cast<const int*>(runs);
  const float* mw = static_cast<const float*>(mel_w);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  switch (nc) {
#define FBANK_CASE(NCV)                                                       \
  case NCV:                                                                   \
    e = launch<NCV>(fb, smem, s, p, B, N, max_frames, snip, nz, dither, \
                    w, tw, r, mw, o, flen, shift, n_mels, preemph, remove_dc, \
                    eps);                                                     \
    break;
    FBANK_CASE(64)
    FBANK_CASE(128)
    FBANK_CASE(256)
    FBANK_CASE(512)
    FBANK_CASE(1024)
#undef FBANK_CASE
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
