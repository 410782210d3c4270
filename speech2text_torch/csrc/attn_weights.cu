// Zipformer attention weights: scores, relative-position scores, clip, mask
// and row softmax in one kernel, the (B, H, T, T) weights written once.
//
// Replaces: speech2text_tpu/ops/pallas/flash_attn.py:_flash_weights (kernel
// body _weights_kernel), the forward of zip_weights.
//
// Computes, for query t and key s of head h in utterance b:
//   s = q[b,t,h]·k[b,s,h] / sqrt(qd) + sum_d qp[b,t,h,d] * p[(t-s)+T-1, h, d] / sqrt(pd)
//   s = clip(s, -100, 100); s = mask[b,t,s] ? s : -1e30;  w = softmax_s(s)
// in f32 from bf16 or f32 inputs, and writes w in the model's dtype. A query
// row whose keys are all masked gets uniform weights, as in JAX.
//
// What bounds it on the card: the output. B*H*T^2 weights are written once
// (31 MB of bf16 at B=16, H=4, T=494), against 2*B*H*T^2*(qd+pd) flop
// (1.1 Gflop there) and inputs of a few MB; the bytes bound it.
//
// Design: one block per (tile of tq query rows, head, utterance). The TPU
// kernel builds a batch-free Toeplitz tensor P[h,d,t,s] in HBM because
// diagonal extraction is slow on a TPU; here the rows of the per-head table
// p[:, h, :] that the tile needs (T+tq-1 of them, 8 kB at T=494) sit in
// shared memory, stored d-major, and thread s reads p[(t-s)+T-1] directly:
// neighbouring threads read neighbouring words. The tile's queries are in
// shared memory (broadcast reads); each thread holds one key row in
// registers and scores it against all tq queries, so keys are read once per
// tile. The tile's score rows stay in shared memory for a two-pass softmax
// (one warp per row: max, then exp and sum, then the normalised write, whose
// stores are coalesced along s). Nothing but the weights reaches HBM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TQ = 32;
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// QD contiguous elements → f32 registers through 16-byte loads
// (QD * sizeof(TI) is a multiple of 16; the wrapper checks alignment).
template <typename TI, int QD>
__device__ __forceinline__ void load_row(const TI* __restrict__ src,
                                         float* dst) {
  constexpr int PER = 16 / sizeof(TI);
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < QD / PER; ++i) {
    const uint4 u = __ldg(s4 + i);
    const TI* e = reinterpret_cast<const TI*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) dst[i * PER + j] = to_f(e[j]);
  }
}

template <typename TI, int QD>
__global__ void __launch_bounds__(THREADS)
    attn_weights_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                        const TI* __restrict__ qp, const TI* __restrict__ p,
                        const unsigned char* __restrict__ mask,
                        TI* __restrict__ out, int T, int H, int pd, int tq) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [tq][T] scores
  float* qs = S + (((size_t)tq * T + 3) & ~(size_t)3);  // [tq][QD], 16 B aligned
  float* qps = qs + tq * QD;                   // [tq][pd]
  float* ptab = qps + tq * pd;                 // [pd][nrow] table rows t0..
  const int nrow = T + tq - 1;

  const int t0 = blockIdx.x * tq, h = blockIdx.y, b = blockIdx.z;
  const int nr = min(tq, T - t0);
  const int tid = threadIdx.x;

  for (int i = tid; i < tq * QD; i += THREADS) {
    const int r = i / QD, d = i - r * QD;
    qs[i] = r < nr ? to_f(q[(((size_t)b * T + t0 + r) * H + h) * QD + d]) : 0.f;
  }
  for (int i = tid; i < tq * pd; i += THREADS) {
    const int r = i / pd, d = i - r * pd;
    qps[i] = r < nr ? to_f(qp[(((size_t)b * T + t0 + r) * H + h) * pd + d]) : 0.f;
  }
  // local row j holds p[t0 + j]: query t0+r, key s → j = r - s + T - 1
  for (int i = tid; i < pd * nrow; i += THREADS) {
    const int d = i / nrow, j = i - d * nrow;
    const int g = t0 + j;
    ptab[i] = g < 2 * T - 1 ? to_f(p[((size_t)g * H + h) * pd + d]) : 0.f;
  }
  __syncthreads();

  const float inv_qd = 1.f / sqrtf((float)QD);
  const float inv_pd = 1.f / sqrtf((float)pd);
  const unsigned char* mrow =
      mask ? mask + ((size_t)b * T + t0) * T : nullptr;
  for (int s = tid; s < T; s += THREADS) {
    float kr[QD];
    load_row<TI, QD>(k + (((size_t)b * T + s) * H + h) * QD, kr);
    for (int r = 0; r < nr; ++r) {
      const float4* q4 = reinterpret_cast<const float4*>(qs + r * QD);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < QD / 4; ++d4) {
        const float4 a = q4[d4];
        acc = fmaf(a.x, kr[4 * d4 + 0], acc);
        acc = fmaf(a.y, kr[4 * d4 + 1], acc);
        acc = fmaf(a.z, kr[4 * d4 + 2], acc);
        acc = fmaf(a.w, kr[4 * d4 + 3], acc);
      }
      const int j = r - s + T - 1;
      float pos = 0.f;
      for (int d = 0; d < pd; ++d)
        pos = fmaf(qps[r * pd + d], ptab[d * nrow + j], pos);
      float sc = acc * inv_qd + pos * inv_pd;
      sc = fminf(fmaxf(sc, -100.f), 100.f);
      if (mrow && !mrow[(size_t)r * T + s]) sc = NEG;
      S[(size_t)r * T + s] = sc;
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < nr; r += THREADS / 32) {
    float* row = S + (size_t)r * T;
    float mx = NEG;
    for (int s = lane; s < T; s += 32) mx = fmaxf(mx, row[s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int s = lane; s < T; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    TI* orow = out + (((size_t)b * H + h) * T + t0 + r) * T;
    for (int s = lane; s < T; s += 32) orow[s] = from_f<TI>(row[s] / sum);
  }
}

template <typename TI, int QD>
int launch(const void* q, const void* k, const void* qp, const void* p,
           const void* mask, void* out, int B, int T, int H, int pd,
           cudaStream_t stream) {
  // largest query tile whose scores, queries and table fit the budget
  int tq = MAX_TQ < T ? MAX_TQ : T;
  auto smem_of = [&](int t) {
    return sizeof(float) *
           ((((size_t)t * T + 3) & ~(size_t)3) + (size_t)t * QD + (size_t)t * pd +
            (size_t)pd * (T + t - 1));
  };
  while (tq > 1 && smem_of(tq) > SMEM_BUDGET) --tq;
  const size_t smem = smem_of(tq);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_weights_kernel<TI, QD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + tq - 1) / tq, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(qp), static_cast<const TI*>(p),
      static_cast<const unsigned char*>(mask), static_cast<TI*>(out), T, H,
      pd, tq);
  return static_cast<int>(cudaGetLastError());
}

// the flagship's query_head_dim; other head dims get a variant when a
// config that needs them is ported
constexpr int KERNEL_QD = 32;

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k (B,T,H,32), qp (B,T,H,pd), p (2T-1,H,pd): contiguous, all bf16
// (is_bf16) or all f32; mask (B,T,T) bytes or null; out (B,H,T,T) in the
// inputs' dtype. Returns cudaGetLastError() after the launch.
int attn_weights_forward(const void* q, const void* k, const void* qp,
                         const void* p, const void* mask, void* out, int B,
                         int T, int H, int qd, int pd, int is_bf16,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || pd <= 0 || qd != KERNEL_QD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (is_bf16)
    return launch<bf, KERNEL_QD>(q, k, qp, p, mask, out, B, T, H, pd, st);
  return launch<float, KERNEL_QD>(q, k, qp, p, mask, out, B, T, H, pd, st);
}

}  // extern "C"
