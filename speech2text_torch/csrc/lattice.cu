// Transducer lattice: the forward variables (alpha) and the total of each
// utterance in one kernel, the occupancies of its arcs times the incoming
// gradient in a second. Kernel B3.
//
// Replaces no Pallas kernel. It stands in for the JAX package's lax.scan in
// speech2text_tpu/ops/rnnt.py:lattice_forward (and the scans of
// speech2text_tpu/ops/pruned_rnnt.py that run it for the simple and the
// pruned loss), which XLA compiles into one loop on the device. The port
// ran that scan as a Python loop over anti-diagonals, about 17 launches a
// diagonal forward and 30 in autograd's walk back.
//
// Computes, for utterance b with px (B,T,U) emit and py (B,T,U+1) blank
// log-probs, f32, the natural layout:
//   alpha[0,0] = 0
//   alpha[t,u] = logaddexp(alpha[t-1,u] + py[t-1,u], alpha[t,u-1] + px[t,u-1])
//   total = alpha[tf,uf] + py[tf,uf],  uf = clamp(u_len, 0, U),
//           tf = t_len - 1 + u_len - uf
// with emits at u >= u_len masked to NEG = -1e30 and out-of-lattice cells at
// NEG, as speech2text_torch/ops/rnnt.py:lattice_forward_plain does. A final
// cell off the lattice (t_len = 0 or t_len > T) has no path: it gives NEG
// where it lies off the T+U diagonals or on the row t = T, and NEG + NEG
// where it lies on them above or below the lattice, the plain loop's values
// (bar an unreachable cell above row T, where the loop gives NEG + NEG).
// The backward walks the same diagonals from the final cell back to (0,0)
// with the arithmetic of autograd through the plain loop: each cell's two
// arrivals get their softmax weights w = exp(a - m) / (exp(a_b - m) +
// exp(a_e - m)), and the cell's adjoint g[t,u] = g[t+1,u] w_b[t+1,u] +
// g[t,u+1] w_e[t,u+1] is the occupancy of the cell. grad_py[t,u] =
// gb g[t+1,u] w_b[t+1,u], grad_px[t,u] = gb g[t,u+1] w_e[t,u+1],
// grad_py[tf,uf] = gb. Mathematically this is gb exp(alpha + arc + beta -
// total); in f32 that form, with alpha, beta and total near -1700 (random
// weights, 4336 symbols, T+U = 211), lies up to 9e-4 from autograd's
// occupancies, the weights' form 1e-6. Zeros go outside the rectangle
// [0,tf] x [0,uf], at masked emits, where gb = 0 and where the utterance
// has no path (total <= NEG / 2), so an infeasible utterance gives no
// inf * 0 = NaN.
//
// Arithmetic is the plain version's, in f32: the sanitised logaddexp,
// accurate expf / logf / division (no fast math), __fmul_rn so that no
// product is fused into a later sum. No atomics: deterministic.
//
// What bounds it on the card: neither bytes nor operations. At the flagship
// cell's 388 x 7 s bucket (B = 388, T = 175, U = 36) the arcs, alpha and the
// gradients are about 70 MB read and written over both kernels (21 us at
// 3.35 TB/s) and 20 flop a cell. The bound is the chain of dependent
// diagonals: T+U-1 steps in each kernel, each a shared-memory exchange and
// a barrier after loads from device memory.
//
// Design: one block per utterance, threads over u (min(roundup32(U+1),
// 1024); each thread owns the cells u = tid + k*threads, k < CPT, so any U+1
// up to 16384 runs). A thread keeps the value of its own cells from one
// diagonal to the next; only the neighbour's value crosses threads, through
// a double-buffered row in shared memory, so each diagonal takes one
// __syncthreads. The loads of diagonal d+1 (forward) or d-1 (backward) are
// issued before diagonal d's arithmetic and barrier, so their latency
// overlaps it. Each block stops at its own utterance's last diagonal
// tf + uf, not at the padded T+U-1, and the backward visits only the
// rectangle that reaches the final cell: the short utterances of a bucket
// cost less. alpha is written on the diagonals 0 .. tf+uf only (the
// backward reads nothing else).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CPT = 16;                  // cells per thread: U+1 <= 16384
constexpr int STATIC_SMEM = 48 * 1024;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(a, b);
  if (mx <= NEG) return NEG;
  return mx + logf(expf(a - mx) + expf(b - mx));
}

// The final cell (tf, uf) of utterance b, as lattice_forward_plain reads it.
struct Final {
  int tf, uf, d_end;
  bool on_diagonals;   // 0 <= d_end < T+U
  bool inside;         // and 0 <= tf < T
};

__device__ __forceinline__ Final final_cell(const int* t_lens,
                                            const int* u_lens, int b, int T,
                                            int U) {
  Final f;
  const long long tl = t_lens[b], ul = u_lens[b];
  const long long d_end = tl - 1 + ul;
  const long long uf = ul < 0 ? 0 : (ul > U ? U : ul);
  const long long tf = d_end - uf;
  f.on_diagonals = d_end >= 0 && d_end < (long long)T + U;
  f.inside = f.on_diagonals && tf >= 0 && tf < T;
  f.tf = (int)tf;
  f.uf = (int)uf;
  f.d_end = (int)d_end;
  return f;
}

template <int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
    lattice_alpha_kernel(const float* __restrict__ px,
                         const float* __restrict__ py,
                         const int* __restrict__ t_lens,
                         const int* __restrict__ u_lens,
                         float* __restrict__ alpha, float* __restrict__ total,
                         int T, int U) {
  extern __shared__ float smem[];   // two rows of U+2: [0] = NEG, [u+1] = u
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int U1 = U + 1;
  const Final f = final_cell(t_lens, u_lens, b, T, U);
  if (!f.inside) {
    if (tid == 0)
      total[b] = f.on_diagonals && f.tf != T ? NEG + NEG : NEG;
    return;
  }
  const long long ul = u_lens[b];
  const size_t bx = (size_t)b * T * U, by = (size_t)b * T * U1;
  float* rows[2] = {smem, smem + U1 + 1};
  for (int i = tid; i < U1 + 1; i += nth) {
    rows[0][i] = i == 1 ? 0.f : NEG;    // diagonal 0: alpha[0,0] = 0
    rows[1][i] = NEG;
  }
  if (tid == 0) alpha[by] = 0.f;
  if (f.d_end == 0) {
    if (tid == 0) total[b] = 0.f + py[by];
    return;
  }
  // arcs into this thread's cells of the diagonal to compute next
  float nb[CPT], ne[CPT];
  auto load = [&](int d) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int u = tid + k * nth, t = d - u;
      nb[k] = (u <= U && t >= 1 && t <= T) ? py[by + (size_t)(t - 1) * U1 + u]
                                           : NEG;
      ne[k] = (u >= 1 && u <= U && t >= 0 && t < T && u - 1 < ul)
                  ? px[bx + (size_t)t * U + u - 1]
                  : NEG;
    }
  };
  load(1);
  __syncthreads();
  for (int d = 1; d <= f.d_end; ++d) {
    float cb[CPT], ce[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
    }
    if (d < f.d_end) load(d + 1);
    const float* prev = rows[(d - 1) & 1];
    float* cur = rows[d & 1];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int u = tid + k * nth, t = d - u;
      if (u > U) continue;
      float a = NEG;
      if (t >= 0 && t < T) {
        a = logaddexp(prev[u + 1] + cb[k], prev[u] + ce[k]);
        alpha[by + (size_t)t * U1 + u] = a;
        if (d == f.d_end && u == f.uf)
          total[b] = a + py[by + (size_t)t * U1 + u];
      }
      cur[u + 1] = a;
    }
    __syncthreads();
  }
}

template <int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
    lattice_grad_kernel(const float* __restrict__ px,
                        const float* __restrict__ py,
                        const int* __restrict__ t_lens,
                        const int* __restrict__ u_lens,
                        const float* __restrict__ alpha,
                        const float* __restrict__ total,
                        const float* __restrict__ g,
                        float* __restrict__ grad_px,
                        float* __restrict__ grad_py, int T, int U) {
  extern __shared__ float smem[];   // two rows of U+2: [u] = g w_e of cell u
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int U1 = U + 1;
  const Final f = final_cell(t_lens, u_lens, b, T, U);
  const float gb = g[b];
  const bool live = f.inside && total[b] > 0.5f * NEG && gb != 0.f;
  const int tf = f.tf, uf = f.uf;
  const size_t bx = (size_t)b * T * U, by = (size_t)b * T * U1;
  // every arc the walk does not reach: 0, and the final blank: gb
  for (int i = tid; i < T * U; i += nth) {
    const int t = i / U, u = i - t * U;
    if (!live || t > tf || u >= uf) grad_px[bx + i] = 0.f;
  }
  for (int i = tid; i < T * U1; i += nth) {
    const int t = i / U1, u = i - t * U1;
    if (!live || t >= tf || u > uf)
      grad_py[by + i] = (live && t == tf && u == uf) ? gb : 0.f;
  }
  if (!live || f.d_end == 0) return;
  const long long ul = u_lens[b];
  float* rows[2] = {smem, smem + U1 + 1};
  for (int i = tid; i < 2 * (U1 + 1); i += nth) smem[i] = 0.f;
  // the two arrivals of this thread's cells on the diagonal to walk next:
  // alpha and arc of the blank from (t-1,u), of the emit from (t,u-1)
  float nab[CPT], npb[CPT], nae[CPT], npe[CPT];
  auto load = [&](int d) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int u = tid + k * nth, t = d - u;
      const bool in = u <= uf && t >= 0 && t <= tf;
      const bool blank = in && t >= 1, emit = in && u >= 1;
      nab[k] = blank ? alpha[by + (size_t)(t - 1) * U1 + u] : NEG;
      npb[k] = blank ? py[by + (size_t)(t - 1) * U1 + u] : NEG;
      nae[k] = emit ? alpha[by + (size_t)t * U1 + u - 1] : NEG;
      npe[k] = (emit && u - 1 < ul) ? px[bx + (size_t)t * U + u - 1] : NEG;
    }
  };
  float own[CPT];     // g w_b of this thread's cells on the diagonal walked
#pragma unroll
  for (int k = 0; k < CPT; ++k) own[k] = 0.f;
  load(f.d_end);
  __syncthreads();
  for (int d = f.d_end; d >= 1; --d) {
    float ab[CPT], pb[CPT], ae[CPT], pe[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      ab[k] = nab[k];
      pb[k] = npb[k];
      ae[k] = nae[k];
      pe[k] = npe[k];
    }
    if (d > 1) load(d - 1);
    const float* later = rows[(d + 1) & 1];   // diagonal d+1's g w_e
    float* cur = rows[d & 1];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int u = tid + k * nth, t = d - u;
      if (u > U) continue;
      float cb = 0.f, ce = 0.f;
      if (u <= uf && t >= 0 && t <= tf) {
        const float gc = d == f.d_end ? 1.f : own[k] + later[u + 1];
        const float a_b = ab[k] + pb[k], a_e = ae[k] + pe[k];
        const float mx = fmaxf(a_b, a_e);
        if (mx > NEG) {
          const float eb = expf(a_b - mx), ee = expf(a_e - mx);
          const float s = eb + ee;
          cb = __fmul_rn(gc, __fdiv_rn(eb, s));
          ce = __fmul_rn(gc, __fdiv_rn(ee, s));
        }
        if (t >= 1) grad_py[by + (size_t)(t - 1) * U1 + u] = __fmul_rn(cb, gb);
        if (u >= 1) grad_px[bx + (size_t)t * U + u - 1] = __fmul_rn(ce, gb);
      }
      own[k] = cb;
      cur[u] = ce;
    }
    __syncthreads();
  }
}

int threads_for(int U1) {
  const int t = (U1 + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

size_t smem_bytes(int U1) { return 2 * (size_t)(U1 + 1) * sizeof(float); }

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  if (smem <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

#define LATTICE_DISPATCH(CALL)                \
  switch (cpt) {                              \
    case 1: CALL(1); break;                   \
    case 2: CALL(2); break;                   \
    case 4: CALL(4); break;                   \
    case 8: CALL(8); break;                   \
    case 16: CALL(16); break;                 \
    default: return cudaErrorInvalidValue;    \
  }

// Threads and cells per thread (a power of two) for U+1 cells, or 0.
int cells_per_thread(int U1, int nth) {
  const int need = (U1 + nth - 1) / nth;
  int cpt = 1;
  while (cpt < need) cpt *= 2;
  return cpt <= MAX_CPT ? cpt : 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// px (B,T,U), py (B,T,U+1) f32; t_lens, u_lens (B,) int32; alpha (B,T,U+1)
// f32, written on the diagonals up to each utterance's final cell; total
// (B,) f32. All contiguous. Returns cudaGetLastError() after the launch.
int lattice_forward(const void* px, const void* py, const void* t_lens,
                    const void* u_lens, void* alpha, void* total, int B,
                    int T, int U, void* stream) {
  if (B <= 0 || T < 0 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int U1 = U + 1, nth = threads_for(U1);
  const int cpt = cells_per_thread(U1, nth);
  const size_t smem = smem_bytes(U1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define ALPHA_CALL(C)                                                        \
  e = prepare(lattice_alpha_kernel<C>, smem);                                \
  if (e != cudaSuccess) return static_cast<int>(e);                          \
  lattice_alpha_kernel<C><<<B, nth, smem, st>>>(                             \
      static_cast<const float*>(px), static_cast<const float*>(py),          \
      static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),      \
      static_cast<float*>(alpha), static_cast<float*>(total), T, U)
  LATTICE_DISPATCH(ALPHA_CALL)
#undef ALPHA_CALL
  return static_cast<int>(cudaGetLastError());
}

// The forward's operands and outputs, g (B,) f32 the gradient of each
// total; grad_px (B,T,U) and grad_py (B,T,U+1) f32, every element written.
// Returns cudaGetLastError() after the launch.
int lattice_backward(const void* px, const void* py, const void* t_lens,
                     const void* u_lens, const void* alpha,
                     const void* total, const void* g, void* grad_px,
                     void* grad_py, int B, int T, int U, void* stream) {
  if (B <= 0 || T < 0 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int U1 = U + 1, nth = threads_for(U1);
  const int cpt = cells_per_thread(U1, nth);
  const size_t smem = smem_bytes(U1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define GRAD_CALL(C)                                                         \
  e = prepare(lattice_grad_kernel<C>, smem);                                 \
  if (e != cudaSuccess) return static_cast<int>(e);                          \
  lattice_grad_kernel<C><<<B, nth, smem, st>>>(                              \
      static_cast<const float*>(px), static_cast<const float*>(py),          \
      static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),      \
      static_cast<const float*>(alpha), static_cast<const float*>(total),    \
      static_cast<const float*>(g), static_cast<float*>(grad_px),            \
      static_cast<float*>(grad_py), T, U)
  LATTICE_DISPATCH(GRAD_CALL)
#undef GRAD_CALL
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
