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
// row whose keys are all masked gets uniform weights 1/T, as in JAX.
//
// What bounds it on the card: the output. B*H*T^2 weights are written once
// (31.4 MB of bf16 at B=16, H=4, T=495, plus a 3.9 MB mask read), against
// 2*B*H*T^2*(qd+pd) flop (1.1 Gflop there, ~1 us of tensor-core time): the
// bytes bound it, 0.0118 ms at 3.35 TB/s.
//
// bf16 kernel (the serving path), attn_weights_mma_kernel:
// - One block of 4 warps per (64 query rows, head, utterance); each warp
//   owns 16 query rows. (32-row tiles, which put more blocks on the 132 SMs
//   at small B*H*T, measured no faster at any stack shape of B=16: PERF.md.)
// - q·kᵀ runs on the tensor cores: mma.sync.m16n8k16 bf16 → f32, qd = 32 is
//   two k-steps. The warp's q fragments are loaded once into registers. Keys
//   arrive in chunks of 64 (4 KB) through cp.async into a ring of three
//   shared buffers, so one barrier per chunk suffices; 80-byte key rows make
//   the fragment reads (plain 32-bit shared loads) free of bank conflicts.
//   wgmma would not help: at T=495 the product is ~1 us of tensor-core time.
// - The position term is read in the accumulator layout: the tile's window of
//   the table p[:, h, :] (64 + T - 1 rows) sits in shared memory as one
//   float4 per row; element (t, s) reads row t - s + T - 1 with one 16-byte
//   load at a constant offset and takes 4 FMAs against the row's qp, held in
//   registers.
// - Two passes over the key chunks and no T-wide score buffer, so shared
//   memory does not grow with T apart from that 16 B-per-row table. Pass 1
//   keeps each row's running max and sum (online rescaling) per thread and
//   merges them over the quad that shares a row with shuffles; pass 2
//   recomputes the scores and writes exp(s - m) / l. Keys past T are left out
//   of the max and the sum (they are not set to -1e30: a row whose keys are
//   all masked must come out 1/T).
// - The mask's rows have a stride of T bytes, so they start at any byte.
//   The ring holds, per chunk, the 16-byte aligned pieces that cover each of
//   the tile's rows (up to five, 16-byte cp.async, zero-filled past the
//   mask's end), and a reader adds the row's offset.
// - Store path: each warp stages its 16 x 64 bf16 tile in shared memory and
//   writes every row as 4-byte stores (one 128-byte segment per warp
//   instruction), with a 2-byte head and tail where the row starts on an odd
//   element (T odd: row r starts at byte 2*T*r, so 16-byte stores and TMA,
//   which need 16-byte strides, cannot write these rows).
// - The order of operations is the plain version's: f32 accumulate, times
//   1/sqrt(qd), plus the position term, clip, mask to -1e30, expf.
// - What holds it back (PERF.md, measured with tools/ablate.py): not bytes
//   (without any global store it still takes 5x the byte bound at T=495)
//   but per-weight work done twice: pass 1 alone is about a third of the
//   time, the stores a quarter, the position term an eighth, each pass's
//   expf only a fourteenth.
//
// f32 kernel (off the serving path; chip_smoke holds it at 1e-5, so TF32 is
// not allowed), attn_weights_fma_kernel: one block per (tile of tq query rows,
// head, utterance); the rows' scores, queries and table window sit in shared
// memory, each thread scores one key row against the tile's queries with f32
// FMAs, and one warp per row takes the softmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_LIMIT = 227 * 1024;

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kern, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_LIMIT);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// ------------------------------------------------------------ bf16: mma
constexpr int QD = 32;        // query_head_dim of the built variants
constexpr int WARPS = 4;      // warps per block, 16 query rows each
constexpr int ROWS = 16 * WARPS;
constexpr int PD = 4;         // pos_head_dim of the mma kernel
constexpr int KC = 64;        // keys per chunk
constexpr int NBUF = 3;       // chunk buffers: loads run two chunks ahead of reuse
constexpr int KS_LD = 40;     // bf16 per staged key row (32 + 8 padding)
constexpr int MS_LD = 80;     // bytes per staged mask row: 5 16-byte pieces
constexpr int ST_LD = 72;     // bf16 per staged output row

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// smem bytes of the mma kernel for T keys
__host__ __device__ constexpr size_t mma_smem(int T) {
  return (size_t)(KC + ROWS + T - 1) * 16  // table window, float4 rows
         + (size_t)NBUF * KC * KS_LD * 2   // key chunks
         + (size_t)NBUF * ROWS * MS_LD     // mask rows
         + (size_t)ROWS * ST_LD * 2;       // output staging
}

// registers capped so that the 512 blocks of T=495, B=16, H=4 are resident
// at once: 5 blocks per SM
template <bool MASK>
__global__ void __launch_bounds__(WARPS * 32, 5)
    attn_weights_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ qp,
                            const __nv_bfloat16* __restrict__ p,
                            const unsigned char* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int T, int H) {
  constexpr int NT = WARPS * 32;
  extern __shared__ float4 smem4[];
  const int nrow = ROWS + T - 1;
  // [KC + nrow]: KC rows that keys past T may read (and whose values are
  // then dropped), so that no index needs a clamp, then the window
  float4* ptab = smem4 + KC;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ptab + nrow);  // [NBUF][KC][KS_LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(ks + NBUF * KC * KS_LD);  // [NBUF][ROWS][MS_LD]
  uint16_t* st = reinterpret_cast<uint16_t*>(ms + NBUF * ROWS * MS_LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int t0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tw = t0 + warp * 16;  // the warp's first query row

  // chunk `ch` → buffer `buf`: its 64 keys (keys past T zero-filled) and,
  // with a mask, the tile's mask rows for those keys. A mask row starts at
  // any byte, so a staged row holds the 16-byte aligned pieces that cover
  // it (two threads per row), and a reader adds the row's offset, which is
  // the same for every chunk (chunks start at multiples of 64 keys).
  const __nv_bfloat16* kbase = k + ((size_t)b * T * H + h) * QD;
  const uint32_t ks_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ks));
  const uint32_t ms_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ms));
  const size_t mask_bytes = (size_t)gridDim.z * T * T;
  const int my_row = threadIdx.x >> 1;  // NT = 2 * ROWS
  const size_t my_mrow = ((size_t)b * T + t0 + my_row) * T;
  auto load_chunk = [&](int ch, int buf) {
    const int s0 = ch * KC;
    for (int i = threadIdx.x; i < KC * 4; i += NT) {
      const int key = i >> 2, seg = i & 3, s = s0 + key;
      const __nv_bfloat16* src = kbase + (size_t)min(s, T - 1) * H * QD + seg * 8;
      const uint32_t dst = ks_addr + ((buf * KC + key) * KS_LD + seg * 8) * 2;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                   "l"(src), "r"(s < T ? 16 : 0));
    }
    if (MASK && t0 + my_row < T) {
      const size_t start = my_mrow + s0;
      const size_t a16 = start & ~(size_t)15;
      const int need = (int)(start - a16) + min(KC, T - s0);
      for (int pc = threadIdx.x & 1; pc * 16 < need; pc += 2) {
        const size_t at = a16 + 16 * pc;
        const uint32_t dst = ms_addr + (buf * ROWS + my_row) * MS_LD + 16 * pc;
        const int bytes = (int)min((size_t)16, mask_bytes - at);  // not past the end
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(mask + at), "r"(bytes));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int nch = (T + KC - 1) / KC;
  load_chunk(0, 0);

  // the tile's window of the position table: row i holds p[t0 + i, h]
  for (int i = threadIdx.x; i < nrow; i += NT) {
    const int gr = t0 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < 2 * T - 1) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(
          p + ((size_t)gr * H + h) * PD));
      v = make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
    }
    ptab[i] = v;
  }

  // q fragments (A, row-major 16x16 per k-step) and qp, rows tw+g, tw+g+8
  uint32_t qa[2][4];
  float qpr[2][PD];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int t = tw + g + 8 * hi;
    const bool ok = t < T;
    const size_t row = ((size_t)b * T + (ok ? t : 0)) * H + h;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + row * QD);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][hi] = ok ? __ldg(qw + kk * 8 + c) : 0u;
      qa[kk][hi + 2] = ok ? __ldg(qw + kk * 8 + c + 4) : 0u;
    }
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(qp + row * PD));
    qpr[hi][0] = ok ? bf_lo(u.x) : 0.f;
    qpr[hi][1] = ok ? bf_hi(u.x) : 0.f;
    qpr[hi][2] = ok ? bf_lo(u.y) : 0.f;
    qpr[hi][3] = ok ? bf_hi(u.y) : 0.f;
  }

  const float inv_qd = 1.f / sqrtf((float)QD);
  const float inv_pd = 1.f / sqrtf((float)PD);
  uint16_t* sw = st + warp * 16 * ST_LD;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int moff[2];  // offset of mask row g + 8*hi in its staged pieces
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
    moff[hi] = (int)((((size_t)b * T + tw + g + 8 * hi) * T) & 15);
  // T odd: output rows alternate between 4-byte aligned and 2 bytes past
  const size_t orow0 = ((size_t)b * H + h) * T + tw;

  // Iteration it takes chunk it % nch (pass 1, then pass 2) from buffer
  // it % NBUF, and first starts the load of iteration it+1 into a buffer
  // last read in iteration it-2, which every warp has left: it has passed
  // the barrier of iteration it-1. So one barrier per iteration does.
  for (int it = 0, buf = 0; it < 2 * nch; ++it, buf = buf == NBUF - 1 ? 0 : buf + 1) {
    const int ch = it < nch ? it : it - nch;
    const int s0 = ch * KC;
    if (it + 1 < 2 * nch) {
      load_chunk((it + 1) % nch, buf == NBUF - 1 ? 0 : buf + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk `ch` and (first time) the table are visible

    // per row g + 8*hi of this lane: prow[hi][-(8j + e)] is the table row
    // and mrow[hi][8j + e] the mask byte of key s0 + 8j + 2c + e
    const float4* prow[2];
    const unsigned char* mrow[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = warp * 16 + g + 8 * hi;  // row in the block's tile
      prow[hi] = ptab + (r + T - 1 - s0 - 2 * c);
      mrow[hi] = ms + (buf * ROWS + r) * MS_LD + moff[hi] + 2 * c;
    }
    const int lim = T - s0 - 2 * c;  // key s0 + 8j + 2c + e < T

    // scores of this chunk in the accumulator layout:
    // sc[j][e] is row g + 8*(e>>1), key s0 + 8j + 2c + (e&1)
    float sc[8][4];
    const __nv_bfloat16* kb = ks + buf * KC * KS_LD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = kb + (j * 8 + g) * KS_LD + 2 * c;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(acc, qa[kk], b0, b1);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 pv = prow[hi][-(8 * j + e)];
          float pos = fmaf(qpr[hi][0], pv.x, 0.f);
          pos = fmaf(qpr[hi][1], pv.y, pos);
          pos = fmaf(qpr[hi][2], pv.z, pos);
          pos = fmaf(qpr[hi][3], pv.w, pos);
          float v = acc[2 * hi + e] * inv_qd + pos * inv_pd;
          v = fminf(fmaxf(v, -100.f), 100.f);
          if (MASK) v = mrow[hi][8 * j + e] ? v : NEG;
          // keys past T: out of the max and the sum
          sc[j][2 * hi + e] = 8 * j + e < lim ? v : -INFINITY;
        }
      }
    }

    if (it < nch) {
      // pass 1: running max and sum of this thread's keys of rows g, g+8
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cm = fmaxf(cm, fmaxf(sc[j][2 * hi], sc[j][2 * hi + 1]));
        if (cm > m[hi]) {
          l[hi] *= expf(m[hi] - cm);  // m = -inf: l is 0 and stays 0
          m[hi] = cm;
        }
        if (m[hi] != -INFINITY) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            l[hi] += expf(sc[j][2 * hi] - m[hi]) + expf(sc[j][2 * hi + 1] - m[hi]);
        }
      }
    } else {
      if (it == nch) {
        // the quad (c = 0..3) shares rows g, g+8: merge its maxima and
        // sums; l becomes 1 / sum
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[hi], o);
            const float lo = __shfl_xor_sync(0xffffffffu, l[hi], o);
            const float mn = fmaxf(m[hi], mo);
            l[hi] = (m[hi] == -INFINITY ? 0.f : l[hi] * expf(m[hi] - mn)) +
                    (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
            m[hi] = mn;
          }
          l[hi] = 1.f / l[hi];
        }
      }
      // pass 2: normalised weights → staging tile → rows of the output
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float w0 = expf(sc[j][2 * hi] - m[hi]) * l[hi];
          const float w1 = expf(sc[j][2 * hi + 1] - m[hi]) * l[hi];
          *reinterpret_cast<__nv_bfloat162*>(sw + (g + 8 * hi) * ST_LD + j * 8 +
                                             2 * c) = __floats2bfloat162_rn(w0, w1);
        }
      }
      __syncwarp();
      // row i: lane stores elements e, e+1 as one 4-byte word, where e is
      // 2*lane, or 2*lane + 1 after a 2-byte head on a row that starts 2
      // bytes past a 4-byte boundary (odd rows when T is odd)
      const int nval = min(KC, T - s0);
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int a = (int)((orow0 + i) & 1) & T;
        const uint16_t* srow = sw + i * ST_LD;
        uint16_t* orow = reinterpret_cast<uint16_t*>(out) + (orow0 + i) * T + s0;
        const int e = 2 * lane + a;
        const uint32_t word =
            a ? (uint32_t)srow[e] | ((uint32_t)srow[e + 1] << 16)
              : *reinterpret_cast<const uint32_t*>(srow + e);
        if (tw + i < T) {
          if (a && lane == 0) orow[0] = srow[0];
          if (e + 1 < nval)
            *reinterpret_cast<uint32_t*>(orow + e) = word;
          else if (e < nval)
            orow[e] = (uint16_t)word;
        }
      }
      __syncwarp();  // the staging tile is free for the next chunk
    }
  }
}

int launch_mma(const void* q, const void* k, const void* qp, const void* p,
               const void* mask, void* out, int B, int T, int H,
               cudaStream_t stream) {
  static bool done[2][MAX_DEVICES];
  const size_t smem = mma_smem(T);
  if (smem > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mask ? attn_weights_mma_kernel<true>
                   : attn_weights_mma_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kern, done[mask ? 1 : 0]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + ROWS - 1) / ROWS, H, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(qp), static_cast<const __nv_bfloat16*>(p),
      static_cast<const unsigned char*>(mask), static_cast<__nv_bfloat16*>(out),
      T, H);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ f32: FMA
constexpr int FMA_THREADS = 256;
constexpr int MAX_TQ = 32;
constexpr size_t FMA_SMEM_BUDGET = 200 * 1024;

// QD contiguous f32 → registers through 16-byte loads
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float* dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < QD / 4; ++i) {
    const float4 u = __ldg(s4 + i);
    dst[4 * i] = u.x;
    dst[4 * i + 1] = u.y;
    dst[4 * i + 2] = u.z;
    dst[4 * i + 3] = u.w;
  }
}

__global__ void __launch_bounds__(FMA_THREADS)
    attn_weights_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ qp, const float* __restrict__ p,
                            const unsigned char* __restrict__ mask,
                            float* __restrict__ out, int T, int H, int pd, int tq) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [tq][T] scores
  float* qs = S + (((size_t)tq * T + 3) & ~(size_t)3);  // [tq][QD], 16 B aligned
  float* qps = qs + tq * QD;                   // [tq][pd]
  float* ptab = qps + tq * pd;                 // [pd][nrow] table rows t0..
  const int nrow = T + tq - 1;

  const int t0 = blockIdx.x * tq, h = blockIdx.y, b = blockIdx.z;
  const int nr = min(tq, T - t0);
  const int tid = threadIdx.x;

  for (int i = tid; i < tq * QD; i += FMA_THREADS) {
    const int r = i / QD, d = i - r * QD;
    qs[i] = r < nr ? q[(((size_t)b * T + t0 + r) * H + h) * QD + d] : 0.f;
  }
  for (int i = tid; i < tq * pd; i += FMA_THREADS) {
    const int r = i / pd, d = i - r * pd;
    qps[i] = r < nr ? qp[(((size_t)b * T + t0 + r) * H + h) * pd + d] : 0.f;
  }
  // local row j holds p[t0 + j]: query t0+r, key s → j = r - s + T - 1
  for (int i = tid; i < pd * nrow; i += FMA_THREADS) {
    const int d = i / nrow, j = i - d * nrow;
    const int gr = t0 + j;
    ptab[i] = gr < 2 * T - 1 ? p[((size_t)gr * H + h) * pd + d] : 0.f;
  }
  __syncthreads();

  const float inv_qd = 1.f / sqrtf((float)QD);
  const float inv_pd = 1.f / sqrtf((float)pd);
  const unsigned char* mrow =
      mask ? mask + ((size_t)b * T + t0) * T : nullptr;
  for (int s = tid; s < T; s += FMA_THREADS) {
    float kr[QD];
    load_row(k + (((size_t)b * T + s) * H + h) * QD, kr);
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
  for (int r = warp; r < nr; r += FMA_THREADS / 32) {
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
    float* orow = out + (((size_t)b * H + h) * T + t0 + r) * T;
    for (int s = lane; s < T; s += 32) orow[s] = row[s] / sum;
  }
}

int launch_fma(const void* q, const void* k, const void* qp, const void* p,
               const void* mask, void* out, int B, int T, int H, int pd,
               cudaStream_t stream) {
  static bool done[MAX_DEVICES];
  // largest query tile whose scores, queries and table fit the budget
  int tq = MAX_TQ < T ? MAX_TQ : T;
  auto smem_of = [&](int t) {
    return sizeof(float) *
           ((((size_t)t * T + 3) & ~(size_t)3) + (size_t)t * QD + (size_t)t * pd +
            (size_t)pd * (T + t - 1));
  };
  while (tq > 1 && smem_of(tq) > FMA_SMEM_BUDGET) --tq;
  const size_t smem = smem_of(tq);
  if (smem > FMA_SMEM_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(attn_weights_fma_kernel, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + tq - 1) / tq, H, B);
  attn_weights_fma_kernel<<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(qp), static_cast<const float*>(p),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), T, H,
      pd, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k (B,T,H,32), qp (B,T,H,pd), p (2T-1,H,pd): contiguous and 16-byte
// aligned, all bf16 (is_bf16, then pd must be 4) or all f32; mask (B,T,T)
// bytes or null; out (B,H,T,T) in the inputs' dtype.
// Returns cudaGetLastError() after the launch.
int attn_weights_forward(const void* q, const void* k, const void* qp,
                         const void* p, const void* mask, void* out, int B,
                         int T, int H, int qd, int pd, int is_bf16,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || pd <= 0 || qd != QD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_fma(q, k, qp, p, mask, out, B, T, H, pd, st);
  if (pd != PD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma(q, k, qp, p, mask, out, B, T, H, st);
}

}  // extern "C"
