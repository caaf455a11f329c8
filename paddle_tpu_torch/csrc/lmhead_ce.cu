// Fused lm-head + softmax cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_lmhead_ce.py:
// _stats_kernel (run through pl.pallas_call by _stats_call). For each token
// row n it computes, without writing the [N, V] logits to device memory,
//     lse[n] = logsumexp_v (x[n] . w[v])
//     nll[n] = lse[n] - (x[n] . w[label[n]])      (0 picked if the label
//                                                  lies outside [0, V))
// with fp32 inputs multiplied in full fp32 (no TF32) and bf16 inputs
// widened to fp32; every sum accumulates in fp32.
//
// Bound on this card (H100 SXM): operations. The products take 2*N*V*D
// FLOPs; at the serving score shape N=511, D=768, V=32000 that is about
// 25.1 GFLOP: about 0.375 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, or about 25 us at the 989 TFLOP/s of bf16 tensor cores, against
// about 15 us to read a bf16 W once at 3.35 TB/s. The logits never reach
// device memory, so only x, W and 3 fp32 row stats per (row, vocab chunk)
// move.
//
// Design. The TPU grid walks the vocab tiles of one token block in order
// on one core and carries (max, sum-exp, picked) in VMEM from tile to tile.
// Blocks on Hopper run in parallel and in no order, and at serving's N=31
// a grid over token blocks alone would fill one of the 132 SMs. So the
// work is split two ways, in two launches:
//   1. lmhead_ce_partial: grid (token blocks x vocab chunks), sized by the
//      wrapper to about 4 blocks per SM. A block stages a 64-row x tile and
//      a 64-column W tile in shared memory BK=32 deep at a time (widened to
//      fp32, transposed so that each thread reads its 4 rows and its 4
//      columns as one float4 each), forms the 64x64 score tile with fp32
//      FMAs (4x4 scores per thread, in registers; two 16-byte shared loads
//      feed 16 FMAs, so the FMA units and not shared memory set the pace),
//      and folds it into per-row online (m, l, picked) for its vocab chunk;
//      the 16 threads that share a row reduce with warp shuffles. It writes
//      the chunk's partial stats [S, N] x 3.
//   2. lmhead_ce_combine: one thread per row merges the S partials exactly
//      as the cross-shard combine of fused_lmhead_ce.py:344-348 does:
//      mg = max m, l = sum l*exp(m - mg), picked = sum picked; then
//      lse = mg + log(l > 0 ? l : 1) and nll = lse - picked.
// Ragged N, V and D edges are masked inside the kernel; nothing is padded.
// What this simple kernel leaves out (wgmma, TMA, bf16 tensor-core MMA,
// a pipelined shared-memory ring) is the work of making it fast.
//
// Plain C interface, loaded with ctypes: each entry point launches one
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;        // token rows per block
constexpr int BV = 64;        // vocab columns per tile
constexpr int BK = 32;        // depth staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;         // row stride BN + PAD keeps float4 alignment
constexpr float NEG = -1e30f;  // finite stand-in for -inf, as on the TPU

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage rows [r0, r0 + 64) x depth [k0, k0 + BK) of a row-major [rows, d]
// matrix into dst[k][r] (transposed), zero outside [0, rows) x [0, d).
// A warp covers 4 rows x 8 depths: each row's 8 values are one 32-byte
// sector in device memory, and the 32 stores hit 32 different banks
// (bank = 4k + r mod 32 with the BN + PAD row stride).
template <typename T>
__device__ __forceinline__ void stage(float (*dst)[BN + PAD],
                                      const T* __restrict__ src, int r0,
                                      int rows, int k0, int d, int tid) {
#pragma unroll
  for (int e = tid; e < BN * BK; e += THREADS) {
    const int lane = e & 31, chunk = e >> 5;  // 64 chunks of 32
    const int r = (chunk & 15) * 4 + (lane & 3);
    const int k = (chunk >> 4) * 8 + (lane >> 2);
    const int gr = r0 + r, gk = k0 + k;
    dst[k][r] = (gr < rows && gk < d) ? widen(src[(size_t)gr * d + gk]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const long long* __restrict__ labels,
               float* __restrict__ m_part, float* __restrict__ l_part,
               float* __restrict__ pk_part, int n, int d, int v,
               int tiles_per_chunk) {
  __shared__ __align__(16) float xs[BK][BN + PAD];
  __shared__ __align__(16) float ws[BK][BV + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns tile columns 4*tx .. 4*tx + 3
  const int ty = tid / 16;  // owns tile rows 4*ty .. 4*ty + 3; the 16 lanes
                            // of one ty are a half-warp, so row reductions
                            // are shuffles
  const int row0 = blockIdx.x * BN;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * tiles_per_chunk * BV;
  const int col_end = min(v, col_begin + tiles_per_chunk * BV);

  float m_run[TM], l_run[TM], picked[TM];
  long long lbl[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + 4 * ty + i;
    m_run[i] = NEG;
    l_run[i] = 0.f;
    picked[i] = 0.f;
    lbl[i] = r < n ? labels[r] : -1;
  }

  for (int c0 = col_begin; c0 < col_end; c0 += BV) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      stage(xs, x, row0, n, k0, d, tid);
      stage(ws, w, c0, col_end, k0, d, tid);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // online (max, sum-exp, picked) update of each owned row
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + 4 * tx + j;
        if (col < col_end) {
          tmax = fmaxf(tmax, acc[i][j]);
          if ((long long)col == lbl[i]) picked[i] += acc[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + 4 * tx + j;
        sum += col < col_end ? expf(acc[i][j] - m_new) : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      picked[i] += __shfl_xor_sync(0xffffffffu, picked[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + 4 * ty + i;
      if (r < n) {
        const size_t at = (size_t)chunk * n + r;
        m_part[at] = m_run[i];
        l_part[at] = l_run[i];
        pk_part[at] = picked[i];
      }
    }
  }
}

__global__ void combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ pk_part,
                               float* __restrict__ nll,
                               float* __restrict__ lse, int n, int n_chunks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float mg = NEG;
  for (int s = 0; s < n_chunks; ++s) mg = fmaxf(mg, m_part[(size_t)s * n + r]);
  float l = 0.f, picked = 0.f;
  for (int s = 0; s < n_chunks; ++s) {
    const size_t at = (size_t)s * n + r;
    l += l_part[at] * expf(m_part[at] - mg);
    picked += pk_part[at];
  }
  const float out = mg + logf(l > 0.f ? l : 1.f);
  lse[r] = out;
  nll[r] = out - picked;
}

}  // namespace

extern "C" {

// Partial stats of every (token block, vocab chunk): m/l/pk_part are
// [n_chunks, n] fp32; chunk s covers vocab tiles
// [s * tiles_per_chunk, (s + 1) * tiles_per_chunk) of BV columns.
int lmhead_ce_partial(const void* x, const void* w, const void* labels,
                      void* m_part, void* l_part, void* pk_part, int n, int d,
                      int v, int tiles_per_chunk, int n_chunks, int is_bf16,
                      void* stream) {
  const dim3 grid((n + BN - 1) / BN, n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lbl = static_cast<const long long*>(labels);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* pk = static_cast<float*>(pk_part);
  if (is_bf16) {
    partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), lbl, m, l, pk, n, d, v,
        tiles_per_chunk);
  } else {
    partial_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), lbl, m, l,
        pk, n, d, v, tiles_per_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// Merge the n_chunks partials of each row into lse and nll ([n] fp32).
int lmhead_ce_combine(const void* m_part, const void* l_part,
                      const void* pk_part, void* nll, void* lse, int n,
                      int n_chunks, void* stream) {
  constexpr int kThreads = 128;
  combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(pk_part), static_cast<float*>(nll),
      static_cast<float*>(lse), n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Geometry the wrapper sizes the grid and the partials with.
int lmhead_ce_tile_n() { return BN; }
int lmhead_ce_tile_v() { return BV; }

}  // extern "C"
