// Fused lm-head + softmax cross-entropy in fp32 for Hopper (sm_90a): the
// backward products, and the combine launch of every forward.
//
// Replaces, for fp32 inputs, two of the three TPU kernels of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (each run through
// pl.pallas_call), and finishes the third:
//   _stats_kernel (forward, by _stats_call): for each token row n, without
//     writing the [N, V] logits to device memory,
//         lse[n] = logsumexp_v (x[n] . w[v])
//         nll[n] = lse[n] - (x[n] . w[label[n]])   (0 picked if the label
//                                                 lies outside [0, V))
//     Its partial stats (max, sum-exp, picked) per (row tile, vocabulary
//     chunk) come from the tensor cores: bf16 in lmhead_ce_fwd_sm90.cu,
//     fp32 in lmhead_ce_fwd_f32_sm90.cu (split TF32: three tf32 products a
//     score, about 2^-22 of a product dropped, fp32-class accuracy). This
//     file's combine launch merges them.
//   _dx_kernel (backward, by _dx_call) and _dw_kernel (by _dw_call), from
//     the saved lse and a per-row cotangent g, again without an [N, V]
//     buffer of logits or of d-logits:
//         dl[n, v] = (exp(x[n] . w[v] - lse[n]) - [v == label[n]]) * g[n]
//         dx = dl . W   (N x D)        dW = dl^T . x   (V x D)
//     with fp32 accumulators cast once at the end.
// The backward's products are full fp32 on the FMA units and every sum
// accumulates in fp32. bf16 dx and dW run on the tensor cores
// (lmhead_ce_bwd_sm90.cu).
//
// Bound on this card (H100 SXM): operations. Each backward product takes
// 4*N*V*D FLOPs (the score tile is rebuilt, then multiplied again): at
// N=511, D=768, V=32768 that is 51.4 GFLOP, 0.77 ms at the 67 TFLOP/s of
// the fp32 FMA units, which is what these kernels run on. TF32 alone (10
// mantissa bits) is ruled out for fp32; split TF32 (three tf32 products)
// is the tensor cores' route, which the forward takes.
//
// Combine. lmhead_ce_combine: one thread per row merges the S partials
// exactly as the cross-shard combine of fused_lmhead_ce.py:344-348 does:
// mg = max m, l = sum l*exp(m - mg), picked = sum picked; then
// lse = mg + log(l > 0 ? l : 1) and nll = lse - picked.
//
// Design, backward (fp32). dx and dW are one kernel (bwd_partial_kernel)
// with the roles of x and W swapped: a block owns 64 "rows" (tokens for
// dx, vocab entries for dW) and sweeps 64-wide tiles of "columns" (the
// other side). For each column tile it stages a 64-row and a 64-column
// tile BK=32 deep at a time in shared memory (transposed, so that each
// thread reads its 4 rows and its 4 columns as one float4 each), forms the
// 64x64 score tile with fp32 FMAs (4x4 scores per thread), turns it into
// d-logits in registers (lse, g and the label belong to the token side),
// parks them in shared memory, and adds d-logits . (the column tile's
// D-wide rows) into a 64 x D fp32 accumulator that lives in shared memory
// (196,608 bytes at D=768; with the staging tiles 231,424 of the 232,448
// bytes a block may use; a wider D is swept in slabs of 768, rebuilding
// the scores once per slab).
// Parallelism: where rows alone leave the card idle (dx at small N), the
// column sweep is split into chunks, the TPU's sequential grid axis turned
// parallel: each (row block, chunk) writes an fp32 partial [chunks, N, D]
// and a second launch (lmhead_ce_bwd_reduce) sums the chunks. With one
// chunk a block writes its output directly.
// Ragged N, V and D edges are masked inside the kernels; nothing is padded.
//
// Plain C interface, loaded with ctypes: each entry point launches one
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;        // rows per block
constexpr int BK = 32;        // depth staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;         // row stride BN + PAD keeps float4 alignment
constexpr float NEG = -1e30f;  // finite stand-in for -inf, as on the TPU

// Stage rows [r0, r0 + 64) x depth [k0, k0 + BK) of a row-major [rows, d]
// matrix into dst[k][r] (transposed), zero outside [0, rows) x [0, d).
// A warp covers 4 rows x 8 depths: each row's 8 values are one 32-byte
// sector in device memory, and the 32 stores hit 32 different banks
// (bank = 4k + r mod 32 with the BN + PAD row stride).
__device__ __forceinline__ void stage(float (*dst)[BN + PAD],
                                      const float* __restrict__ src, int r0,
                                      int rows, int k0, int d, int tid) {
#pragma unroll
  for (int e = tid; e < BN * BK; e += THREADS) {
    const int lane = e & 31, chunk = e >> 5;  // 64 chunks of 32
    const int r = (chunk & 15) * 4 + (lane & 3);
    const int k = (chunk >> 4) * 8 + (lane >> 2);
    const int gr = r0 + r, gk = k0 + k;
    dst[k][r] = (gr < rows && gk < d) ? src[(size_t)gr * d + gk] : 0.f;
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


// ---------------------------------------------------------------- backward

constexpr int BC = 64;           // column tile of the backward
constexpr int DSLAB_MAX = 768;   // widest D slab the accumulator holds
constexpr int ROW = BN + PAD;    // row stride of the staging tiles

// Stage rows [c0, c0 + 64) x columns [d1, d1 + 64) of a row-major
// [rows, d] matrix into dst[k][c] (not transposed), zero outside
// [0, rows) x [0, dend). Neighbouring threads read neighbouring columns.
__device__ __forceinline__ void stage_rows(float (*dst)[ROW],
                                           const float* __restrict__ src, int c0,
                                           int rows, int d1, int dend, int d,
                                           int tid) {
#pragma unroll 4
  for (int e = tid; e < BC * 64; e += THREADS) {
    const int k = e >> 6, c = e & 63;
    const int gr = c0 + k, gd = d1 + c;
    dst[k][c] = (gr < rows && gd < dend) ? src[(size_t)gr * d + gd] : 0.f;
  }
}

// out[r, :] = sum over columns c of dl[r, c] * b[c, :], for the 64 rows of
// this block and the columns of its chunk. TOKEN_ROWS: rows are tokens
// (dx: a = x, b = W); else rows are vocab entries (dW: a = W, b = x).
// Shared memory (dynamic): acc [BN][dslab] fp32, then two [BK][ROW]
// staging tiles (aliased by a [BC][ROW] tile of b's rows), then the
// d-logits tile dlt [BC][ROW], stored column-major for float4 row reads.
template <bool TOKEN_ROWS>
__global__ void __launch_bounds__(THREADS)
bwd_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const long long* __restrict__ labels,
                   const float* __restrict__ g, const float* __restrict__ lse,
                   float* __restrict__ part, float* __restrict__ out, int n_rows,
                   int n_cols, int d, int tiles_per_chunk, int dslab) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;
  float(*as)[ROW] = reinterpret_cast<float(*)[ROW]>(smem + BN * dslab);
  float(*bs)[ROW] = as + BK;
  float(*brows)[ROW] = as;  // [BC][ROW] over as and bs
  float(*dlt)[ROW] = as + 2 * BK;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // tile columns 4*tx .. 4*tx + 3
  const int ty = tid / 16;  // tile rows 4*ty .. 4*ty + 3
  const int row0 = blockIdx.x * BN;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * tiles_per_chunk * BC;
  const int col_end = min(n_cols, col_begin + tiles_per_chunk * BC);

  float row_lse[TM], row_g[TM];
  long long row_lbl[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + 4 * ty + i;
    const bool ok = TOKEN_ROWS && r < n_rows;
    row_lse[i] = ok ? lse[r] : 0.f;
    row_g[i] = ok ? g[r] : 0.f;
    row_lbl[i] = ok ? labels[r] : -1;
  }

  for (int d0 = 0; d0 < d; d0 += dslab) {
    const int dend = min(d, d0 + dslab);
    for (int e = tid; e < BN * dslab; e += THREADS) acc[e] = 0.f;

    for (int c0 = col_begin; c0 < col_end; c0 += BC) {
      // 1. the 64x64 score tile, as in the forward
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += BK) {
        stage(as, a, row0, n_rows, k0, d, tid);
        stage(bs, b, c0, col_end, k0, d, tid);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * ty]);
          const float4 bv = *reinterpret_cast<const float4*>(&bs[k][4 * tx]);
          const float ar[TM] = {av.x, av.y, av.z, av.w};
          const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
        }
        __syncthreads();
      }

      // 2. d-logits, rounded to the inputs' dtype, into dlt[column][row]
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + 4 * tx + j;
        float col_lse = 0.f, col_g = 0.f;
        long long col_lbl = -1;
        if (!TOKEN_ROWS && c < col_end) {
          col_lse = lse[c];
          col_g = g[c];
          col_lbl = labels[c];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = row0 + 4 * ty + i;
          float dl = 0.f;
          if (r < n_rows && c < col_end) {
            const float l = TOKEN_ROWS ? row_lse[i] : col_lse;
            const float gg = TOKEN_ROWS ? row_g[i] : col_g;
            const bool hit = TOKEN_ROWS ? ((long long)c == row_lbl[i])
                                        : ((long long)r == col_lbl);
            dl = (expf(s[i][j] - l) - (hit ? 1.f : 0.f)) * gg;
          }
          dlt[4 * tx + j][4 * ty + i] = dl;
        }
      }

      // 3. acc[rows, slab] += dl (64 x 64) . b[columns, slab] (64 x slab)
      for (int d1 = d0; d1 < dend; d1 += 64) {
        stage_rows(brows, b, c0, col_end, d1, dend, d, tid);
        __syncthreads();
        float o[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) o[i][j] = 0.f;
#pragma unroll 8
        for (int k = 0; k < BC; ++k) {
          const float4 lv = *reinterpret_cast<const float4*>(&dlt[k][4 * ty]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&brows[k][4 * tx]);
          const float lr[TM] = {lv.x, lv.y, lv.z, lv.w};
          const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) o[i][j] = fmaf(lr[i], br[j], o[i][j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float4* p = reinterpret_cast<float4*>(
              &acc[(4 * ty + i) * dslab + (d1 - d0) + 4 * tx]);
          float4 cur = *p;
          cur.x += o[i][0];
          cur.y += o[i][1];
          cur.z += o[i][2];
          cur.w += o[i][3];
          *p = cur;
        }
        __syncthreads();
      }
    }

    // 4. the slab's rows: an fp32 partial per chunk, or the output itself
    for (int e = tid; e < BN * dslab; e += THREADS) {
      const int r = row0 + e / dslab, gd = d0 + e % dslab;
      if (r < n_rows && gd < dend) {
        const size_t at = (size_t)r * d + gd;
        if (part != nullptr)
          part[(size_t)chunk * n_rows * d + at] = acc[e];
        else
          out[at] = acc[e];
      }
    }
    __syncthreads();
  }
}

__global__ void bwd_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long total,
                                  int n_chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < n_chunks; ++c) sum += part[(size_t)c * total + i];
    out[i] = sum;
  }
}

template <bool TOKEN_ROWS>
int launch_bwd(const void* a, const void* b, const void* labels,
               const void* g, const void* lse, void* part, void* out,
               int n_rows, int n_cols, int d, int tiles_per_chunk,
               int n_chunks, int dslab, cudaStream_t s) {
  const size_t smem =
      (size_t)BN * dslab * sizeof(float) + (size_t)(2 * BK + BC) * ROW * 4;
  auto kernel = bwd_partial_kernel<TOKEN_ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + BN - 1) / BN, n_chunks);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const long long*>(labels), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<float*>(part),
      static_cast<float*>(out), n_rows, n_cols, d, tiles_per_chunk, dslab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Merge the n_chunks partials of each row (of lmhead_ce_fwd_sm90 or
// lmhead_ce_fwd_f32_sm90) into lse and nll ([n] fp32).
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

// Row tile of the fp32 backward, which the wrapper sizes its grid with.
int lmhead_ce_tile_n() { return BN; }


// fp32 backward partials (bf16 takes lmhead_ce_bwd_sm90.cu): token_rows =
// 1 computes dx (a = x [n_rows = N, d], b = W [n_cols = V, d]); token_rows
// = 0 computes dW (a = W, b = x). labels, g and lse belong to the tokens.
// Column chunk s covers column tiles [s * tiles_per_chunk, (s + 1) *
// tiles_per_chunk) of 64. With part != NULL each chunk writes part[s]
// ([n_chunks, n_rows, d] fp32); with part == NULL (one chunk) the block
// writes out ([n_rows, d] fp32). dslab: a multiple of 64, at most
// lmhead_ce_bwd_max_slab().
int lmhead_ce_bwd_partial(const void* a, const void* b, const void* labels,
                          const void* g, const void* lse, void* part,
                          void* out, int n_rows, int n_cols, int d,
                          int tiles_per_chunk, int n_chunks, int dslab,
                          int token_rows, void* stream) {
  if (dslab <= 0 || dslab % 64 || dslab > DSLAB_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return token_rows
             ? launch_bwd<true>(a, b, labels, g, lse, part, out, n_rows,
                                n_cols, d, tiles_per_chunk, n_chunks, dslab,
                                s)
             : launch_bwd<false>(a, b, labels, g, lse, part, out, n_rows,
                                 n_cols, d, tiles_per_chunk, n_chunks, dslab,
                                 s);
}

// out = sum over the n_chunks fp32 partials ([n_chunks, total]).
int lmhead_ce_bwd_reduce(const void* part, void* out, long long total,
                         int n_chunks, void* stream) {
  constexpr int kThreads = 256;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (blocks == 0) return 0;
  bwd_reduce_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), total,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

int lmhead_ce_bwd_max_slab() { return DSLAB_MAX; }

}  // extern "C"
