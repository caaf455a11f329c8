// Flash attention dq in fp32 for Hopper (sm_90a), on the FMA units.
//
// Replaces, for fp32 inputs at head_dim 64 and 128, the dq TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd), in both of their layouts, from the forward's saved lse (s[r, c] =
// (q[r] . k[c]) * scale) and delta[r] = rowsum(dO[r] * out[r]):
//   _bwd_dq_kernel / _bwd_dq_kernel_bthd:
//         P = exp(s - lse), dP = dO . V^T, dS = P * (dP - delta)
//         dq = scale * dS . K
// Causal masks are aligned bottom-right (column c is visible from row r iff
// c <= r + Tk - Tq), as the TPU kernels and the einsum path align them.
// This kernel takes fp32 inputs only, multiplied in full fp32 (no TF32),
// so the TPU's rounding of dS to the inputs' dtype rounds nothing. Every
// accumulator is fp32. The scale multiplies the fp32 scores (the BHTD
// rule; the TPU's BTHD kernel rounds q * scale to the inputs' dtype first,
// which agrees at D = 64, where the scale is 0.125) and the dq sum once at
// the end.
// Masked scores take no part: a masked entry's P is exactly 0.
//
// Bound on this card (H100 SXM): operations. At the training shape
// (B = 8, T = 2048, H = 12, D = 64, fp32, causal) the visible score
// entries number B*H*T*(T+1)/2, and each product over them costs 2*D FLOPs
// an entry: 77.3 GFLOP for dq (3 products), 1.15 ms at the 67 TFLOP/s of
// the fp32 FMA units it runs on, against under 0.08 ms to move q, k, v, dO
// and dq once at 3.35 TB/s. bf16 runs on the tensor cores in every role at every
// head_dim (flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu at
// head_dim 64 and 128; flash_attention_fwd_d256_sm90.cu,
// flash_attention_dq_d256_sm90.cu and flash_attention_dkv_d256_sm90.cu at
// 256), and so does the fp32 forward, in split TF32
// (flash_attention_fwd_f32_sm90.cu at head_dim 64 and 128,
// flash_attention_fwd_f32_d256_sm90.cu at 256), as does the fp32 dk/dv at
// every head_dim (flash_attention_dkv_f32_sm90.cu at 64 and 128,
// flash_attention_dkv_f32_d256_sm90.cu at 256) and the fp32 dq at 256
// (flash_attention_dq_f32_d256_sm90.cu). This file serves the fp32 dq at
// head_dim 64 and 128.
//
// Design. The TPU grid walks the kv blocks of one query block in order on
// one core and carries the accumulator in VMEM. Here that sequential axis
// is a loop inside one block, and the parallel axes are the grid: one
// block of 256 threads per (64-row query tile, head, batch), so no
// atomics are needed. At the training shape that is 32 x 12 x 8 = 3,072
// blocks a launch. Query tiles run in reverse order, so that the long
// causal rows start first. Each thread owns a 4 x 4 patch of the 64 x 64
// score tile and 4 rows x D/16 columns of the output accumulator, in
// registers. Score products stage both operands 32 deep at a time in
// shared memory, transposed, so that each thread reads its 4 rows and 4
// columns as one float4 each; the second product parks the dS tile in
// shared memory and streams K's rows in 64-column slabs. Shared memory is
// 34,816 bytes a block whatever D is (64 or 128). Tiles wholly above the
// causal diagonal are skipped; only tiles that cross it, or the ragged
// edge of a sequence, are masked. Strides for (batch, seq, head) let one
// kernel serve both layouts: BTHD = (B, T, H, D) and BHTD = (B, H, T, D),
// with D contiguous.
//
// Plain C interface, loaded with ctypes: flash_attn_dq launches one
// kernel on the given stream and returns cudaGetLastError();
// flash_attn_dkv launches nothing and returns -1 (fp32 dk/dv runs on the
// tensor cores at every head_dim).

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // key/value rows per tile
constexpr int BK = 32;        // depth staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROW = 64 + 4;   // row stride of the shared tiles (float4 rows)

struct Params {
  const void* q;       // [B, Tq, H, D] or [B, H, Tq, D], as are dout and dq
  const void* k;       // [B, Tk, H, D] or [B, H, Tk, D], as are v, dk, dv
  const void* v;
  const void* dout;    // dO
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* out;           // dq
  int tq, tk;
  long long q_sb, q_st, q_sh;  // element strides of batch, seq and head
  long long k_sb, k_st, k_sh;
  float scale;
  int causal;
};

// dst[k][r] = src[r0 + r][k0 + k] for r < 64, k < BK (transposed), 0 for
// rows at or past `rows`. A warp covers 4 rows x 8 depths: each row's 8
// values are one sector in device memory, and the 32 stores hit 32
// different banks (bank = 4k + r mod 32 with the ROW stride).
__device__ __forceinline__ void stage_t(float (*dst)[ROW],
                                        const float* __restrict__ src,
                                        long long row_stride, int r0,
                                        int rows, int k0, int tid) {
#pragma unroll
  for (int e = tid; e < 64 * BK; e += THREADS) {
    const int lane = e & 31, chunk = e >> 5;  // 64 chunks of 32
    const int r = (chunk & 15) * 4 + (lane & 3);
    const int k = (chunk >> 4) * 8 + (lane >> 2);
    const int gr = r0 + r;
    dst[k][r] = gr < rows ? src[gr * row_stride + k0 + k] : 0.f;
  }
}

// dst[r][c] = src[r0 + r][d1 + c] for r, c < 64 (not transposed), 0 for
// rows at or past `rows`. Neighbouring threads read neighbouring columns.
__device__ __forceinline__ void stage_rows(float (*dst)[ROW],
                                           const float* __restrict__ src,
                                           long long row_stride, int r0,
                                           int rows, int d1, int tid) {
#pragma unroll 4
  for (int e = tid; e < 64 * 64; e += THREADS) {
    const int r = e >> 6, c = e & 63;
    const int gr = r0 + r;
    dst[r][c] = gr < rows ? src[gr * row_stride + d1 + c] : 0.f;
  }
}

// s[i][j] = sum over the D depths of a[a0 + 4ty + i] . b[b0 + 4tx + j]
// (rows of two row-major operands; rows past a_rows / b_rows read as 0).
// stg holds two [BK][ROW] staging tiles. Ends synchronised: stg is free.
template <int D>
__device__ __forceinline__ void scores(float (&s)[TM][TN],
                                       const float* __restrict__ a,
                                       long long a_st, int a0, int a_rows,
                                       const float* __restrict__ b,
                                       long long b_st, int b0, int b_rows,
                                       float (*stg)[ROW], int tid, int ty,
                                       int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  float(*as)[ROW] = stg;
  float(*bs)[ROW] = stg + BK;
  for (int k0 = 0; k0 < D; k0 += BK) {
    stage_t(as, a, a_st, a0, a_rows, k0, tid);
    stage_t(bs, b, b_st, b0, b_rows, k0, tid);
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
}

// acc[i][4 * sl + j] += sum over c < 64 of w[c][4ty + i] * src[r0 + c][64 sl
// + 4tx + j], for every 64-column slab sl of D: the second product, with w
// the dS tile (the summed index first). The
// slabs of src are staged through stg, which must be free; ends
// synchronised, so w and stg may be overwritten after it.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[TM][D / 16],
                                           const float (*w)[ROW],
                                           const float* __restrict__ src,
                                           long long st, int r0, int rows,
                                           float (*stg)[ROW], int tid,
                                           int ty, int tx) {
#pragma unroll
  for (int sl = 0; sl < D / 64; ++sl) {
    stage_rows(stg, src, st, r0, rows, 64 * sl, tid);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < 64; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(&w[c][4 * ty]);
      const float4 rv = *reinterpret_cast<const float4*>(&stg[c][4 * tx]);
      const float wr[TM] = {wv.x, wv.y, wv.z, wv.w};
      const float rr[TN] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][4 * sl + j] = fmaf(wr[i], rr[j], acc[i][4 * sl + j]);
    }
    __syncthreads();
  }
}

// out rows [r0, r0 + 64) of a row-major [rows, D] operand: row 4ty + i,
// columns 64 sl + 4tx + j, times `mul`.
template <int D>
__device__ __forceinline__ void write_rows(float* __restrict__ out,
                                           long long st,
                                           int r0, int rows,
                                           const float (&acc)[TM][D / 16],
                                           float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        out[r * st + 64 * sl + 4 * tx + j] = acc[i][4 * sl + j] * mul;
  }
}

// The columns of query tile q0 a causal mask leaves visible end before
// this (every column without a mask).
__device__ __forceinline__ int kv_end(const Params& p, int q0) {
  return p.causal ? min(p.tk, q0 + BQ + p.tk - p.tq) : p.tk;
}

// Does the (query tile q0, key tile c0) pair need per-entry masking: a
// ragged edge of either sequence or a tile crossing the causal diagonal.
__device__ __forceinline__ bool needs_mask(const Params& p, int q0, int c0) {
  return q0 + BQ > p.tq || c0 + BKV > p.tk ||
         (p.causal && c0 + BKV - 1 > q0 + p.tk - p.tq);
}

__device__ __forceinline__ bool visible(const Params& p, int r, int c) {
  return r < p.tq && c < p.tk && (!p.causal || c <= r + p.tk - p.tq);
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params p) {
  __shared__ __align__(16) float stg[2 * BK][ROW];
  __shared__ __align__(16) float dst[BKV][ROW];  // dS^T: [col][row]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.k_sb + h * p.k_sh;
  const long long stats = ((long long)b * gridDim.y + h) * p.tq;

  float row_lse[TM], row_delta[TM], acc[TM][D / 16];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + 4 * ty + i;
    row_lse[i] = r < p.tq ? p.lse[stats + r] : 0.f;
    row_delta[i] = r < p.tq ? p.delta[stats + r] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const int end = kv_end(p, q0);
  for (int c0 = 0; c0 < end; c0 += BKV) {
    float s[TM][TN], dp[TM][TN];
    scores<D>(s, q, p.q_st, q0, p.tq, k, p.k_st, c0, p.tk, stg, tid, ty,
                 tx);
    scores<D>(dp, dout, p.q_st, q0, p.tq, v, p.k_st, c0, p.tk, stg, tid,
                 ty, tx);
    const bool masked = needs_mask(p, q0, c0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const bool keep = !masked || visible(p, r, c0 + 4 * tx + j);
        const float pr = keep ? expf(s[i][j] * p.scale - row_lse[i]) : 0.f;
        dst[4 * tx + j][4 * ty + i] = pr * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    accumulate<D>(acc, dst, k, p.k_st, c0, p.tk, stg, tid, ty, tx);
  }
  write_rows<D>(static_cast<float*>(p.out) + b * p.q_sb + h * p.q_sh,
                   p.q_st, q0, p.tq, acc, p.scale, ty, tx);
}

template <int D>
int launch(const Params& p, int batch, int heads, cudaStream_t s) {
  const dim3 grid((p.tq + 63) / 64, heads, batch);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  dq_kernel<D><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, Tq, H, D] (BTHD) or [B, H, Tq, D] (BHTD) at strides q_sb, q_st,
// q_sh (elements; D contiguous), as are dout and dq; k: likewise at k_sb,
// k_st, k_sh, as is v. lse and delta: [B, H, Tq] fp32. fp32 only (is_bf16
// returns -1: flash_attn_dq_sm90 takes bf16 at 64 and 128,
// flash_attn_dq_d256_sm90 at 256). d: 64 or 128 (anything else returns -1:
// fp32 at 256 runs flash_attn_dq_f32_d256_sm90, in split TF32).

int flash_attn_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int batch, int heads, int tq, int tk, int d,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh, float scale,
                  int causal, int is_bf16, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = dq;
  p.tq = tq;
  p.tk = tk;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.scale = scale;
  p.causal = causal;
  if (is_bf16) return -1;  // bf16 runs on the tensor cores
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(p, batch, heads, s);
    case 128:
      return launch<128>(p, batch, heads, s);
    default:  // head_dim 256: flash_attention_dq_f32_d256_sm90.cu
      return -1;
  }
}

// The dk/dv entry point of the SIMT kernel this file held: it launches
// nothing and returns -1 at every head_dim and dtype (fp32 dk and dv run
// flash_attn_dkv_f32_sm90 at 64 and 128 and flash_attn_dkv_f32_d256_sm90
// at 256, in split TF32; bf16 flash_attn_dkv_sm90 and
// flash_attn_dkv_d256_sm90).
int flash_attn_dkv(const void*, const void*, const void*, const void*,
                   const void*, const void*, void*, void*, int, int, int, int,
                   int, long long, long long, long long, long long, long long,
                   long long, float, int, int, void*) {
  return -1;
}

}  // extern "C"
