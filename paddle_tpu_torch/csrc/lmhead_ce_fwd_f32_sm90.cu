// Fused lm-head + softmax cross-entropy forward in fp32 on Hopper's tensor
// cores (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs, the forward TPU kernel of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (run through pl.pallas_call):
// _stats_kernel (by _stats_call). For each token row n and one vocabulary
// chunk, without writing the [N, V] logits to device memory:
//     m[n]      = max over the chunk's v of  x[n] . w[v]
//     l[n]      = sum over the chunk's v of  exp(x[n] . w[v] - m[n])
//     picked[n] = x[n] . w[label[n]] where the label lies in the chunk
//                 (0 for a label outside [0, V))
// The chunks' partials [3, chunks, N] are merged by lmhead_ce.cu's combine
// launch, as fused_lmhead_ce.py:344-348 merges vocabulary shards. The
// serving path (DecodeModel.score) scores in fp32 and runs this kernel.
//
// Precision: split TF32. TF32 alone keeps 10 mantissa bits, about 1e-3 of
// error on a score at D = 768. Each operand is written a = hi + lo with
// hi = tf32_rna(a) and lo = tf32_rna(a - hi) (round to nearest, ties away,
// on the low 13 mantissa bits), and each score is
//     hi_x . hi_w + (lo_x . hi_w + hi_x . lo_w)
// three tf32 products into fp32 accumulators; the dropped lo_x . lo_w term
// and lo's own rounding are about 2^-22 of a product. The big product and
// the two small ones sum into two accumulators, merged once per tile in
// fp32 (round to nearest), so that the tensor cores' fp32 accumulation,
// which need not round to nearest, rounds the large sum 3 times less
// often. chip_smoke.py holds the result against float64 logits beside the
// plain fp32 version's own error (tests/test_torch_lmhead_ce_f32.py
// emulates this arithmetic and sets that bound).
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. The function takes 2*N*V*D FLOPs, three tf32 products of it
// 6*N*V*D: at serving's N=511, D=768, V=32000 that is 75.4 GFLOP, 0.152 ms
// (against 0.375 ms for 25.1 GFLOP on the 67 TFLOP/s of the FMA units).
// Reading W once (98.3 MB of fp32) takes 0.029 ms.
//
// Design. A GEMM mainloop with the split done in shared memory, then the
// reduction epilogue of lmhead_ce_fwd_sm90.cu.
//   - Block: 128 token rows, two warpgroups of 64, and no producer warp:
//     thread 0 issues the TMA loads. Two 64 x 128 fp32 accumulators are
//     128 registers a thread; ptxas gives a block of two warpgroups and a
//     producer warp 168 registers a thread, a block of two warpgroups 255.
//     Grid (row tiles, vocab chunks), the row tile the fastest index, so
//     that blocks that run together share a W chunk in L2; at N <= 128 one
//     row tile leaves the card to the vocabulary chunks, and W streams
//     from device memory about once.
//   - Ring: 4 stages of 32 KB, each the x box (128 x 32 fp32) and the W
//     box (128 x 32), K-major, 128-byte swizzle (rows of 128 bytes, as the
//     bf16 kernels' boxes); D is streamed 32 deep, so any D that is a
//     multiple of 8 is taken (the wrapper pads any other D with zero
//     columns, which add nothing).
//   - Split: when a stage lands, the 256 threads map it elementwise, hi
//     written in place and lo into one of 3 lo buffers (32 KB each) at the
//     same offset. An elementwise map keeps the swizzle TMA wrote (every
//     buffer is 1024-byte aligned), so the same descriptors read hi and lo.
//     A proxy fence and a block barrier, then each warpgroup issues
//     12 wgmma m64n128k8 (4 slices x 3 products) as one group; one group
//     stays in flight while the next stage is split.
//   - Reuse: after the barrier of step g, both warpgroups have waited for
//     the group of step g - 2, so thread 0 refills stage (g - 2) mod 4
//     with load g + 2, and the lo buffer of step g - 3 may be written at
//     step g: the ring keeps two loads ahead of the step being split.
//   - Epilogue, per vocabulary tile: hi + lo in fp32, then the bf16
//     kernel's online (m, l) with exp2f and the picked logit. Columns past
//     V read TMA's zero fill and are masked out.
//   - Shared memory: 7 x 32 KB + barriers, one block per SM. ptxas (CUDA
//     12.8) reports 210 registers and no spill; the SASS holds 12 HGMMA
//     (chip_smoke.py's build phase prints both).
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                   // token rows per block
constexpr int BN = 128;                   // vocab columns per tile
constexpr int BK = BOX_COLS_F32;          // fp32 depth per ring stage
constexpr int X_BOX = BM * BK * 4;        // 16 KB
constexpr int W_BOX = BN * BK * 4;        // 16 KB
constexpr int STAGE = X_BOX + W_BOX;      // 32 KB
constexpr int STAGES = 4;                 // TMA ring
constexpr int LOS = 3;                    // lo buffers, one per step in use
constexpr int THREADS = 256;              // 2 warpgroups
constexpr float NEG = -1e30f;             // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t smem_bytes() {
  return 1024 + (size_t)(STAGES + LOS) * STAGE + 8 * STAGES;
}

__device__ __forceinline__ float4 tf32_rna4(float4 a) {
  return make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z),
                     tf32_rna(a.w));
}

// The stage at hi split in place: hi := tf32_rna(a), lo := tf32_rna(a -
// hi) at the same offset of the lo buffer (a - hi is exact in fp32).
__device__ __forceinline__ void split_stage(float4* hi, float4* lo,
                                            int tid) {
#pragma unroll
  for (int j = 0; j < STAGE / 16 / THREADS; ++j) {
    const int f = tid + THREADS * j;
    const float4 a = hi[f];
    const float4 h = tf32_rna4(a);
    lo[f] = tf32_rna4(make_float4(a.x - h.x, a.y - h.y, a.z - h.z,
                                  a.w - h.w));
    hi[f] = h;
  }
}

// Load g of a block's sequence (vocab tile g / kc, depth step g % kc)
// into its ring stage.
__device__ __forceinline__ void issue(uint32_t base, uint32_t bar_s,
                                      const CUtensorMap* map_x,
                                      const CUtensorMap* map_w, int g,
                                      int kc, int row0, int col_begin) {
  const int s = g % STAGES;
  const uint32_t full = bar_s + 8u * s;
  mbar_expect_tx(full, STAGE);
  tma_load(base + s * STAGE, map_x, (g % kc) * BK, row0, full);
  tma_load(base + s * STAGE + X_BOX, map_w, (g % kc) * BK,
           col_begin + (g / kc) * BN, full);
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_f32_sm90_kernel(__grid_constant__ const CUtensorMap map_x,
                        __grid_constant__ const CUtensorMap map_w,
                        const long long* __restrict__ labels,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ pk_part, int n, int v, int kc,
                        int tiles_per_chunk) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t lo_s = base + STAGES * STAGE;
  const uint32_t bar_s = lo_s + LOS * STAGE;

  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * tiles_per_chunk * BN;
  const int col_end = min(v, col_begin + tiles_per_chunk * BN);
  const int ntiles = (col_end - col_begin + BN - 1) / BN;
  const int total = ntiles * kc;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_s + 8u * s, 1);
    mbar_fence_init();
    for (int g = 0; g < STAGES - 2 && g < total; ++g)
      issue(base, bar_s, &map_x, &map_w, g, kc, row0, col_begin);
  }
  __syncthreads();

  // warpgroup wg: rows [64 wg, 64 wg + 64) of the block's tile; warp-
  // uniform in the compiler's eyes (a role read from tid alone makes
  // ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int r_in = 64 * wg + 16 * warp + (lane >> 2);  // rows r_in, r_in + 8
  const int c_in = 2 * (lane & 3);  // columns 8 j + c_in + {0, 1}

  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, picked[2] = {0.f, 0.f};
  int lbl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + r_in + 8 * i;
    const long long l = r < n ? labels[r] : -1;
    lbl[i] = (l >= 0 && l < v) ? static_cast<int>(l) : -1;
  }

  float acc[64], small[64];  // hi . hi; lo . hi + hi . lo
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = small[e] = 0.f;
  int g = 0;  // step of the block's sequence
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = col_begin + t * BN;

    // scores of the 64 x 128 tile over all of D
    fence_regs(acc);
    fence_regs(small);
    wgmma_fence();
    for (int k = 0; k < kc; ++k, ++g) {
      const int s = g % STAGES, b = g % LOS;
      mbar_wait(bar_s + 8u * s, (g / STAGES) & 1);
      split_stage(reinterpret_cast<float4*>(gbase + s * STAGE),
                  reinterpret_cast<float4*>(gbase + (STAGES + b) * STAGE),
                  tid);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && g + STAGES - 2 < total)
        issue(base, bar_s, &map_x, &map_w, g + STAGES - 2, kc, row0,
              col_begin);
      const uint32_t xh = base + s * STAGE + wg * (64 * 128);
      const uint32_t wh = base + s * STAGE + X_BOX;
      const uint32_t xl = lo_s + b * STAGE + wg * (64 * 128);
      const uint32_t wl = lo_s + b * STAGE + X_BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int first = (k | kk) == 0;
        wgmma_n128_tf32(small, desc(xl + 32 * kk), desc(wh + 32 * kk),
                        !first);
        wgmma_n128_tf32(small, desc(xh + 32 * kk), desc(wl + 32 * kk), 1);
        wgmma_n128_tf32(acc, desc(xh + 32 * kk), desc(wh + 32 * kk),
                        !first);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(small);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += small[e];

    // online (m, l) and picked of each of the thread's two rows; l is the
    // thread's share, summed over its quad at the end (the quad shares m)
    const int lim = v - c0;  // columns at or past it lie past V
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hit = lbl[i] - c0;
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c_in + c;
          const float s = acc[4 * j + 2 * i + c];
          if (col < lim) tmax = fmaxf(tmax, s);
          if (col == hit) picked[i] += s;
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[i], tmax);
      const float ms = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c_in + c;
          const float e = exp2f(fmaf(acc[4 * j + 2 * i + c], LOG2E, -ms));
          sum += col < lim ? e : 0.f;
        }
      }
      l_run[i] = l_run[i] * exp2f((m_run[i] - m_new) * LOG2E) + sum;
      m_run[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i], pk = picked[i];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
      pk += __shfl_xor_sync(0xffffffffu, pk, off);
    }
    const int r = row0 + r_in + 8 * i;
    if ((lane & 3) == 0 && r < n) {
      const size_t at = (size_t)chunk * n + r;
      m_part[at] = m_run[i];
      l_part[at] = l;
      pk_part[at] = pk;
    }
  }
}

}  // namespace

extern "C" {

// Geometry the wrapper sizes the grid with.
int lmhead_ce_fwd_f32_sm90_tile_n() { return BM; }
int lmhead_ce_fwd_f32_sm90_tile_v() { return BN; }

// fp32 partial stats of every (row tile, vocab chunk): x [n, d], w [v, d]
// fp32, labels [n] int64; m/l/pk_part [n_chunks, n] fp32; chunk s covers
// vocab tiles [s * tiles_per_chunk, (s + 1) * tiles_per_chunk) of
// lmhead_ce_fwd_f32_sm90_tile_v() columns, and no chunk may start at or
// past v. Returns a CUDA error, or -1 (d not a multiple of 8, or an empty
// size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map refused: a
// pointer not 16-byte aligned).
int lmhead_ce_fwd_f32_sm90(const void* x, const void* w, const void* labels,
                           void* m_part, void* l_part, void* pk_part, int n,
                           int d, int v, int tiles_per_chunk, int n_chunks,
                           void* stream) {
  if (d <= 0 || d % 8 || n <= 0 || v <= 0 || tiles_per_chunk <= 0 ||
      n_chunks <= 0 || (n_chunks - 1) * tiles_per_chunk * BN >= v)
    return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap map_x, map_w;
  if (!make_map_2d(&map_x, x, n, d, BM, true) ||
      !make_map_2d(&map_w, w, v, d, BN, true))
    return -3;
  const int err = allow_smem(fwd_f32_sm90_kernel, smem_bytes());
  if (err) return err;
  const dim3 grid((n + BM - 1) / BM, n_chunks);
  fwd_f32_sm90_kernel<<<grid, THREADS, smem_bytes(),
                        static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const long long*>(labels),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(pk_part), n, v, (d + BK - 1) / BK,
      tiles_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
