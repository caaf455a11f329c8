// Fused lm-head + softmax cross-entropy forward in bf16 on Hopper's tensor
// cores (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs, the forward TPU kernel of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (run through pl.pallas_call):
// _stats_kernel (by _stats_call). For each token row n and one vocabulary
// chunk, without writing the [N, V] logits to device memory:
//     m[n]      = max over the chunk's v of  x[n] . w[v]
//     l[n]      = sum over the chunk's v of  exp(x[n] . w[v] - m[n])
//     picked[n] = x[n] . w[label[n]] where the label lies in the chunk
//                 (0 for a label outside [0, V))
// fp32 products and sums. The chunks' partials [3, chunks, N] are merged
// by lmhead_ce.cu's combine launch, as fused_lmhead_ce.py:344-348 merges
// vocabulary shards. fp32 inputs (the serving path scores in fp32) keep
// the SIMT kernel of lmhead_ce.cu.
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. The function takes 2*N*V*D FLOPs: at N=4096 (seq 512),
// D=768, V=32768 that is 206.2 GFLOP, 0.208 ms; at N=16384 (seq 2048)
// 824.6 GFLOP, 0.834 ms. Reading x and W once takes 0.02 and 0.04 ms.
//
// Design. A plain GEMM mainloop with a reduction epilogue.
//   - Block: 128 token rows (two consumer warpgroups of 64) and one
//     producer warp; grid (row tiles, vocab chunks), the row tile the
//     fastest index. W (32768 x 768 bf16, 50 MB) is as large as the L2, and
//     every row tile reads all of its chunk's W: blocks that run together
//     then share a few chunks, and W comes from device memory about once
//     and from L2 otherwise (a chunk-major order would read it once per
//     row tile, 1.6 GB at N=4096, 2.3x the FLOP bound).
//   - Mainloop: the block sweeps its chunk 128 vocabulary columns at a
//     time, D streamed 64 deep: each ring stage (32 KB) holds the x box
//     (128 x 64) and the W box (128 x 64), K-major, 128-byte swizzle, so x
//     is not kept resident and any D that is a multiple of 8 is taken (the
//     wrapper pads any other D with zero columns). Each warpgroup issues 4
//     wgmma m64n128k16 a stage into a 64 x 128 fp32 score tile in
//     registers; one wgmma group stays in flight while the previous stage
//     is released. A stage carries 2 MFLOP, so its handshake is amortized
//     over about 0.5 us of tensor-core work.
//   - Epilogue, per vocabulary tile: a row's 32 values of a thread, then
//     the 4 lanes of its quad (two shuffles): the tile's max, the online
//     (m, l) update with exp2f on scores prescaled by log2(e), and the
//     picked logit where a column equals the label. Columns past V read
//     TMA's zero fill and are masked out (a 0 score would count).
//   - One block per SM: 6 stages (197 KB of shared memory); a 64 x 128 fp32
//     accumulator is 64 registers a thread. ptxas (CUDA 12.8) reports 147
//     registers and no spill; the SASS holds 4 HGMMA (chip_smoke.py's
//     build phase prints both).
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                   // token rows per block
constexpr int BN = 128;                   // vocab columns per tile
constexpr int BK = BOX_COLS;              // depth per ring stage
constexpr int X_BOX = BM * BK * 2;        // 16 KB
constexpr int W_BOX = BN * BK * 2;        // 16 KB
constexpr int STAGE = X_BOX + W_BOX;
constexpr int STAGES = 6;
constexpr int THREADS = 288;              // 2 consumer warpgroups + 1 warp
constexpr float NEG = -1e30f;             // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_sm90_kernel(__grid_constant__ const CUtensorMap map_x,
                    __grid_constant__ const CUtensorMap map_w,
                    const long long* __restrict__ labels,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ pk_part, int n, int v, int kc,
                    int tiles_per_chunk) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_s = base + STAGES * STAGE;
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (STAGES + s); };

  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * tiles_per_chunk * BN;
  const int col_end = min(v, col_begin + tiles_per_chunk * BN);
  const int ntiles = (col_end - col_begin + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warp's role, warp-uniform in the compiler's eyes (a role read
  // from tid alone makes ptxas serialize the wgmma)
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == 2) {  // producer warp: one thread issues every copy
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        for (int k = 0; k < kc; ++k) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), STAGE);
          tma_load(base + stage * STAGE, &map_x, k * BK, row0, full(stage));
          tma_load(base + stage * STAGE + X_BOX, &map_w, k * BK,
                   col_begin + t * BN, full(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the block's tile
  const int wg = role;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
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

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = col_begin + t * BN;

    // scores of the 64 x 128 tile over all of D
    fence_regs(acc);
    wgmma_fence();
    int held = -1;  // stage read by the last group, to release after it
    for (int k = 0; k < kc; ++k) {
      mbar_wait(full(stage), phase);
      const uint32_t xa = base + stage * STAGE + wg * (64 * 128);
      const uint32_t wa = base + stage * STAGE + X_BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n128(acc, desc(xa + 32 * kk), desc(wa + 32 * kk),
                   (k | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && leader) mbar_arrive(empty(held));
      held = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (leader) mbar_arrive(empty(held));

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
int lmhead_ce_fwd_sm90_tile_n() { return BM; }
int lmhead_ce_fwd_sm90_tile_v() { return BN; }

// bf16 partial stats of every (row tile, vocab chunk): x [n, d], w [v, d]
// bf16, labels [n] int64; m/l/pk_part [n_chunks, n] fp32; chunk s covers
// vocab tiles [s * tiles_per_chunk, (s + 1) * tiles_per_chunk) of
// lmhead_ce_fwd_sm90_tile_v() columns, and no chunk may start at or past
// v. Returns a CUDA error, or -1 (d not a multiple of 8, or an empty
// size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map refused: a
// pointer not 16-byte aligned).
int lmhead_ce_fwd_sm90(const void* x, const void* w, const void* labels,
                       void* m_part, void* l_part, void* pk_part, int n,
                       int d, int v, int tiles_per_chunk, int n_chunks,
                       void* stream) {
  if (d <= 0 || d % 8 || n <= 0 || v <= 0 || tiles_per_chunk <= 0 ||
      n_chunks <= 0 || (n_chunks - 1) * tiles_per_chunk * BN >= v)
    return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap map_x, map_w;
  if (!make_map_2d(&map_x, x, n, d, BM) || !make_map_2d(&map_w, w, v, d, BN))
    return -3;
  const int err = allow_smem(fwd_sm90_kernel, smem_bytes());
  if (err) return err;
  const dim3 grid((n + BM - 1) / BM, n_chunks);
  fwd_sm90_kernel<<<grid, THREADS, smem_bytes(),
                    static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const long long*>(labels),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(pk_part), n, v, (d + BK - 1) / BK,
      tiles_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
