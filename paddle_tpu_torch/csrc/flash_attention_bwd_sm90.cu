// Flash attention backward (dq, and dk with dv) in bf16 on Hopper's tensor
// cores (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs at head_dim 64 and 128, the backward TPU
// kernels of paddle_tpu/ops/pallas/flash_attention.py (run through
// pl.pallas_call by _bwd): _bwd_dq_kernel / _bwd_dq_kernel_bthd (dq) and
// _bwd_dkv_kernel / _bwd_dkv_kernel_bthd (dk, dv). From the forward's lse
// and delta[r] = rowsum(dO[r] * out[r]), without writing a [Tq, Tk] tile
// to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dq = scale * dS . K    dk = scale * dS^T . Q    dv = P^T . dO
// under the contract every flash kernel keeps (ops/flash_attention.py's
// rounding rule): the causal mask is aligned bottom-right (key c
// visible from row r iff c <= r + Tk - Tq) and applied before the
// exponential; P is rounded to bf16 before P^T . dO, dS before dS . K and
// dS^T . Q; every sum is fp32 and dq and dk are scaled once, in fp32, at
// the end. A query row that takes no part (past Tq, or with lse -1e30: it
// sees no key) gets P = 0: its lse is replaced by +1e30 before the
// exponential, so no mask is left to multiply an inf by 0.
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. At the training shape (B = 8, T = 2048, H = 12, D = 64,
// causal) the visible score entries number B*H*T*(T+1)/2 and each product
// over them costs 2*D FLOPs an entry: dq makes 3 (S, dP, dS . K), 77.3
// GFLOP, 0.078 ms; dk/dv 4 (S^T, dP^T, P^T . dO, dS^T . Q), 103.1 GFLOP,
// 0.104 ms; against under 0.04 ms to move their inputs and outputs once.
//
// Design (FlashAttention-3's backward, split in two launches and kept
// simple; the machinery of flash_attention_fwd_sm90.cu).
//   - dk/dv is key-major: a block owns a tile of keys and sweeps the
//     query tiles that can see them (under causal, from r = c0 - (Tk - Tq)
//     on). In that orientation every product is a plain wgmma and no tile
//     is transposed through shared memory:
//         S^T  = K . Q^T    64 keys x NQ queries, A = K (resident,
//                           K-major), B = the ring's Q tile (K-major)
//         dP^T = V . dO^T   the same with V and dO
//         dV  += P^T . dO   64 keys x D, A = round(P^T) from registers,
//                           B = the same dO tile, MN-major (transpose flag)
//         dK  += dS^T . Q   A = round(dS^T) from registers, B = the Q tile
//     A score accumulator's fragment, packed in bf16 pairs, is the A
//     fragment of the next wgmma (sm90.cuh:wgmma_n64_rs), so P and dS
//     never leave the registers, and each Q and dO stage is loaded once
//     and read twice: K-major by the score products, MN-major by the
//     accumulations.
//   - lse and delta are per query, so here per accumulator column: the
//     producer warp stores each query tile's NQ values of lse * log2(e)
//     (+1e30 where the row takes no part) and delta into the stage beside
//     its tiles, and every thread reads those of its NQ / 4 columns.
//   - dq is query-major, as the forward: a block per query tile, Q and dO
//     resident, the key and value tiles of 64 through the ring (K halves,
//     then V halves); S = Q . K^T and dP = dO . V^T from shared memory, dS
//     rounded in registers, then dQ += dS . K with the same K stage as an
//     MN-major B. Each thread's two rows take their lse and delta once.
//   - Loads: one producer warp, TMA with the 128-byte swizzle, a ring of 4
//     stages tracked by full/empty mbarriers; rank-3 tensor maps as the
//     forward's (ops/flash_attention.py:tma_geometry), so both layouts are
//     read without a copy and a box past a sequence's end reads zeros.
//   - Overlap: each warpgroup issues tile j's two score products with
//     tile j-1's accumulation and computes tile j's P and dS while the
//     accumulation runs (the forward's software pipeline).
//   - Registers set the tiles (Tile<D>). ptxas allocates by warpgroup, so
//     a block of two consumer warpgroups and a producer warp holds at
//     most 168 registers a thread. A thread of the pipeline holds dK and
//     dV (D registers), S^T and dP^T (NQ) and the packed round(P^T) and
//     round(dS^T) of the tile before (NQ / 2): at D = 64 and NQ = 64,
//     with addresses and counters, more than 168, and ptxas spilled and
//     serialized the wgmma; so NQ = 32 (wgmma m64n32). At D = 128 the
//     accumulators alone take 128 (dk/dv) and 64 (dq), so a block there
//     has one consumer warpgroup (64 keys, or 64 query rows) and up to
//     255 registers. A producer warpgroup handing its registers to the
//     consumers (setmaxnreg) did not raise ptxas's allocation (CUDA 12.8:
//     168, the same spills). ptxas reports 142 (dq) and 139 (dk/dv)
//     registers at D = 64, 173 and 206 at D = 128, no spill; the SASS
//     holds 24 HGMMA at D = 64 and 48 at D = 128 each.
//   - Grid: one dimension, the (batch, head) pairs fastest, so the heavy
//     tiles of every pair start first under causal: the lowest key tiles
//     for dk/dv, the last query tiles for dq. At the training shape (D =
//     64: 128 keys, or 128 query rows, a block) 16 x 12 x 8 = 1,536
//     blocks each, one an SM.
// dk and dv are written by the block that owns their keys, dq by the one
// that owns its queries: no atomics, and the sums are deterministic.
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int STAGES = 4;
constexpr float NEG = -1e30f;  // the forward's lse of a row that sees no key
constexpr float FAR = 1e30f;   // lse of a row that takes no part: P = 0
constexpr float LOG2E = 1.4426950408889634f;

constexpr int DQ_BKV = 64;  // dq: key rows per ring stage

// Consumer warpgroups of a block (64 query rows each for dq, 64 keys each
// for dk/dv) and query rows of a dk/dv ring stage, set by the registers
// (the header's "Registers")
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int WGS = 2, NQ = 32;
};
template <>
struct Tile<128> {
  static constexpr int WGS = 1, NQ = 32;
};

// One operand's addressing, as flash_attention_fwd_sm90.cu's: element
// (b, t, h, c) at tensor-map coordinates (h * head_col + c, t, b * outer_b
// + h * outer_h) and at element offset coordinate0 + t * st_seq +
// coordinate2 * st_outer.
struct Geo {
  long long st_seq, st_outer;
  int head_col, outer_b, outer_h;
};

struct Params {
  Geo q, k;            // q's serves dO and dq; k's serves v, dk and dv
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* out;           // dq, or dk
  void* out2;          // dv
  int heads, batch, tq, tk;
  float scale;       // dq and dk are scaled by it once, at the end
  float scale_log2;  // scale * log2(e)
  int causal;
};

// lse * log2(e) of query row r, or +1e30 where the row takes no part
__device__ __forceinline__ float lse2_of(const Params& p, long long row0,
                                         int r) {
  const float l = r < p.tq ? p.lse[row0 + r] : NEG;
  return l > 0.5f * NEG ? l * LOG2E : FAR;
}

__device__ __forceinline__ float delta_of(const Params& p, long long row0,
                                          int r) {
  return r < p.tq ? p.delta[row0 + r] : 0.f;
}

// d = A . B^T over D, issued (not waited for): A's 64 rows at a_addr, B's
// N rows at b_addr, both K-major, one 64-column half of D after the other
// (a_half and b_half bytes apart)
template <int HALVES, int N>
__device__ __forceinline__ void ss_wgmma(float (&d)[N / 2], uint32_t a_addr,
                                         int a_half, uint32_t b_addr,
                                         int b_half) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(a_addr + hh * a_half + 32 * kk);
      const uint64_t db = desc(b_addr + hh * b_half + 32 * kk);
      if constexpr (N == 64)
        wgmma_n64<0>(d, da, db, (hh | kk) != 0);
      else
        wgmma_n32(d, da, db, (hh | kk) != 0);
    }
}

// acc += A . B, issued: A's KS k16 slices in registers, B's rows (the
// summed index) at b_addr, MN-major, 16 rows a slice, one 64-column half of
// D after the other (b_half bytes apart)
template <int HALVES, int KS>
__device__ __forceinline__ void rs_wgmma(float (&acc)[HALVES][32],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t b_addr, int b_half) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64_rs(acc[hh], a[kk], desc(b_addr + hh * b_half + kk * 16 * 128));
}

// s rounded to bf16, packed as wgmma's A: slice kk is s[8 kk .. 8 kk + 8)
template <int KS>
__device__ __forceinline__ void pack(uint32_t (&a)[KS][4],
                                     const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

template <int N>
__device__ __forceinline__ void fence2(float (&a)[N], float (&b)[N]) {
  fence_regs(a);
  fence_regs(b);
}

template <int HALVES>
__device__ __forceinline__ void fence_acc(float (&a)[HALVES][32]) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) fence_regs(a[hh]);
}

// One 64-key x NQ-query tile of dk/dv, in place: s (S^T) becomes P, dp
// (dP^T) becomes dS = P * (dP - delta), both fp32. st holds the tile's NQ
// values of lse * log2(e), then its NQ deltas. The thread's keys are kr
// and kr + 8, its queries q0 + 8 j + c_in + {0, 1}; masked: the tile
// crosses the causal diagonal.
template <int NQ>
__device__ __forceinline__ void dkv_tile(float (&s)[NQ / 2],
                                         float (&dp)[NQ / 2], const float* st,
                                         bool masked, int q0, int kr,
                                         int c_in, int off,
                                         float scale_log2) {
#pragma unroll
  for (int jj = 0; jj < NQ / 8; ++jj) {
    const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * jj + c_in);
    const float2 dl =
        *reinterpret_cast<const float2*>(st + NQ + 8 * jj + c_in);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * jj + 2 * i + c;
        float x = fmaf(s[e], scale_log2, -(c ? l2.y : l2.x));
        if (masked && kr + 8 * i > q0 + 8 * jj + c_in + c + off)
          x = -INFINITY;  // exp2f gives exactly 0
        const float pr = exp2f(x);
        s[e] = pr;
        dp[e] = pr * (dp[e] - (c ? dl.y : dl.x));
      }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::WGS * 128 + 32, 1)
    dkv_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                    __grid_constant__ const CUtensorMap map_k,
                    __grid_constant__ const CUtensorMap map_v,
                    __grid_constant__ const CUtensorMap map_do,
                    const Params p) {
  constexpr int HALVES = D / 64;
  constexpr int WGS = Tile<D>::WGS, NQ = Tile<D>::NQ, KS = NQ / 16;
  constexpr int KEYS = 64 * WGS;
  constexpr int K_BOX = KEYS * 128;  // a 64-column half of the key tile
  constexpr int Q_BOX = NQ * 128;    // a half of a stage's query tile
  constexpr int STAGE = 2 * HALVES * Q_BOX;  // Q halves, then dO halves
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + HALVES * K_BOX;
  const uint32_t ring = v_s + HALVES * K_BOX;
  const uint32_t stats = ring + STAGES * STAGE;  // lse2 and delta per stage
  const uint32_t bar_s = stats + STAGES * 2 * NQ * 4;
  float* stats_p = reinterpret_cast<float*>(smem_raw + (stats - base));
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (STAGES + s); };
  const uint32_t kv_full = bar_s + 16u * STAGES;

  const int pairs = p.heads * p.batch;
  const int c0 = static_cast<int>(blockIdx.x) / pairs * KEYS;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int begin = p.causal ? max(0, c0 - off) / NQ * NQ : 0;
  const int ntiles = begin < p.tq ? (p.tq - begin + NQ - 1) / NQ : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA bytes and the warp's stats
      mbar_init(empty(s), WGS);    // one arrival per consumer warpgroup
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warp's role, warp-uniform in the compiler's eyes (a role read
  // from tid alone makes ptxas serialize the wgmma)
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == WGS) {  // producer warp: lane 0 issues the copies
    const int lane = tid & 31;
    const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
    const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * HALVES * K_BOX);
      for (int hh = 0; hh < HALVES; ++hh) {
        tma_load_3d(k_s + hh * K_BOX, &map_k, kc + 64 * hh, c0, ko, kv_full);
        tma_load_3d(v_s + hh * K_BOX, &map_v, kc + 64 * hh, c0, ko, kv_full);
      }
    }
    const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < ntiles; ++j) {
      const int q0 = begin + j * NQ;
      const uint32_t qs = ring + stage * STAGE;
      mbar_wait(empty(stage), phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(stage), STAGE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(qs + hh * Q_BOX, &map_q, qc + 64 * hh, q0, qo,
                      full(stage));
          tma_load_3d(qs + (HALVES + hh) * Q_BOX, &map_do, qc + 64 * hh, q0,
                      qo, full(stage));
        }
      }
      float* st = stats_p + stage * 2 * NQ;
      for (int i = lane; i < NQ; i += 32) {
        st[i] = lse2_of(p, row0, q0 + i);
        st[NQ + i] = delta_of(p, row0, q0 + i);
      }
      mbar_arrive(full(stage));  // releases this lane's stores
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: keys [c0 + 64 wg, c0 + 64 wg + 64)
  const int wg = role;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  const int first_key = c0 + 64 * wg;
  const int kr = first_key + 16 * warp + (lane >> 2);  // and kr + 8
  const int c_in = 2 * (lane & 3);  // queries 8 j + c_in + {0, 1}
  const uint32_t k_addr = k_s + wg * (64 * 128);
  const uint32_t v_addr = v_s + wg * (64 * 128);
  auto q_at = [&](int st) { return ring + st * STAGE; };
  auto do_at = [&](int st) { return ring + st * STAGE + HALVES * Q_BOX; };
  auto masked = [&](int q0) {
    return p.causal && first_key + 63 > q0 + off;
  };

  float dk[HALVES][32], dv[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[hh][e] = dv[hh][e] = 0.f;
  uint32_t pa[KS][4], da[KS][4];  // round(P^T), round(dS^T) of the last tile

  // Software pipeline: while the tensor cores accumulate tile j - 1 into
  // dV and dK, the warpgroup computes tile j's P and dS, whose score
  // products were issued first; tile j - 1's stage is released once its
  // accumulation is done.
  mbar_wait(kv_full, 0);
  if (ntiles > 0) {
    float s[NQ / 2], dp[NQ / 2];
    mbar_wait(full(0), 0);
    wgmma_fence();
    ss_wgmma<HALVES, NQ>(s, k_addr, K_BOX, q_at(0), Q_BOX);
    ss_wgmma<HALVES, NQ>(dp, v_addr, K_BOX, do_at(0), Q_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(s, dp);
    dkv_tile<NQ>(s, dp, stats_p, masked(begin), begin, kr, c_in, off,
                 p.scale_log2);
    pack<KS>(pa, s);
    pack<KS>(da, dp);
  }
  int stage = 0;  // the stage of tile j - 1
  uint32_t phase = 0;
  for (int j = 1; j < ntiles; ++j) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    const int q0 = begin + j * NQ;
    float s[NQ / 2], dp[NQ / 2];
    mbar_wait(full(stage), phase);
    fence_acc<HALVES>(dk);
    fence_acc<HALVES>(dv);
    wgmma_fence();
    ss_wgmma<HALVES, NQ>(s, k_addr, K_BOX, q_at(stage), Q_BOX);
    ss_wgmma<HALVES, NQ>(dp, v_addr, K_BOX, do_at(stage), Q_BOX);
    wgmma_commit();
    rs_wgmma<HALVES, KS>(dv, pa, do_at(prev), Q_BOX);
    rs_wgmma<HALVES, KS>(dk, da, q_at(prev), Q_BOX);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the accumulation may still run
    fence2(s, dp);
    dkv_tile<NQ>(s, dp, stats_p + stage * 2 * NQ, masked(q0), q0, kr, c_in,
                 off, p.scale_log2);
    wgmma_wait<0>();
    fence_acc<HALVES>(dk);
    fence_acc<HALVES>(dv);
    if (leader) mbar_arrive(empty(prev));
    pack<KS>(pa, s);
    pack<KS>(da, dp);
  }
  if (ntiles > 0) {  // the last tile's accumulation
    fence_acc<HALVES>(dk);
    fence_acc<HALVES>(dv);
    wgmma_fence();
    rs_wgmma<HALVES, KS>(dv, pa, do_at(stage), Q_BOX);
    rs_wgmma<HALVES, KS>(dk, da, q_at(stage), Q_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HALVES>(dk);
    fence_acc<HALVES>(dv);
  }

  // dk * scale and dv, keys past Tk not stored
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.out);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kr + 8 * i;
    if (r >= p.tk) continue;
    const long long at =
        static_cast<long long>(h) * p.k.head_col + r * p.k.st_seq +
        static_cast<long long>(b * p.k.outer_b + h * p.k.outer_h) *
            p.k.st_outer;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = 4 * jj + 2 * i;
        const long long col = at + 64 * hh + 8 * jj + c_in;
        *reinterpret_cast<uint32_t*>(dk_out + col) =
            pack_bf16(dk[hh][e] * p.scale, dk[hh][e + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_out + col) =
            pack_bf16(dv[hh][e], dv[hh][e + 1]);
      }
  }
}

// One 64-query x 64-key tile of dq, in place: dp (dP) becomes dS = P * (dP
// - delta), fp32, from s (S). The thread's rows are r and r + 8 (their
// lse * log2(e) in lse2, their delta in dl), its keys c0 + 8 j + c_in +
// {0, 1}; masked: the tile crosses the causal diagonal or the end of the
// keys.
__device__ __forceinline__ void dq_tile(const float (&s)[32], float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], bool masked,
                                        int c0, int r, int c_in,
                                        const Params& p, int off) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * jj + 2 * i + c;
        const int col = c0 + 8 * jj + c_in + c;
        float x = fmaf(s[e], p.scale_log2, -lse2[i]);
        if (masked && (col >= p.tk || (p.causal && col > r + 8 * i + off)))
          x = -INFINITY;  // exp2f gives exactly 0
        dp[e] = exp2f(x) * (dp[e] - dl[i]);
      }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::WGS * 128 + 32, 1)
    dq_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                   __grid_constant__ const CUtensorMap map_k,
                   __grid_constant__ const CUtensorMap map_v,
                   __grid_constant__ const CUtensorMap map_do,
                   const Params p) {
  constexpr int HALVES = D / 64;
  constexpr int WGS = Tile<D>::WGS, BQ = 64 * WGS;
  constexpr int Q_BOX = BQ * 128;      // a 64-column half of the query tile
  constexpr int KV_BOX = DQ_BKV * 128;  // a half of a stage's key tile
  constexpr int STAGE = 2 * HALVES * KV_BOX;  // K halves, then V halves
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + HALVES * Q_BOX;
  const uint32_t ring = do_s + HALVES * Q_BOX;
  const uint32_t bar_s = ring + STAGES * STAGE;
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (STAGES + s); };
  const uint32_t q_full = bar_s + 16u * STAGES;

  const int pairs = p.heads * p.batch;
  const int last = (p.tq + BQ - 1) / BQ - 1;
  const int q0 = (last - static_cast<int>(blockIdx.x) / pairs) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + DQ_BKV - 1) / DQ_BKV : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WGS);  // one arrival per consumer warpgroup
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == WGS) {  // producer warp: one thread issues every copy
    if (tid == 128 * WGS) {
      const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
      const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;
      mbar_expect_tx(q_full, 2 * HALVES * Q_BOX);
      for (int hh = 0; hh < HALVES; ++hh) {
        tma_load_3d(q_s + hh * Q_BOX, &map_q, qc + 64 * hh, q0, qo, q_full);
        tma_load_3d(do_s + hh * Q_BOX, &map_do, qc + 64 * hh, q0, qo, q_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < ntiles; ++j) {
        const uint32_t ks = ring + stage * STAGE;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), STAGE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(ks + hh * KV_BOX, &map_k, kc + 64 * hh, j * DQ_BKV, ko,
                      full(stage));
          tma_load_3d(ks + (HALVES + hh) * KV_BOX, &map_v, kc + 64 * hh,
                      j * DQ_BKV, ko, full(stage));
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = role;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  const int first_row = q0 + 64 * wg;
  const int r_in = first_row + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // keys 8 j + c_in + {0, 1}
  const uint32_t q_addr = q_s + wg * (64 * 128);
  const uint32_t do_addr = do_s + wg * (64 * 128);
  auto k_at = [&](int st) { return ring + st * STAGE; };
  auto v_at = [&](int st) { return ring + st * STAGE + HALVES * KV_BOX; };
  auto masked = [&](int c0) {
    return c0 + DQ_BKV > p.tk ||
           (p.causal && c0 + DQ_BKV - 1 > first_row + off);
  };
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  const float lse2[2] = {lse2_of(p, row0, r_in), lse2_of(p, row0, r_in + 8)};
  const float dl[2] = {delta_of(p, row0, r_in), delta_of(p, row0, r_in + 8)};

  float dq[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[hh][e] = 0.f;
  uint32_t da[4][4];  // round(dS) of the last tile whose scores are done

  // Software pipeline: while the tensor cores accumulate tile j - 1 into
  // dQ, the warpgroup computes tile j's dS.
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    float s[32], dp[32];
    mbar_wait(full(0), 0);
    wgmma_fence();
    ss_wgmma<HALVES, 64>(s, q_addr, Q_BOX, k_at(0), KV_BOX);
    ss_wgmma<HALVES, 64>(dp, do_addr, Q_BOX, v_at(0), KV_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(s, dp);
    dq_tile(s, dp, lse2, dl, masked(0), 0, r_in, c_in, p, off);
    pack<4>(da, dp);
  }
  int stage = 0;  // the stage of tile j - 1
  uint32_t phase = 0;
  for (int j = 1; j < ntiles; ++j) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    float s[32], dp[32];
    mbar_wait(full(stage), phase);
    fence_acc<HALVES>(dq);
    wgmma_fence();
    ss_wgmma<HALVES, 64>(s, q_addr, Q_BOX, k_at(stage), KV_BOX);
    ss_wgmma<HALVES, 64>(dp, do_addr, Q_BOX, v_at(stage), KV_BOX);
    wgmma_commit();
    rs_wgmma<HALVES, 4>(dq, da, k_at(prev), KV_BOX);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the accumulation may still run
    fence2(s, dp);
    dq_tile(s, dp, lse2, dl, masked(j * DQ_BKV), j * DQ_BKV, r_in, c_in, p,
            off);
    wgmma_wait<0>();
    fence_acc<HALVES>(dq);
    if (leader) mbar_arrive(empty(prev));
    pack<4>(da, dp);
  }
  if (ntiles > 0) {  // the last tile's accumulation
    fence_acc<HALVES>(dq);
    wgmma_fence();
    rs_wgmma<HALVES, 4>(dq, da, k_at(stage), KV_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HALVES>(dq);
  }

  // dq * scale, rows past Tq not stored
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_in + 8 * i;
    if (r >= p.tq) continue;
    const long long at =
        static_cast<long long>(h) * p.q.head_col + r * p.q.st_seq +
        static_cast<long long>(b * p.q.outer_b + h * p.q.outer_h) *
            p.q.st_outer;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(out + at + 64 * hh + 8 * jj + c_in) =
            pack_bf16(dq[hh][4 * jj + 2 * i] * p.scale,
                      dq[hh][4 * jj + 2 * i + 1] * p.scale);
  }
}

template <int D>
constexpr size_t dq_smem() {
  return 1024 + (size_t)2 * (D / 64) * 64 * Tile<D>::WGS * 128 +
         (size_t)STAGES * 2 * (D / 64) * DQ_BKV * 128 + 8 * (2 * STAGES + 1);
}

template <int D>
constexpr size_t dkv_smem() {
  constexpr int NQ = Tile<D>::NQ;
  return 1024 + (size_t)2 * (D / 64) * 64 * Tile<D>::WGS * 128 +
         (size_t)STAGES * 2 * (D / 64) * NQ * 128 + STAGES * 2 * NQ * 4 +
         8 * (2 * STAGES + 1);
}

// Tensor map of one operand: geo = {inner, outer, st_seq, st_outer, ...}
// in elements; boxes of 64 columns x rows x 1.
bool make_map_3d(CUtensorMap* map, const void* ptr, const long long* geo,
                 int seq, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(geo[0]),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(geo[1])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(geo[2]) * 2,
                                 static_cast<cuuint64_t>(geo[3]) * 2};
  return make_map(map, ptr, 3, dims, strides, rows);
}

Geo geo_of(const long long* geo) {
  return Geo{geo[2], geo[3], static_cast<int>(geo[4]),
             static_cast<int>(geo[5]), static_cast<int>(geo[6])};
}

// The four tensor maps (q and dO with box_q rows, k and v with box_k) and
// the parameters both kernels share; -2 or -3 as the entry points return.
int prepare(CUtensorMap (&maps)[4], Params& p, const void* q, const void* k,
            const void* v, const void* dout, const void* lse,
            const void* delta, int batch, int heads, int tq, int tk,
            const long long* q_geo, const long long* k_geo, float scale,
            int causal, int box_q, int box_k) {
  if (encoder() == nullptr) return -2;
  if (!make_map_3d(&maps[0], q, q_geo, tq, box_q) ||
      !make_map_3d(&maps[1], k, k_geo, tk, box_k) ||
      !make_map_3d(&maps[2], v, k_geo, tk, box_k) ||
      !make_map_3d(&maps[3], dout, q_geo, tq, box_q))
    return -3;
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  return 0;
}

template <int D>
int launch_dq(const CUtensorMap (&m)[4], const Params& p, cudaStream_t s) {
  const int err = allow_smem(dq_sm90_kernel<D>, dq_smem<D>());
  if (err) return err;
  constexpr int BQ = 64 * Tile<D>::WGS;
  const int blocks = (p.tq + BQ - 1) / BQ * p.heads * p.batch;
  dq_sm90_kernel<D><<<blocks, Tile<D>::WGS * 128 + 32, dq_smem<D>(), s>>>(
      m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const CUtensorMap (&m)[4], const Params& p, cudaStream_t s) {
  const int err = allow_smem(dkv_sm90_kernel<D>, dkv_smem<D>());
  if (err) return err;
  constexpr int KEYS = 64 * Tile<D>::WGS;
  const int blocks = (p.tk + KEYS - 1) / KEYS * p.heads * p.batch;
  dkv_sm90_kernel<D><<<blocks, Tile<D>::WGS * 128 + 32, dkv_smem<D>(),
                       s>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// At head_dim d (64 or 128; -1 otherwise): rows of a block's own tile
// (query rows for dq, keys for dk/dv) and rows of a ring stage (keys for
// dq, query rows for dk/dv).
int flash_attn_bwd_sm90_tile(int d) {
  return d == 64 ? 64 * Tile<64>::WGS : d == 128 ? 64 * Tile<128>::WGS : -1;
}
int flash_attn_dq_sm90_stage(int d) {
  return d == 64 || d == 128 ? DQ_BKV : -1;
}
int flash_attn_dkv_sm90_stage(int d) {
  return d == 64 ? Tile<64>::NQ : d == 128 ? Tile<128>::NQ : -1;
}

// bf16 q, k, v and dout (D = 64 or 128, D contiguous) addressed through
// q_geo (q, dout, dq) and k_geo (k, v, dk, dv) as flash_attn_fwd_sm90
// takes them; lse and delta [B, H, Tq] fp32. Each returns a CUDA error, or
// -1 (another D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a
// tensor map refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_dq_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int batch, int heads, int tq, int tk, int d,
                       const long long* q_geo, const long long* k_geo,
                       float scale, int causal, void* stream) {
  if ((d != 64 && d != 128) || batch <= 0 || heads <= 0 || tq <= 0 ||
      tk <= 0)
    return -1;
  CUtensorMap maps[4];
  Params p{};
  const int err = prepare(maps, p, q, k, v, dout, lse, delta, batch, heads,
                          tq, tk, q_geo, k_geo, scale, causal,
                          flash_attn_bwd_sm90_tile(d), DQ_BKV);
  if (err) return err;
  p.out = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_dq<64>(maps, p, s) : launch_dq<128>(maps, p, s);
}

int flash_attn_dkv_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int batch, int heads, int tq,
                        int tk, int d, const long long* q_geo,
                        const long long* k_geo, float scale, int causal,
                        void* stream) {
  if ((d != 64 && d != 128) || batch <= 0 || heads <= 0 || tq <= 0 ||
      tk <= 0)
    return -1;
  CUtensorMap maps[4];
  Params p{};
  const int err =
      prepare(maps, p, q, k, v, dout, lse, delta, batch, heads, tq, tk, q_geo,
              k_geo, scale, causal, flash_attn_dkv_sm90_stage(d),
              flash_attn_bwd_sm90_tile(d));
  if (err) return err;
  p.out = dk;
  p.out2 = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_dkv<64>(maps, p, s) : launch_dkv<128>(maps, p, s);
}

}  // extern "C"
