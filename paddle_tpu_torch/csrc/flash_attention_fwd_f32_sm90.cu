// Flash attention forward in fp32 on Hopper's tensor cores (sm_90a) through
// split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 64 and 128, the forward TPU kernels
// of paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call
// by _fwd): _fwd_kernel (BHTD) and _fwd_kernel_bthd (BTHD). For each query
// row r, without writing the [Tq, Tk] scores to device memory:
//     s[r, c] = (q[r] . k[c]) * scale          (fp32 products and sums)
//     lse[r]  = logsumexp over the visible c of s[r, c]
//     out[r]  = sum_c softmax(s[r])[c] * v[c]
// under the contract the head_dim-256 kernel keeps too
// (flash_attention_fwd_f32_d256_sm90.cu): the causal mask is aligned bottom-right (key c visible from row r
// iff c <= r + Tk - Tq); masked scores take no part (the online softmax
// starts from -1e30); a row that sees no key gives out 0 and lse -1e30; the
// scale multiplies the fp32 scores; fp32 P is not rounded, and the row sum
// takes it as it is. The fp32 training program (any fp32
// build_train_program) and the model jit.load returns in fp32 run it.
//
// Precision: split TF32, as lmhead_ce_fwd_f32_sm90.cu. TF32 alone keeps 10
// mantissa bits, about 1e-3 on a score. Each operand is written a = hi + lo
// with hi = tf32_rna(a) and lo = tf32_rna(a - hi), and each product is
//     lo_a . hi_b + hi_a . lo_b + hi_a . hi_b
// three tf32 products per 8-deep slice, issued in that order into one fp32
// accumulator: the scores Q K^T (8 or 16 slices of D), and P V with P split
// in registers (4 slices of keys). Both sums are short, so no
// accumulator of the tensor cores (whose fp32 sums need not round to
// nearest) runs long: the scores are new for each key tile, and so is the
// tile's P V, added in fp32 (round to nearest) to the running output.
// tests/test_torch_flash_attention_f32.py emulates this arithmetic with
// truncating tensor cores and sets the float64 bound that chip_smoke.py
// holds the kernel to.
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. The two products cost 2*D FLOPs per visible score each;
// three tf32 products of each make 12*D. At jit.load's shape (B = 1, T =
// 2048, H = 12, D = 64, non-causal) that is 38.7 GFLOP, 0.0781 ms, against
// 0.0075 ms to move q, k, v, out and lse once and 0.1923 ms for 4*D FLOPs a
// score on the 67 TFLOP/s of the FMA units.
//
// Design (the bf16 forward's, flash_attention_fwd_sm90.cu, with the split
// in shared memory).
//   - Block: 64-row query tiles, one consumer warpgroup each: two at
//     D = 64 (128 query rows), one at D = 128 (a 128-row fp32 Q tile and
//     its lo would leave room for one stage). Key tiles of 32 keys. No
//     producer warp: ptxas holds a block of 288 threads to 168 registers
//     a thread (its three warpgroups' share), which spilled. Query tiles
//     in reverse order, so that the long causal rows start first.
//   - Loads: the Q tile once, then K and V tiles through a ring of 4
//     stages at D = 64 and 2 at D = 128, all by TMA with the 128-byte
//     swizzle (a 32-column fp32 box per 128-byte row), through the bf16
//     forward's rank-3 tensor maps: TMA zero-fills past a sequence's end.
//     Thread 0 issues every load where the stage is known free without a
//     barrier of its own: with two warpgroups two tiles ahead, once the
//     split barrier of a tile has passed; with one, one tile ahead, once
//     its P V of the tile before is done. With one warpgroup the split of
//     a stage first waits at a barrier of its 128 threads: every warp's
//     P V of the stage's last tile done (one warp's wgmma wait speaks for
//     that warp alone).
//   - Split: at D = 64 each warpgroup splits its own 64 Q rows once into
//     registers, as wgmma's A fragments; at D = 128 (where they would take
//     128 registers a thread) in shared memory, hi in place and lo into a
//     buffer at the same offset (an elementwise map keeps TMA's swizzle).
//     When a stage lands, the consumers split it together, K the same way
//     and V into a transposed tile V^T (keys contiguous for each column of
//     D): tf32 wgmma reads K-major operands only, with no transpose flag,
//     and P V's B is V^T. Then a proxy fence and a barrier of all threads.
//   - Scores: wgmma m64n32k8 with K as B from shared memory and Q as A,
//     from registers at D = 64 (a shared-memory A and B read 3 KB per 16
//     cycles, 1.5 times the SM's bandwidth), from shared memory at 128.
//   - Online softmax in registers, as the bf16 forward: exp2f on scores
//     prescaled by scale * log2(e), the row max and sum over a thread's
//     values then its quad.
//   - P V: P split in registers as wgmma's A (m64n64k8, m64n128k8 at
//     D = 128). The accumulator gives a thread keys {2t, 2t+1} of each
//     8-key group where the tf32 A fragment wants keys {t, t+4}; rather
//     than shuffling, the split of V writes each 8-key group of V^T in the
//     same permuted order (logical key t holds key 2t, t + 4 key 2t + 1),
//     since the sum over keys does not depend on their order.
//   - Overlap, as the bf16 forward: tile j's scores and tile j - 1's P V
//     are issued together, and tile j's softmax runs while the product
//     does. Nothing is in flight while a stage is awaited (a spin loop) or
//     split: with tile j - 1's P V issued before that wait, ptxas
//     serialized every wgmma of the kernel (C7514). The two warpgroups of
//     D = 64 overlap one another's splits and products.
//   - Causal work: key tiles wholly above the diagonal are not loaded;
//     only tiles that cross it or the ragged edge are masked.
//   - Output: fp32 stores at the layout's strides; lse (B, H, Tq).
// Shared memory: D = 64: the Q tile (32 KB) and 4 stages of K, V, K lo,
// V^T hi and V^T lo (5 x 8 KB), 197,672 bytes; D = 128: Q hi and lo (64
// KB) and 2 stages of 5 x 16 KB, 230,424 bytes. One block per SM. ptxas
// (CUDA 12.8) gives 215 (D = 64) and 253 (D = 128) registers a thread and
// no spill; the SASS holds 72 and 120 HGMMA (chip_smoke.py's build phase
// prints both).
//
// Plain C interface, loaded with ctypes; the split, swizzle, softmax and
// tensor-map helpers from flash_f32.cuh, barrier, TMA and wgmma helpers
// from sm90.cuh.

#include <math.h>

#include "flash_f32.cuh"

namespace {

using namespace flash_f32;

constexpr float NEG = -1e30f;  // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tiling of a head_dim.
template <int D>
struct Tile {
  static constexpr int WGS = D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int BQ = 64 * WGS;          // query rows per block
  static constexpr int BKV = 32;               // keys per tile
  static constexpr int NJ = BKV / 8;           // 8-key slices of a tile
  static constexpr int KD = D / 8;             // 8-deep slices of D
  static constexpr int NC = 128 * WGS;         // threads
  static constexpr bool Q_REGS = D == 64;      // Q's split in registers
  static constexpr int Q_BOX = BQ * 128;       // 32 columns of the Q tile
  static constexpr int KV_BOX = BKV * 128;     // 32 columns of K or V
  static constexpr int QT = BQ * D * 4;        // the Q tile
  static constexpr int QLO = Q_REGS ? 0 : QT;  // its lo, in shared memory
  static constexpr int KVT = BKV * D * 4;      // K, V, K lo, V^T hi or lo
  static constexpr int STAGE = 5 * KVT;
  // as many ring stages as shared memory holds beside Q, at most 4
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 2048 - QT - QLO) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr size_t SMEM =
      1024 + QT + QLO + (size_t)STAGES * STAGE + 8 * (STAGES + 1);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  // where a stage is refilled (the kernel's loop): two warpgroups need
  // four stages, one two
  static_assert(STAGES >= (WGS == 2 ? 4 : 2), "ring stages");
};

// One operand's addressing (as flash_attention_fwd_sm90.cu): element (b, t,
// h, c) at the tensor-map coordinates (h * head_col + c, t, b * outer_b + h
// * outer_h) and the element offset coordinate0 + t * st_seq + coordinate2
// * st_outer.
struct Geo {
  long long st_seq, st_outer;
  int head_col, outer_b, outer_h;
};

struct Params {
  Geo q, k;
  float* out;  // q's layout and strides
  float* lse;  // [B, H, Tq]
  int heads, tq, tk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A landed stage split by the consumer thread c of NC: K's hi in place and
// its lo at the same offset of K lo; V into V^T hi and lo (D rows of BKV
// keys, in 32-key boxes, 128-byte swizzle). A warp reads 32 keys of 4
// columns and writes, for each column, 32 keys of one 128-byte row: both
// free of bank conflicts.
template <int D>
__device__ __forceinline__ void split_stage(unsigned char* st, int c) {
  using T = Tile<D>;
#pragma unroll
  for (int i = 0; i < T::KVT / 16 / T::NC; ++i) {
    const int f = c + T::NC * i;
    split4(st + 16 * f, st + 2 * T::KVT + 16 * f);
  }
#pragma unroll
  for (int i = 0; i < T::KVT / 16 / T::NC; ++i) {
    const int f = c + T::NC * i;
    const int key = f % T::BKV, n0 = 4 * (f / T::BKV);
    const float4 a = *reinterpret_cast<const float4*>(
        st + T::KVT + (n0 >> 5) * T::KV_BOX + swz(key, n0 & 31));
    const int kt = vt_key(key);
    unsigned char* const vh = st + 3 * T::KVT + (kt >> 5) * (D * 128);
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t o = swz(n0 + u, kt & 31);
      const float h = tf32_rna(e[u]);
      *reinterpret_cast<float*>(vh + o) = h;
      *reinterpret_cast<float*>(vh + T::KVT + o) = tf32_rna(e[u] - h);
    }
  }
}

// Q's split as wgmma's A (D = 64): slice kd in registers [kd][0 .. 3], the
// fragment's (row r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of
// the 8 columns from 8 kd.
template <int KD>
struct QFrags {
  uint32_t hi[KD][4], lo[KD][4];
};

// s = q k^T of one key tile, issued (not waited for): k the stage (K hi,
// then K lo two tiles further); per 8-deep slice of D, lo . hi, hi . lo,
// hi . hi. Q comes from registers (qf) at D = 64, else from shared memory
// (qh, ql: the warpgroup's 64 rows of Q hi and lo).
template <int D, int KD>
__device__ __forceinline__ void qk_wgmma(float (&s)[16], const QFrags<KD>& qf,
                                         uint32_t qh, uint32_t ql,
                                         uint32_t k) {
  using T = Tile<D>;
#pragma unroll
  for (int kd = 0; kd < T::KD; ++kd) {
    const uint32_t ka = k + (kd >> 2) * T::KV_BOX + 32 * (kd & 3);
    const uint64_t dkh = desc(ka), dkl = desc(ka + 2 * T::KVT);
    if constexpr (T::Q_REGS) {
      const uint32_t* h = qf.hi[kd];
      const uint32_t* l = qf.lo[kd];
      wgmma_n32_tf32_rs(s, l[0], l[1], l[2], l[3], dkh, kd != 0);
      wgmma_n32_tf32_rs(s, h[0], h[1], h[2], h[3], dkl, 1);
      wgmma_n32_tf32_rs(s, h[0], h[1], h[2], h[3], dkh, 1);
    } else {
      const uint32_t qa = (kd >> 2) * T::Q_BOX + 32 * (kd & 3);
      const uint64_t dqh = desc(qh + qa);
      wgmma_n32_tf32(s, desc(ql + qa), dkh, kd != 0);
      wgmma_n32_tf32(s, dqh, dkl, 1);
      wgmma_n32_tf32(s, dqh, dkh, 1);
    }
  }
}

// ot = P . v of one key tile, new, issued: ph, pl P's hi and lo as A (4
// registers per 8-key slice), vt the stage's V^T hi (V^T lo one tile
// further); per slice, lo . hi, hi . lo, hi . hi.
template <int D>
__device__ __forceinline__ void pv_wgmma(float (&ot)[D / 2],
                                         const uint32_t (&ph)[Tile<D>::BKV / 2],
                                         const uint32_t (&pl)[Tile<D>::BKV / 2],
                                         uint32_t vt) {
  using T = Tile<D>;
#pragma unroll
  for (int jj = 0; jj < T::NJ; ++jj) {
    const uint32_t at = vt + (jj >> 2) * (D * 128) + 32 * (jj & 3);
    const uint64_t dh = desc(at), dl = desc(at + T::KVT);
    const uint32_t* h = ph + 4 * jj;
    const uint32_t* l = pl + 4 * jj;
    if constexpr (D == 64) {
      wgmma_n64_tf32_rs(ot, l[0], l[1], l[2], l[3], dh, jj != 0);
      wgmma_n64_tf32_rs(ot, h[0], h[1], h[2], h[3], dl, 1);
      wgmma_n64_tf32_rs(ot, h[0], h[1], h[2], h[3], dh, 1);
    } else {
      wgmma_n128_tf32_rs(ot, l[0], l[1], l[2], l[3], dh, jj != 0);
      wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dl, 1);
      wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dh, 1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::NC, 1)
    flash_fwd_f32_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v,
                         const Params p) {
  using T = Tile<D>;
  constexpr int NJ = T::NJ, BKV = T::BKV, STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_hi = (raw + 1023u) & ~1023u;
  unsigned char* const gq_hi = smem_raw + (q_hi - raw);
  const uint32_t q_lo = q_hi + T::QT;
  const uint32_t ring = q_lo + T::QLO;
  unsigned char* const gring = gq_hi + T::QT + T::QLO;
  const uint32_t bar_s = ring + STAGES * T::STAGE;
  auto full = [&](int s) { return bar_s + 8u * s; };
  const uint32_t q_full = bar_s + 8u * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + T::BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + BKV - 1) / BKV : 0;
  const int tid = threadIdx.x;
  const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;

  // Thread 0 issues every load; tile j goes to stage j % STAGES. It is
  // issued where every warpgroup is done with the stage's last tile: with
  // two warpgroups, tile j + STAGES - 2 once tile j's split barrier has
  // passed (both have finished tile j - 2); with one, tile j + STAGES - 1
  // once its own tile j - 1's P V is done.
  constexpr int FIRST = T::WGS == 2 ? STAGES - 2 : STAGES;  // issued first
  auto issue = [&](int j) {
    const int stage = j % STAGES;
    const uint32_t st = ring + stage * T::STAGE;
    mbar_expect_tx(full(stage), 2 * T::KVT);
    for (int cb = 0; cb < D / 32; ++cb) {
      tma_load_3d(st + cb * T::KV_BOX, &map_k, kc + 32 * cb, j * BKV, ko,
                  full(stage));
      tma_load_3d(st + T::KVT + cb * T::KV_BOX, &map_v, kc + 32 * cb,
                  j * BKV, ko, full(stage));
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    mbar_init(q_full, 1);
    mbar_fence_init();
    const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
    mbar_expect_tx(q_full, T::QT);
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_3d(q_hi + cb * T::Q_BOX, &map_q, qc + 32 * cb, q0, qo,
                  q_full);
    for (int j = 0; j < FIRST && j < ntiles; ++j) issue(j);
  }
  __syncthreads();

  // warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64); warp-uniform
  // in the compiler's eyes (a role read from tid alone makes ptxas
  // serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int r_in = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // columns 8 j + c_in + {0, 1}
  const int first_row = q0 + 64 * wg;
  auto masked = [&](int c0) {
    return c0 + BKV > p.tk || (p.causal && c0 + BKV - 1 > first_row + off);
  };

  // the warpgroup's 64 rows of Q, split once: at D = 64 into registers as
  // wgmma's A, else in shared memory (8 KB of each 32-column box)
  QFrags<T::Q_REGS ? T::KD : 1> qf;
  mbar_wait(q_full, 0);
  if constexpr (T::Q_REGS) {
#pragma unroll
    for (int kd = 0; kd < T::KD; ++kd)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * (x & 1);
        const int col = 8 * kd + (lane & 3) + 4 * (x >> 1);
        const float a = *reinterpret_cast<const float*>(
            gq_hi + (col >> 5) * T::Q_BOX + swz(row, col & 31));
        const float hv = tf32_rna(a);
        qf.hi[kd][x] = __float_as_uint(hv);
        qf.lo[kd][x] = __float_as_uint(tf32_rna(a - hv));
      }
  } else {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int f = wtid + 128 * i;
      const uint32_t at = (f >> 9) * T::Q_BOX + wg * 8192 + 16 * (f & 511);
      split4(gq_hi + at, gq_hi + T::QT + at);
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
  }
  const uint32_t qh = q_hi + wg * 8192, ql = q_lo + wg * 8192;

  float o[D / 2], ot[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];
  uint32_t ph[4 * NJ], pl[4 * NJ];  // P of the last tile whose scores are done

  // Software pipeline, as the bf16 forward's: once tile j's stage is
  // split, its scores and tile j - 1's P V are issued together, and the
  // softmax of tile j runs while the product does; then o takes the
  // product in and tile j's rescale (o = (o + P V) * alpha). Nothing is in
  // flight while a stage is awaited or split, nor across the loop's back
  // edge: ptxas serializes every wgmma of the kernel otherwise.
  auto split_landed = [&](int j, int stage, uint32_t phase) {
    // One warpgroup (D = 128): the stage held tile j - 2, whose V^T the
    // P V of iteration j - 1 read. Each warp's wgmma_wait covers its own
    // part of that product, so all of them meet here before any thread
    // overwrites V^T.
    if constexpr (T::WGS == 1) bar_sync(1, T::NC);
    mbar_wait(full(stage), phase);
    split_stage<D>(gring + stage * T::STAGE, tid);
    fence_proxy_async();
    bar_sync(1, T::NC);
    if (T::WGS == 2 && tid == 0 && j + STAGES - 2 < ntiles)
      issue(j + STAGES - 2);
  };
  if (ntiles > 0) {
    float s[4 * NJ];
    split_landed(0, 0, 0);
    wgmma_fence();
    qk_wgmma<D>(s, qf, qh, ql, ring);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<NJ>(s, m_run, l_run, alpha, masked(0), 0, r_in, c_in, p,
                     off);
    split_p<NJ>(ph, pl, s);
  }
  int stage = 0;  // the stage of tile j - 1
  uint32_t phase = 0;
  for (int j = 1; j < ntiles; ++j) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    float s[4 * NJ];
    split_landed(j, stage, phase);
    fence_regs(ot);
    fence_a(ph);
    fence_a(pl);
    wgmma_fence();
    qk_wgmma<D>(s, qf, qh, ql, ring + stage * T::STAGE);
    wgmma_commit();
    pv_wgmma<D>(ot, ph, pl, ring + prev * T::STAGE + 3 * T::KVT);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the product may still run
    fence_regs(s);
    softmax_tile<NJ>(s, m_run, l_run, alpha, masked(j * BKV), j * BKV, r_in,
                     c_in, p, off);
    wgmma_wait<0>();
    fence_regs(ot);
    if (T::WGS == 1 && tid == 0 && j + STAGES - 1 < ntiles)
      issue(j + STAGES - 1);
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      o[e] = (o[e] + ot[e]) * alpha[(e >> 1) & 1];
    split_p<NJ>(ph, pl, s);
  }
  if (ntiles > 0) {  // the last tile's product
    fence_regs(ot);
    fence_a(ph);
    fence_a(pl);
    wgmma_fence();
    pv_wgmma<D>(ot, ph, pl, ring + stage * T::STAGE + 3 * T::KVT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] += ot[e];
  }

  // out = o / l and lse, rows past Tq not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_in + 8 * i;
    if (r >= p.tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if ((lane & 3) == 0)
      p.lse[((long long)b * p.heads + h) * p.tq + r] =
          l > 0.f ? m_run[i] * LN2 + logf(l) : NEG;
    float* const row =
        p.out + (long long)h * p.q.head_col + r * p.q.st_seq +
        (long long)(b * p.q.outer_b + h * p.q.outer_h) * p.q.st_outer;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(row + 8 * jj + c_in) =
          make_float2(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
  }
}

Geo geo_of(const long long* geo) {
  return Geo{geo[2], geo[3], static_cast<int>(geo[4]),
             static_cast<int>(geo[5]), static_cast<int>(geo[6])};
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           const long long* q_geo, const long long* k_geo, int batch,
           cudaStream_t s) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map_3d(&mq, q, q_geo, p.tq, T::BQ) ||
      !make_map_3d(&mk, k, k_geo, p.tk, T::BKV) ||
      !make_map_3d(&mv, v, k_geo, p.tk, T::BKV))
    return -3;
  const int err = allow_smem(flash_fwd_f32_kernel<D>, T::SMEM);
  if (err) return err;
  const dim3 grid((p.tq + T::BQ - 1) / T::BQ, p.heads, batch);
  flash_fwd_f32_kernel<D><<<grid, T::NC, T::SMEM, s>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of a query tile (a block) and of a key tile (a ring stage), by
// head_dim (0 for another).
int flash_attn_fwd_f32_sm90_tile_q(int d) {
  return d == 64 ? Tile<64>::BQ : d == 128 ? Tile<128>::BQ : 0;
}
int flash_attn_fwd_f32_sm90_tile_kv(int d) {
  return d == 64 ? Tile<64>::BKV : d == 128 ? Tile<128>::BKV : 0;
}

// fp32 q, k, v (D = 64 or 128, D contiguous) addressed through q_geo and
// k_geo (v shares k's) as flash_attn_fwd_sm90 takes them: {inner, outer,
// st_seq, st_outer, head_col, outer_b, outer_h}, element (b, t, h, c) at
// offset (h * head_col + c) + t * st_seq + (b * outer_b + h * outer_h) *
// st_outer. out takes q's addressing; lse is [B, H, Tq] fp32. Returns a
// CUDA error, or -1 (another D, or an empty size), -2 (no
// cuTensorMapEncodeTiled), -3 (a tensor map refused: a pointer or a stride
// not a multiple of 16 bytes).
int flash_attn_fwd_f32_sm90(const void* q, const void* k, const void* v,
                            void* out, void* lse, int batch, int heads,
                            int tq, int tk, int d, const long long* q_geo,
                            const long long* k_geo, float scale, int causal,
                            void* stream) {
  if ((d != 64 && d != 128) || batch <= 0 || heads <= 0 || tq <= 0 ||
      tk <= 0)
    return -1;
  if (encoder() == nullptr) return -2;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q, k, v, p, q_geo, k_geo, batch, s)
                 : launch<128>(q, k, v, p, q_geo, k_geo, batch, s);
}

}  // extern "C"
