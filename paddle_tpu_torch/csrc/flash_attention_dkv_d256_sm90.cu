// Flash attention dk and dv in bf16 at head_dim 256 on Hopper's tensor
// cores (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs at head_dim 256, the dk/dv TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd): _bwd_dkv_kernel (BHTD) and _bwd_dkv_kernel_bthd (BTHD). From the
// forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing a
// [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dk = scale * dS^T . Q        dv = P^T . dO
// under the contract of ops/flash_attention.py's rounding rule, as
// flash_attention_bwd_sm90.cu meets it at D = 64 and 128: the causal mask
// is aligned bottom-right (key c visible from row r iff c <= r + Tk - Tq)
// and applied before the exponential; P is rounded to bf16 before P^T .
// dO and dS before dS^T . Q; every sum is fp32 and dk is scaled once, in
// fp32, at the end. A query row that takes no part (past Tq, or with lse
// -1e30: it sees no key) gets P = 0: its lse is replaced by +1e30 before
// the exponential. The dq of the same inputs is
// flash_attention_dq_d256_sm90.cu's.
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. At B = 8, T = 2048, H = 3, D = 256, causal, the visible
// score entries number B*H*T*(T+1)/2 and each of the four products (S^T,
// dP^T, P^T . dO, dS^T . Q) costs 2*D FLOPs an entry: 103.1 GFLOP, 0.104
// ms, against under 0.05 ms to move the inputs and outputs once.
//
// Design (flash_attention_bwd_sm90.cu's key-major dk/dv, split over D
// between two warpgroups).
//   - Registers: dK and dV of 64 keys at D = 256 take 256 registers a
//     thread of one warpgroup, more than any thread holds. So the block's
//     two warpgroups share the same 64 keys and warpgroup w owns 128
//     columns of D (two of its four 64-column swizzle atoms): its half of
//     dK and dV (128 registers), and its half of the sums over D of
//     S^T = K . Q^T and dP^T = V . dO^T.
//   - Sums over D: each warpgroup sums its 128 columns in chains of two
//     k16 wgmma steps (four for S^T, four for dP^T), adds them in fp32,
//     ((c0 + c1) + (c2 + c3)), and the two warpgroups trade these partial
//     tiles through shared memory; each adds the other's, so both hold
//     the same full S^T and dP^T (fp32 addition commutes) and compute the
//     same P and dS. A slot per parity of the query tile lets one
//     256-thread barrier a tile keep a slot from being rewritten before
//     its reader is done. Why chains of two: the tensor cores' fp32 sums
//     are less exact than cuBLAS's, and a large dS or P whose rounding to
//     bf16 flips moves a whole row of dk or dv by ulp(dS) |q| scale or
//     ulp(P) |dO|. With one 4-step chain an atom (as the D = 64 kernels'
//     products), dk and dv left chip_smoke.py's bound of one bf16 ulp +
//     1e-3 against the plain version at seeds where the plain version
//     computed with exact (float64) sums stays inside it, one of them a
//     case of the smoke's own; with chains of two they leave it where the
//     exact sums do (tools/torch_flash_grad_flips.py counts both, and the
//     D = 64 and 128 kernels beside them). Each product is computed once:
//     the four minimal products, no more.
//   - A thread holds dK and dV (128), the first atom's four chains (64),
//     then their two sums (32) and the second atom's chains (64), and the
//     tile's lse and delta (16): 254 registers in ptxas's report, no
//     spill. So no producer warp (it would hold the block to 168
//     registers a thread), and no software pipeline (tile j - 1's
//     accumulation in flight with tile j's scores would hold round(P^T)
//     and round(dS^T) too): thread 0 issues every TMA load, at the top of
//     an iteration, where no wgmma is in flight and the stage's empty
//     barrier shows it free, and the two warpgroups' products and
//     elementwise work interleave on the SM.
//   - Shared memory: K and V of the block's 64 keys resident (32 KB each),
//     a ring of 3 stages of a 32-row Q tile and dO tile (32 KB a stage),
//     and the traded partial tiles (2 slots x 2 warpgroups x S^T and dP^T,
//     8 KB each): 224 KB. Stage t % 3 holds query tile t; at the top of
//     iteration j thread 0 loads tile j + 1 into the stage of tile j - 2,
//     which both warpgroups released at the end of iteration j - 2. Full
//     barriers take the TMA bytes; empty barriers one arrival per
//     warpgroup.
//   - lse and delta: each thread reads those of its 8 query columns of the
//     tile from device memory at the top of the iteration (lse, or +1e30
//     where the row takes no part); they land while the score products
//     run. P = exp(s * scale - lse) in natural units, as the plain version
//     writes it: multiplying s and lse by log2(e) first adds a rounding of
//     each to the exponent.
//   - Products, per warpgroup w and query tile (A from shared memory or,
//     packed in bf16 pairs from a score fragment, from registers):
//         S^T_w  = K_w . Q_w^T    64 keys x 32 queries over w's columns
//         dP^T_w = V_w . dO_w^T   the same with V and dO
//         dV_w  += P^T . dO_w     64 keys x w's columns, A = round(P^T),
//                                 B = the dO tile, MN-major (transpose flag)
//         dK_w  += dS^T . Q_w     A = round(dS^T), B = the Q tile
//   - Grid: one dimension, the (batch, head) pairs fastest and the lowest
//     key tiles first (the most query tiles under causal). At B = 8, T =
//     2048, H = 3: 32 x 3 x 8 = 768 blocks, one an SM.
// dk and dv are written by the block that owns their keys: no atomics, and
// the sums are deterministic.
//
// Plain C interface, loaded with ctypes; the split-D helpers from
// flash_d256.cuh, barrier, TMA and wgmma helpers from sm90.cuh.

#include <math.h>

#include "flash_d256.cuh"

namespace {

using namespace d256;

constexpr int KEYS = 64;           // keys of a block
constexpr int NQ = NT;             // query rows of a ring stage
constexpr int K_BOX = KEYS * 128;  // 64 keys x 64 bf16
constexpr int Q_BOX = T_BOX;       // 32 query rows x 64 bf16
constexpr int STAGE = 2 * HALVES * Q_BOX;  // Q atoms, then dO atoms
constexpr size_t SMEM = 1024 + (size_t)2 * HALVES * K_BOX +
                        (size_t)STAGES * STAGE + 2 * WGS * 2 * PART * 4 +
                        8 * (2 * STAGES + 1);
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

struct Params {
  Geo q, k;            // q's serves dO; k's serves v, dk and dv
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dk;
  void* dv;
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dk once, at the end
  int causal;
};

// lse and delta of the thread's query columns q0 + 8 jj + c_in + c at
// [2 jj + c]; a row past Tq or with lse -1e30 takes no part (+1e30, so
// P = 0), and a row past Tq has delta 0
__device__ __forceinline__ void row_stats(const Params& p, long long row0,
                                          int q0, int c_in, float (&lse)[8],
                                          float (&dl)[8]) {
#pragma unroll
  for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = q0 + 8 * jj + c_in + c;
      const float l = r < p.tq ? p.lse[row0 + r] : NEG;
      lse[2 * jj + c] = l > 0.5f * NEG ? l : FAR;
      dl[2 * jj + c] = r < p.tq ? p.delta[row0 + r] : 0.f;
    }
}

// One 64-key x NQ-query tile, in place: s (S^T) becomes P = exp(s * scale
// - lse), dp (dP^T) becomes dS = P * (dP - delta), both fp32. The thread's
// keys are kr and kr + 8, its queries q0 + 8 jj + c_in + {0, 1}; masked:
// the tile crosses the causal diagonal.
__device__ __forceinline__ void dkv_tile(float (&s)[NQ / 2],
                                         float (&dp)[NQ / 2],
                                         const float (&lse)[8],
                                         const float (&dl)[8], bool masked,
                                         int q0, int kr, int c_in, int off,
                                         float scale) {
#pragma unroll
  for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * jj + 2 * i + c;
        float x = fmaf(s[e], scale, -lse[2 * jj + c]);
        if (masked && kr + 8 * i > q0 + 8 * jj + c_in + c + off)
          x = -INFINITY;  // expf gives exactly 0
        const float pr = expf(x);
        s[e] = pr;
        dp[e] = pr * (dp[e] - dl[2 * jj + c]);
      }
}

__global__ void __launch_bounds__(THREADS, 1)
    dkv_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v,
                         __grid_constant__ const CUtensorMap map_do,
                         const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + HALVES * K_BOX;
  const uint32_t ring = v_s + HALVES * K_BOX;
  const uint32_t traded = ring + STAGES * STAGE;
  const uint32_t bar_s = traded + 2 * WGS * 2 * PART * 4;
  float* const trade_p = reinterpret_cast<float*>(smem_raw + (traded - base));
  // query tile t sits in stage t % STAGES; its barriers' phase is t / STAGES
  auto full = [&](int t) { return bar_s + 8u * (t % STAGES); };
  auto empty = [&](int t) { return bar_s + 8u * (STAGES + t % STAGES); };
  auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };
  auto q_at = [&](int t) { return ring + (t % STAGES) * STAGE; };
  auto do_at = [&](int t) { return q_at(t) + HALVES * Q_BOX; };
  // the partial S^T (prod 0) or dP^T (prod 1) of warpgroup w for tile t
  auto part = [&](int t, int w, int prod) {
    return trade_p + (((t & 1) * WGS + w) * 2 + prod) * PART;
  };
  const uint32_t kv_full = bar_s + 16u * STAGES;

  const int pairs = p.heads * p.batch;
  const int c0 = static_cast<int>(blockIdx.x) / pairs * KEYS;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int begin = p.causal ? max(0, c0 - off) / NQ * NQ : 0;
  const int ntiles = begin < p.tq ? (p.tq - begin + NQ - 1) / NQ : 0;
  const int tid = threadIdx.x;
  const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;

  auto load = [&](int t) {  // query tile t's Q and dO
    mbar_expect_tx(full(t), STAGE);
    for (int hh = 0; hh < HALVES; ++hh) {
      tma_load_3d(q_at(t) + hh * Q_BOX, &map_q, qc + 64 * hh,
                  begin + t * NQ, qo, full(t));
      tma_load_3d(do_at(t) + hh * Q_BOX, &map_do, qc + 64 * hh,
                  begin + t * NQ, qo, full(t));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WGS);  // one arrival per warpgroup
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
    const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;
    mbar_expect_tx(kv_full, 2 * HALVES * K_BOX);
    for (int hh = 0; hh < HALVES; ++hh) {
      tma_load_3d(k_s + hh * K_BOX, &map_k, kc + 64 * hh, c0, ko, kv_full);
      tma_load_3d(v_s + hh * K_BOX, &map_v, kc + 64 * hh, c0, ko, kv_full);
    }
    for (int t = 0; t < STAGES && t < ntiles; ++t) load(t);
  }
  __syncthreads();

  // warpgroup wg: columns [128 wg, 128 wg + 128) of D for the keys [c0,
  // c0 + 64); warp-uniform in the compiler's eyes (a role read from tid
  // alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const bool leader = wtid == 0;
  const int kr = c0 + 16 * warp + (lane >> 2);  // and kr + 8
  const int c_in = 2 * (lane & 3);  // queries 8 j + c_in + {0, 1}
  const int a0 = 2 * wg;            // the warpgroup's first atom
  auto masked = [&](int q0) { return p.causal && c0 + KEYS - 1 > q0 + off; };
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;

  // the full S^T (s) and dP^T (dp) of tile t from this warpgroup's sums:
  // traded for the other's
  auto trade = [&](float (&s)[NQ / 2], float (&dp)[NQ / 2], int t) {
    put(part(t, wg, 0), wtid, s);
    put(part(t, wg, 1), wtid, dp);
    bar_sync(1, THREADS);
    add_from(part(t, 1 - wg, 0), wtid, s);
    add_from(part(t, 1 - wg, 1), wtid, dp);
  };

  float dk[2][32], dv[2][32];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[hh][e] = dv[hh][e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    if (tid == 0 && j >= 2 && j + 1 < ntiles) {  // the header's refill
      mbar_wait(empty(j - 2), parity(j - 2));
      load(j + 1);
    }
    const int q0 = begin + j * NQ;
    const uint32_t ka = k_s + a0 * K_BOX, qa = q_at(j) + a0 * Q_BOX;
    const uint32_t va = v_s + a0 * K_BOX, da_ = do_at(j) + a0 * Q_BOX;
    float s[NQ / 2], dp[NQ / 2], c0[NQ / 2], c1[NQ / 2], c2[NQ / 2],
        c3[NQ / 2], lse[8], dl[8];
    uint32_t pa[KS][4], da[KS][4];  // round(P^T), round(dS^T)
    row_stats(p, row0, q0, c_in, lse, dl);
    mbar_wait(full(j), parity(j));
    // S^T (c0, c1) and dP^T (c2, c3) over the warpgroup's first atom, then
    // (e0 .. e3) over its second: s = (c0 + c1) + (e0 + e1). The second
    // group's accumulators are arrays of their own: issuing it into the
    // first group's arrays, once read, gave wrong sums on the card.
    wgmma_fence();
    ss_chain(c0, ka, qa, 0);
    ss_chain(c1, ka, qa, 2);
    ss_chain(c2, va, da_, 0);
    ss_chain(c3, va, da_, 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(c0, c1);
    fence2(c2, c3);
    add2(s, c0, c1, true);
    add2(dp, c2, c3, true);
    float e0[NQ / 2], e1[NQ / 2], e2[NQ / 2], e3[NQ / 2];
    wgmma_fence();
    ss_chain(e0, ka + K_BOX, qa + Q_BOX, 0);
    ss_chain(e1, ka + K_BOX, qa + Q_BOX, 2);
    ss_chain(e2, va + K_BOX, da_ + Q_BOX, 0);
    ss_chain(e3, va + K_BOX, da_ + Q_BOX, 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(e0, e1);
    fence2(e2, e3);
    add2(s, e0, e1, false);
    add2(dp, e2, e3, false);
    trade(s, dp, j);
    dkv_tile(s, dp, lse, dl, masked(q0), q0, kr, c_in, off, p.scale);
    pack(pa, s);
    pack(da, dp);
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    rs_wgmma(dv, pa, do_at(j) + a0 * Q_BOX);
    rs_wgmma(dk, da, qa);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    if (leader) mbar_arrive(empty(j));
  }

  // dk * scale and dv of the warpgroup's columns, keys past Tk not stored
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kr + 8 * i;
    if (r >= p.tk) continue;
    const long long at =
        static_cast<long long>(h) * p.k.head_col + r * p.k.st_seq +
        static_cast<long long>(b * p.k.outer_b + h * p.k.outer_h) *
            p.k.st_outer + 128 * wg;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
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

}  // namespace

extern "C" {

// Keys of a block and query rows of a ring stage.
int flash_attn_dkv_d256_sm90_tile() { return KEYS; }
int flash_attn_dkv_d256_sm90_stage() { return NQ; }

// bf16 q, k, v and dout at D = 256 (D contiguous), addressed through q_geo
// (q, dout) and k_geo (k, v, dk, dv) as flash_attn_dkv_sm90 takes them; lse
// and delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another D, or an
// empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map refused: a
// pointer or a stride not a multiple of 16 bytes).
int flash_attn_dkv_d256_sm90(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int batch,
                             int heads, int tq, int tk, int d,
                             const long long* q_geo, const long long* k_geo,
                             float scale, int causal, void* stream) {
  if (d != D || batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map_3d(&mq, q, q_geo, tq, NQ) ||
      !make_map_3d(&mk, k, k_geo, tk, KEYS) ||
      !make_map_3d(&mv, v, k_geo, tk, KEYS) ||
      !make_map_3d(&mdo, dout, q_geo, tq, NQ))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dkv_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tk + KEYS - 1) / KEYS * heads * batch;
  dkv_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mdo,
                                                              p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
