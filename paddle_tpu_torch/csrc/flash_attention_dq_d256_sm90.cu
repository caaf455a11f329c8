// Flash attention dq in bf16 at head_dim 256 on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs at head_dim 256, the dq TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd): _bwd_dq_kernel (BHTD) and _bwd_dq_kernel_bthd (BTHD). From the
// forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing a
// [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dq = scale * dS . K
// under the contract of flash_attention_bwd_sm90.cu, which meets it at D =
// 64 and 128: the causal mask is aligned bottom-right (key c visible from
// row r iff c <= r + Tk - Tq) and applied before the exponential; dS is
// rounded to bf16 before dS . K; every sum is fp32 and dq is scaled once,
// in fp32, at the end. A query row that takes no part (past Tq, or with
// lse -1e30: it sees no key) gets P = 0: its lse is replaced by +1e30
// before the exponential. Keys past Tk are masked.
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. At B = 8, T = 2048, H = 3, D = 256, causal, the visible
// score entries number B*H*T*(T+1)/2 and each of the three products (S,
// dP, dS . K) costs 2*D FLOPs an entry: 77.35 GFLOP, 0.0782 ms, against
// under 0.04 ms to move the inputs and the output once.
//
// Design (flash_attention_bwd_sm90.cu's query-major dq, split over D
// between two warpgroups as flash_attention_dkv_d256_sm90.cu splits
// dk/dv).
//   - Registers: dQ of 64 query rows at D = 256 takes 128 registers a
//     thread of one warpgroup. The block's two warpgroups share the same
//     64 rows and warpgroup w owns 128 columns of D (two of its four
//     64-column swizzle atoms): its half of dQ (64 registers), and its
//     half of the sums over D of S = Q . K^T and dP = dO . V^T.
//   - Sums over D: each warpgroup sums its 128 columns in chains of two
//     k16 wgmma steps, adds them in fp32, ((c0 + c1) + (e0 + e1)), and the
//     two warpgroups trade these partial 64 x 32 tiles through shared
//     memory; each adds the other's, so both hold the same full S and dP
//     (fp32 addition commutes) and compute the same dS. A slot per parity
//     of the key tile lets one 256-thread barrier a tile keep a slot from
//     being rewritten before its reader is done. The chains are those of
//     dk/dv's kernel, for its reason: a large dS whose bf16 rounding
//     flips moves a row of dq by ulp(dS) |k| scale, and longer chains
//     (the tensor cores' fp32 sums are less exact than cuBLAS's) made
//     such flips leave chip_smoke.py's bound of one bf16 ulp + 1e-3 where
//     exact sums do not. P and dS come from S and dP as dk/dv's kernel
//     computes them (natural exp of s * scale - lse, one fmaf), so the
//     two kernels' dS agree wherever their score sums do.
//   - No producer warp (it would hold the block to 168 registers a
//     thread) and no software pipeline: thread 0 issues every TMA load,
//     at the top of an iteration, where no wgmma is in flight and the
//     stage's empty barrier shows it free, and the two warpgroups' products
//     and elementwise work interleave on the SM.
//   - Shared memory: Q and dO of the block's 64 rows resident (32 KB
//     each), a ring of 3 stages of a 32-key K tile and V tile (32 KB a
//     stage), and the traded partial tiles (2 slots x 2 warpgroups x S
//     and dP, 8 KB each): 224 KB. Stage t % 3 holds key tile t; at the
//     top of iteration j thread 0 loads tile j + 1 into the stage of tile
//     j - 2, which both warpgroups released at the end of iteration j - 2.
//   - lse and delta are per row: each thread reads those of its two rows
//     once, before the loop.
//   - Products, per warpgroup w and key tile (A from shared memory or,
//     packed in bf16 pairs from a score fragment, from registers):
//         S_w  = Q_w . K_w^T    64 rows x 32 keys over w's columns
//         dP_w = dO_w . V_w^T   the same with dO and V
//         dQ_w += dS . K_w      64 rows x w's columns, A = round(dS), B =
//                               the K tile, MN-major (transpose flag)
//   - Grid: one dimension, the (batch, head) pairs fastest and the last
//     query tiles first (the most key tiles under causal). At B = 8, T =
//     2048, H = 3: 32 x 3 x 8 = 768 blocks, one an SM.
//   - Why this and not two warpgroups on 128 query rows, each holding dQ
//     over all of D (no trade, half the L2 traffic of K and V a query
//     row): measured at the shape above (tools/torch_flash_dq_ablation.py,
//     device ms, H100 SXM at 700 W), the kernel takes 0.338-0.345 ms;
//     without the trade 0.301-0.307, without reloading K and V
//     0.315-0.316. The alternative could save at most those two parts,
//     about a sixth, while its 128 accumulator registers a thread leave
//     64 for the score chains, S, dP and addresses where this design uses
//     221 in all. The time goes to the score products and their waits
//     (0.156 ms with neither the trade, the exponentials nor dS . K) and
//     to dS . K (0.244 without it).
// dq is written by the block that owns its rows: no atomics, and the sums
// are deterministic.
//
// Plain C interface, loaded with ctypes; the split-D helpers from
// flash_d256.cuh, barrier, TMA and wgmma helpers from sm90.cuh.

#include <math.h>

#include "flash_d256.cuh"

namespace {

using namespace d256;

constexpr int BQ = 64;             // query rows of a block
constexpr int NK = NT;             // keys of a ring stage
constexpr int Q_BOX = BQ * 128;    // 64 query rows x 64 bf16
constexpr int KV_BOX = T_BOX;      // 32 keys x 64 bf16
constexpr int STAGE = 2 * HALVES * KV_BOX;  // K atoms, then V atoms
constexpr size_t SMEM = 1024 + (size_t)2 * HALVES * Q_BOX +
                        (size_t)STAGES * STAGE + 2 * WGS * 2 * PART * 4 +
                        8 * (2 * STAGES + 1);
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

struct Params {
  Geo q, k;            // q's serves dO and dq; k's serves v
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dq once, at the end
  int causal;
};

// One 64-row x NK-key tile, in place: dp (dP) becomes dS = P * (dP -
// delta), fp32, with P = exp(s * scale - lse). The thread's rows are r and
// r + 8 (their lse in lse, their delta in dl), its keys k0 + 8 jj + c_in +
// {0, 1}; masked: the tile crosses the causal diagonal or the end of the
// keys.
__device__ __forceinline__ void dq_tile(const float (&s)[NK / 2],
                                        float (&dp)[NK / 2],
                                        const float (&lse)[2],
                                        const float (&dl)[2], bool masked,
                                        int k0, int r, int c_in,
                                        const Params& p, int off) {
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * jj + 2 * i + c;
        const int col = k0 + 8 * jj + c_in + c;
        float x = fmaf(s[e], p.scale, -lse[i]);
        if (masked && (col >= p.tk || (p.causal && col > r + 8 * i + off)))
          x = -INFINITY;  // expf gives exactly 0
        dp[e] = expf(x) * (dp[e] - dl[i]);
      }
}

__global__ void __launch_bounds__(THREADS, 1)
    dq_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                        __grid_constant__ const CUtensorMap map_k,
                        __grid_constant__ const CUtensorMap map_v,
                        __grid_constant__ const CUtensorMap map_do,
                        const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t do_s = q_s + HALVES * Q_BOX;
  const uint32_t ring = do_s + HALVES * Q_BOX;
  const uint32_t traded = ring + STAGES * STAGE;
  const uint32_t bar_s = traded + 2 * WGS * 2 * PART * 4;
  float* const trade_p = reinterpret_cast<float*>(smem_raw + (traded - base));
  // key tile t sits in stage t % STAGES; its barriers' phase is t / STAGES
  auto full = [&](int t) { return bar_s + 8u * (t % STAGES); };
  auto empty = [&](int t) { return bar_s + 8u * (STAGES + t % STAGES); };
  auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };
  auto k_at = [&](int t) { return ring + (t % STAGES) * STAGE; };
  auto v_at = [&](int t) { return k_at(t) + HALVES * KV_BOX; };
  // the partial S (prod 0) or dP (prod 1) of warpgroup w for tile t
  auto part = [&](int t, int w, int prod) {
    return trade_p + (((t & 1) * WGS + w) * 2 + prod) * PART;
  };
  const uint32_t q_full = bar_s + 16u * STAGES;

  const int pairs = p.heads * p.batch;
  const int last = (p.tq + BQ - 1) / BQ - 1;
  const int q0 = (last - static_cast<int>(blockIdx.x) / pairs) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + NK - 1) / NK : 0;
  const int tid = threadIdx.x;
  const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;

  auto load = [&](int t) {  // key tile t's K and V
    mbar_expect_tx(full(t), STAGE);
    for (int hh = 0; hh < HALVES; ++hh) {
      tma_load_3d(k_at(t) + hh * KV_BOX, &map_k, kc + 64 * hh, t * NK, ko,
                  full(t));
      tma_load_3d(v_at(t) + hh * KV_BOX, &map_v, kc + 64 * hh, t * NK, ko,
                  full(t));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WGS);  // one arrival per warpgroup
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
    const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
    mbar_expect_tx(q_full, 2 * HALVES * Q_BOX);
    for (int hh = 0; hh < HALVES; ++hh) {
      tma_load_3d(q_s + hh * Q_BOX, &map_q, qc + 64 * hh, q0, qo, q_full);
      tma_load_3d(do_s + hh * Q_BOX, &map_do, qc + 64 * hh, q0, qo, q_full);
    }
    for (int t = 0; t < STAGES && t < ntiles; ++t) load(t);
  }
  __syncthreads();

  // warpgroup wg: columns [128 wg, 128 wg + 128) of D for the rows [q0,
  // q0 + 64); warp-uniform in the compiler's eyes (a role read from tid
  // alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const bool leader = wtid == 0;
  const int r_in = q0 + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // keys 8 j + c_in + {0, 1}
  const int a0 = 2 * wg;            // the warpgroup's first atom
  auto masked = [&](int k0) {
    return k0 + NK > p.tk || (p.causal && k0 + NK - 1 > q0 + off);
  };
  // lse (+1e30 where the row takes no part) and delta of the thread's rows
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_in + 8 * i;
    const float l = r < p.tq ? p.lse[row0 + r] : NEG;
    lse[i] = l > 0.5f * NEG ? l : FAR;
    dl[i] = r < p.tq ? p.delta[row0 + r] : 0.f;
  }

  // the full S (s) and dP (dp) of tile t from this warpgroup's sums:
  // traded for the other's
  auto trade = [&](float (&s)[NK / 2], float (&dp)[NK / 2], int t) {
    put(part(t, wg, 0), wtid, s);
    put(part(t, wg, 1), wtid, dp);
    bar_sync(1, THREADS);
    add_from(part(t, 1 - wg, 0), wtid, s);
    add_from(part(t, 1 - wg, 1), wtid, dp);
  };

  float dq[2][32];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[hh][e] = 0.f;

  mbar_wait(q_full, 0);
  const uint32_t qa = q_s + a0 * Q_BOX, da_ = do_s + a0 * Q_BOX;
  for (int j = 0; j < ntiles; ++j) {
    if (tid == 0 && j >= 2 && j + 1 < ntiles) {  // the header's refill
      mbar_wait(empty(j - 2), parity(j - 2));
      load(j + 1);
    }
    const int k0 = j * NK;
    const uint32_t ka = k_at(j) + a0 * KV_BOX, va = v_at(j) + a0 * KV_BOX;
    float s[NK / 2], dp[NK / 2], c0[NK / 2], c1[NK / 2], c2[NK / 2],
        c3[NK / 2];
    uint32_t da[KS][4];  // round(dS)
    mbar_wait(full(j), parity(j));
    // S (c0, c1) and dP (c2, c3) over the warpgroup's first atom, then
    // (e0 .. e3) over its second: s = (c0 + c1) + (e0 + e1). The second
    // group's accumulators are arrays of their own, as in dk/dv's kernel.
    wgmma_fence();
    ss_chain(c0, qa, ka, 0);
    ss_chain(c1, qa, ka, 2);
    ss_chain(c2, da_, va, 0);
    ss_chain(c3, da_, va, 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(c0, c1);
    fence2(c2, c3);
    add2(s, c0, c1, true);
    add2(dp, c2, c3, true);
    float e0[NK / 2], e1[NK / 2], e2[NK / 2], e3[NK / 2];
    wgmma_fence();
    ss_chain(e0, qa + Q_BOX, ka + KV_BOX, 0);
    ss_chain(e1, qa + Q_BOX, ka + KV_BOX, 2);
    ss_chain(e2, da_ + Q_BOX, va + KV_BOX, 0);
    ss_chain(e3, da_ + Q_BOX, va + KV_BOX, 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence2(e0, e1);
    fence2(e2, e3);
    add2(s, e0, e1, false);
    add2(dp, e2, e3, false);
    trade(s, dp, j);
    dq_tile(s, dp, lse, dl, masked(k0), k0, r_in, c_in, p, off);
    pack(da, dp);
    fence_acc(dq);
    wgmma_fence();
    rs_wgmma(dq, da, ka);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    if (leader) mbar_arrive(empty(j));
  }

  // dq * scale of the warpgroup's columns, rows past Tq not stored
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_in + 8 * i;
    if (r >= p.tq) continue;
    const long long at =
        static_cast<long long>(h) * p.q.head_col + r * p.q.st_seq +
        static_cast<long long>(b * p.q.outer_b + h * p.q.outer_h) *
            p.q.st_outer + 128 * wg;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = 4 * jj + 2 * i;
        *reinterpret_cast<uint32_t*>(out + at + 64 * hh + 8 * jj + c_in) =
            pack_bf16(dq[hh][e] * p.scale, dq[hh][e + 1] * p.scale);
      }
  }
}

}  // namespace

extern "C" {

// Query rows of a block and keys of a ring stage.
int flash_attn_dq_d256_sm90_tile() { return BQ; }
int flash_attn_dq_d256_sm90_stage() { return NK; }

// bf16 q, k, v and dout at D = 256 (D contiguous), addressed through q_geo
// (q, dout, dq) and k_geo (k, v) as flash_attn_dq_sm90 takes them; lse and
// delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another D, or an
// empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map refused: a
// pointer or a stride not a multiple of 16 bytes).
int flash_attn_dq_d256_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int batch,
                            int heads, int tq, int tk, int d,
                            const long long* q_geo, const long long* k_geo,
                            float scale, int causal, void* stream) {
  if (d != D || batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map_3d(&mq, q, q_geo, tq, BQ) ||
      !make_map_3d(&mk, k, k_geo, tk, NK) ||
      !make_map_3d(&mv, v, k_geo, tk, NK) ||
      !make_map_3d(&mdo, dout, q_geo, tq, BQ))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dq_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tq + BQ - 1) / BQ * heads * batch;
  dq_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mdo,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
