// Flash attention dk and dv in fp32 at head_dim 256 on Hopper's tensor
// cores (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 256, the dk/dv TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd): _bwd_dkv_kernel (BHTD) and _bwd_dkv_kernel_bthd (BTHD). From the
// forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing a
// [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dk = scale * dS^T . Q        dv = P^T . dO
// under the contract of ops/flash_attention.py's rounding rule, which
// every flash kernel keeps: the causal mask is aligned bottom-right (key c
// visible from row r iff c <= r + Tk - Tq) and applied before the
// exponential; P and dS are not rounded (the plain fp32 version rounds
// nothing); every sum is fp32 and dk is scaled in fp32 (each group's sum
// before it is added in, below: at head_dim 256's default scale, 1/16,
// the same bits as scaling the total once). A query row that takes no part (past Tq, or with lse -1e30: it sees no
// key) gets P = 0: its lse is replaced by +1e30 before the exponential.
//
// Precision: split TF32, as the fp32 forward at head_dim 256: each operand
// a = hi + lo with hi = tf32_rna(a) and lo = tf32_rna(a - hi), each product
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, three tf32 wgmma per 8-deep
// slice into one fp32 accumulator. A score sums 96 tf32 products over D =
// 256: each 32-column box of D is a chain of its own (12 products), the
// chains added in fp32, ((c0 + c1) + (c2 + c3)) over a warpgroup's 128
// columns, then the two warpgroups' partial sums. P and dS are split the
// same way for the second products. dK and dV sum over the query rows in
// the tensor cores' accumulators, whose fp32 sums need not round to
// nearest: a group of FLUSH stage tiles (128 query rows, counted from row
// 0) is summed in an accumulator, and the groups' sums are added in fp32,
// in order, in dk and dv in device memory: the first group's stored by
// TMA, each later one added by TMA's reduction in L2, each issued once
// every earlier one is complete (each block owns its keys: no other block
// adds to them, and the order is fixed). tests/
// test_torch_flash_attention_f32_bwd.py emulates this arithmetic with
// truncating tensor cores and sets the float64 bound chip_smoke.py holds
// the kernel to (one accumulator over all 2048 rows of the training shape
// put dv 90 times the plain version's error from float64 there; groups of
// 128 rows, under 13).
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. At B = 8, T = 2048, H = 3, D = 256, causal, the visible
// scores number B*H*T*(T+1)/2 = 50,356,224 and each of the four products
// (S^T, dP^T, dV, dK) costs 2*D FLOPs a score, three tf32 products each:
// 309.4 GFLOP, 0.625 ms, against 0.103 ms for the same work on the tensor
// cores of one product (1.539 ms on the 67 TFLOP/s FMA units) and 0.07 ms
// to move the inputs and outputs once.
//
// Design (counted before the code: bytes of shared memory and registers a
// thread).
//   - Registers: dK and dV of 64 keys at D = 256 take 256 registers a
//     thread of one warpgroup. So the block's two warpgroups share the 64
//     keys and warpgroup w owns the 128 columns [128 w, 128 w + 128) of D
//     (32-column boxes 4 w .. 4 w + 3): its half of dK and dV (64 + 64
//     registers) and its half of the sums over D of S^T = K . Q^T and dP^T
//     = V . dO^T, traded through shared memory as the bf16 kernel trades
//     them (flash_attention_dkv_d256_sm90.cu). No producer warp (ptxas
//     would hold the block to 168 registers a thread): thread 0 issues
//     every TMA load.
//   - Operands. tf32 wgmma reads only K-major operands, and B comes from
//     shared memory, so neither a row-major Q nor dO tile can be the B of
//     dV = P^T . dO or dK = dS^T . Q, which sum over query rows. The
//     products run transposed: dV^T = dO^T . P and dK^T = Q^T . dS, M the
//     warpgroup's 128 columns of D (two m64 blocks), N the 64 keys, K the
//     query rows. A (dO^T, Q^T) is gathered into registers from the split
//     row-major stage tile; B is the small split P^T or dS^T tile (64 keys
//     x 16 query rows, hi and lo side by side in 128-byte rows: 8 KB),
//     written key-major from the score fragments. Transposed hi/lo copies
//     of Q and dO (64 KB a 16-row stage) would not fit beside the rest.
//   - Shared memory (227 KB a block): K and V of the block's 64 keys
//     resident and raw (64 KB each); a 64 x 256 fp32 tile takes 64 KB, so
//     they are split per 32-column box into registers for each stage tile
//     (the scores' A, 32 registers a box), as the fp32 forward splits Q.
//     One stage of 16 query rows of Q and dO, each split in place into hi
//     and lo (4 x 16 KB: a 32-row stage would take 128 KB); the split P^T
//     and dS^T (2 x 8 KB); the traded partial S^T and dP^T (4 x 4 KB):
//     229,376 bytes + alignment and barriers, 230,416.
//   - Registers a thread: dK^T, dV^T 128; half a box's split K or V
//     fragments (16), the score chains in flight or held (up to 32) and
//     the sums S^T, dP^T (16) while the scores run (one chain a box, two
//     groups of 6 wgmma a chain, each waited for before the next group's
//     fragments are split); lse and
//     delta (8) read after the scores; the gathered dO^T and Q^T hi and lo
//     (64) while the accumulating products are issued. ptxas: 246
//     registers, no spill, 120 HGMMA.
//   - Per stage tile (16 query rows) and warpgroup: split its half of Q
//     and dO; S^T and dP^T, 4 chains each (A = K or V box from registers,
//     B = Q or dO box hi and lo, wgmma m64n16k8: 96 a tile); trade; P and
//     dS (natural exp of s * scale - lse, as the bf16 kernels); warpgroup
//     0 writes P^T split, warpgroup 1 dS^T; gather dO^T and Q^T; dV^T and
//     dK^T (wgmma m64n64k8, 24 a tile). Thread 0 loads the next stage
//     tile once both warpgroups have gathered, while those products run.
//   - Flush, once a group: dK^T * scale, then dV^T, staged in the stage's
//     64 KB as the output's eight 32-column boxes of 64 keys, stored or
//     added by thread 0 through TMA (rows past Tk are not written); the
//     next group's first stage tile is loaded after it. A read-modify-
//     write of dk and dv from registers instead took 3.3 of the kernel's
//     5.7 ms (tools/torch_flash_f32_d256_bwd_ablation.py): a thread's
//     loads of scattered words, few in flight.
//   - Grid: one dimension, the (batch, head) pairs fastest and the lowest
//     key tiles first (the most query tiles under causal). At B = 8, T =
//     2048, H = 3: 32 x 3 x 8 = 768 blocks, one an SM.
//   - Causal work: query tiles wholly above the diagonal are not loaded;
//     TMA's rank-3 tensor maps (ops/flash_attention.py:tma_geometry) read
//     both layouts without a copy, and a box past a sequence's end reads
//     zeros.
//
// Plain C interface, loaded with ctypes; the split-TF32 backward helpers
// from flash_f32_bwd.cuh, the split and swizzle from flash_f32.cuh,
// barrier, TMA and wgmma helpers from sm90.cuh.

#include <math.h>

#include "flash_f32_bwd.cuh"

namespace {

using namespace f32bwd;
using d256::geo_of;

constexpr int KEYS = RES;  // keys of a block
constexpr int NQ = NS;     // query rows of a stage tile
constexpr size_t SMEM = 1024 + 2 * (size_t)RES_T + 4 * (size_t)ST_T +
                        2 * X_T + 4 * PART * 4 + 8 * 2;
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

struct Params {
  Geo q, k;            // q's serves dO; k's serves v, dk and dv
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  float* dk;
  float* dv;
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dk once, at the end
  int causal;
};

__global__ void __launch_bounds__(THREADS, 1)
    dkv_f32_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                             __grid_constant__ const CUtensorMap map_k,
                             __grid_constant__ const CUtensorMap map_v,
                             __grid_constant__ const CUtensorMap map_do,
                             __grid_constant__ const CUtensorMap map_dk,
                             __grid_constant__ const CUtensorMap map_dv,
                             const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  unsigned char* const gk = smem_raw + (k_s - raw);
  // K, V (resident, raw); the stage's Q hi, Q lo, dO hi, dO lo; P^T, dS^T
  // (split); the traded partials; the barriers
  const uint32_t v_s = k_s + RES_T, q_s = v_s + RES_T, do_s = q_s + 2 * ST_T;
  const uint32_t x_s = do_s + 2 * ST_T, part_s = x_s + 2 * X_T;
  unsigned char* const gv = gk + RES_T;
  unsigned char* const gq = gk + (q_s - k_s);
  unsigned char* const gdo = gk + (do_s - k_s);
  unsigned char* const gx = gk + (x_s - k_s);
  float* const part = reinterpret_cast<float*>(gk + (part_s - k_s));
  const uint32_t kv_full = part_s + 4 * PART * 4, st_full = kv_full + 8;

  const int pairs = p.heads * p.batch;
  const int c0 = static_cast<int>(blockIdx.x) / pairs * KEYS;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int begin = p.causal ? max(0, c0 - off) / NQ * NQ : 0;
  const int ntiles = begin < p.tq ? (p.tq - begin + NQ - 1) / NQ : 0;
  const int tid = threadIdx.x;
  const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
  const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;

  auto load = [&](int j) {  // stage tile j's Q and dO
    mbar_expect_tx(st_full, 2 * ST_T);
    for (int cb = 0; cb < BOXES; ++cb) {
      tma_load_3d(q_s + cb * ST_BOX, &map_q, qc + 32 * cb, begin + j * NQ,
                  qo, st_full);
      tma_load_3d(do_s + cb * ST_BOX, &map_do, qc + 32 * cb, begin + j * NQ,
                  qo, st_full);
    }
  };
  if (tid == 0 && ntiles > 0) {  // no load is left in flight at the exit
    mbar_init(kv_full, 1);
    mbar_init(st_full, 1);
    mbar_fence_init();
    mbar_expect_tx(kv_full, 2 * RES_T);
    for (int cb = 0; cb < BOXES; ++cb) {
      tma_load_3d(k_s + cb * RES_BOX, &map_k, kc + 32 * cb, c0, ko, kv_full);
      tma_load_3d(v_s + cb * RES_BOX, &map_v, kc + 32 * cb, c0, ko, kv_full);
    }
    load(0);
  }
  __syncthreads();

  // warpgroup wg: columns [128 wg, 128 wg + 128) of D for the keys [c0,
  // c0 + 64); warp-uniform in the compiler's eyes (a role read from tid
  // alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int kr = c0 + 16 * warp + (lane >> 2);  // and kr + 8
  const int c_in = 2 * (lane & 3);  // queries 8 jj + c_in + {0, 1}
  const int box0 = OWN * wg;        // the warpgroup's first box
  auto masked = [&](int q0) { return p.causal && c0 + KEYS - 1 > q0 + off; };
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  // the partial S^T (prod 0) or dP^T (prod 1) of warpgroup w
  auto slot = [&](int w, int prod) { return part + (w * 2 + prod) * PART; };

  if (ntiles > 0) mbar_wait(kv_full, 0);
  int j = 0;
  bool first = true;
  do {  // a group: the stage tiles up to the next multiple of FLUSH
    const int group_end =
        min(ntiles, j + FLUSH - (begin / NQ + j) % FLUSH);
    float dk[2][32], dv[2][32];
    zero_acc(dk);
    zero_acc(dv);
    for (; j < group_end; ++j) {
      const int q0 = begin + j * NQ;
      mbar_wait(st_full, j & 1);
      split_stage(gq, box0, wtid);
      split_stage(gdo, box0, wtid);
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      float s[8], dp[8];
      scores(s, dp, gk, q_s, gv, do_s, box0, warp, lane);
      float lse[4], dl[4];  // read here: registers are short in the scores
      row_stats(p, row0, q0, c_in, lse, dl);
      // the trade: each warpgroup's partials in its own slots, read by the
      // other after the barrier (the slots are rewritten after the next
      // tile's first barrier below, which the reader passes after reading)
      put(slot(wg, 0), wtid, s);
      put(slot(wg, 1), wtid, dp);
      bar_sync(1, THREADS);
      add_from(slot(1 - wg, 0), wtid, s);
      add_from(slot(1 - wg, 1), wtid, dp);
      dkv_tile(s, dp, lse, dl, masked(q0), q0, kr, c_in, off, p.scale);
      // P^T (warpgroup 0) and dS^T (warpgroup 1) as B; the previous tile's
      // products that read them were waited for before the trade
      if (wg == 0)
        put_split(gx, s, warp, lane, 0, 2);
      else
        put_split(gx + X_T, dp, warp, lane, 0, 2);
      fence_proxy_async();
      bar_sync(1, THREADS);
      TFrag fo, fq;  // dO^T, Q^T
      gather_t(fo, gdo, wg, warp, lane);
      gather_t(fq, gq, wg, warp, lane);
      fence_acc(dk);
      fence_acc(dv);
      wgmma_fence();
      acc_wgmma(dv, fo, x_s);
      acc_wgmma(dk, fq, x_s + X_T);
      wgmma_commit();
      // every thread has gathered: the stage is free for the next tile
      // (within the group: the flush stages its sums there)
      bar_sync(1, THREADS);
      if (tid == 0 && j + 1 < group_end) load(j + 1);
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
    }
    // the flush: dK * scale, then dV, staged in the stage's 64 KB (nobody
    // reads it after the last tile's barrier) and stored or added by TMA
    stage_out(dk, gq, p.scale, wg, warp, lane);
    fence_proxy_async();
    bar_sync(1, THREADS);
    if (tid == 0) flush_out(&map_dk, q_s, kc, c0, ko, first);
    bar_sync(1, THREADS);
    stage_out(dv, gq, 1.f, wg, warp, lane);
    fence_proxy_async();
    bar_sync(1, THREADS);
    if (tid == 0) {
      flush_out(&map_dv, q_s, kc, c0, ko, first);
      if (j < ntiles) load(j);
    }
    bar_sync(1, THREADS);
    first = false;
  } while (j < ntiles);
  if (tid == 0) bulk_wait<0>();
}

}  // namespace

extern "C" {

// Keys of a block, query rows of a stage tile, stage tiles of a group.
int flash_attn_dkv_f32_d256_sm90_tile() { return KEYS; }
int flash_attn_dkv_f32_d256_sm90_stage() { return NQ; }
int flash_attn_dkv_f32_d256_sm90_flush() { return FLUSH; }

// fp32 q, k, v and dout at D = 256 (D contiguous), addressed through q_geo
// (q, dout) and k_geo (k, v, dk, dv) as flash_attn_dkv_d256_sm90 takes
// them; lse and delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another
// D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map
// refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_dkv_f32_d256_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int batch, int heads, int tq, int tk, int d,
                                 const long long* q_geo,
                                 const long long* k_geo, float scale,
                                 int causal, void* stream) {
  if (d != D || batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!make_map_3d(&mq, q, q_geo, tq, NQ) ||
      !make_map_3d(&mk, k, k_geo, tk, KEYS) ||
      !make_map_3d(&mv, v, k_geo, tk, KEYS) ||
      !make_map_3d(&mdo, dout, q_geo, tq, NQ) ||
      !make_map_3d(&mdk, dk, k_geo, tk, KEYS) ||
      !make_map_3d(&mdv, dv, k_geo, tk, KEYS))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dkv_f32_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tk + KEYS - 1) / KEYS * heads * batch;
  dkv_f32_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, mdk, mdv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
