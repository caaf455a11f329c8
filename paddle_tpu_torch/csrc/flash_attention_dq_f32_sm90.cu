// Flash attention dq in fp32 at head_dim 64 and 128 on Hopper's tensor
// cores (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 64 and 128, the dq TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd): _bwd_dq_kernel (BHTD) and _bwd_dq_kernel_bthd (BTHD). From the
// forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing a
// [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dq = scale * dS . K
// under the contract of flash_attention_dq_f32_d256_sm90.cu and
// flash_attention_dkv_f32_sm90.cu: the causal mask is aligned bottom-right
// (key c visible from row r iff c <= r + Tk - Tq) and applied before the
// exponential; P and dS are not rounded (the plain fp32 version rounds
// nothing); P = exp(s * scale - lse) is one fmaf and a natural exp; every
// sum is fp32 and dq is scaled in fp32, each group's sum before it is
// added in (below). A query row that takes no part (past Tq, or with lse
// -1e30: it sees no key) gets P = 0: its lse is replaced by +1e30 before
// the exponential. So this kernel's dS agrees with dk/dv's wherever their
// score sums do.
//
// Precision: split TF32, as the other fp32 backward kernels: each operand
// a = hi + lo with hi = tf32_rna(a) and lo = tf32_rna(a - hi), each
// product lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, three tf32 wgmma per
// 8-deep slice into one fp32 accumulator. Each 32-column box of D is a
// score chain of its own (12 products), the chains added in fp32: c0 + c1
// at D = 64, ((c0 + c1) + (c2 + c3)) at 128. dS is split the same way for
// dS . K. dQ sums over the keys in the tensor cores' accumulators, whose
// fp32 sums need not round to nearest: a group of FLUSH stage tiles (128
// keys, counted from key 0) is summed in an accumulator, and the groups'
// sums, times the scale, are added in fp32, in order, in dq in device
// memory: the first group's stored by TMA, each later one added by TMA's
// reduction in L2, each issued once every earlier one is complete (each
// block owns its query rows). tests/test_torch_flash_attention_f32_bwd.py
// emulates this arithmetic with truncating tensor cores and sets the
// float64 bound chip_smoke.py holds the kernel to.
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. At the fp32 training shape (B = 8, T = 2048, H = 12, D = 64,
// causal) the visible scores number B*H*T*(T+1)/2 = 201,424,896 and each
// of the three products (S, dP, dS . K) costs 2*D FLOPs a score, three
// tf32 products each: 232.0 GFLOP, 0.469 ms, against 1.154 ms for the
// same work on the 67 TFLOP/s FMA units (the SIMT kernel's route before)
// and 0.08 ms to move the inputs and the output once. At D = 128, B = 1,
// H = 6, T = 2048, non-causal (jit.load's shape in 6 heads): 58.0 GFLOP,
// 0.117 ms.
//
// Design (counted before the code: bytes of shared memory and registers a
// thread).
//   - Registers: dQ^T of 64 query rows over all of D takes D / 2
//     registers a thread of one warpgroup (64 at D = 128, 32 at 64): no
//     split of D and no trade of partial score tiles (head_dim 256's
//     kernel splits D and trades). So each of the block's two warpgroups
//     owns 64 query rows of its own (128 rows a block) and runs all of
//     its products over all of D; the two share each stage tile of K and
//     V. No producer warp: thread 0 issues every TMA load.
//   - Operands. tf32 wgmma reads only K-major operands and B from shared
//     memory, so dQ = dS . K runs transposed, dQ^T = K^T . dS^T: M = D
//     (D / 64 m64 blocks), N the warpgroup's 64 query rows, K the 16 keys
//     of a stage tile. A (K^T) is gathered into registers from the split
//     row-major K stage tile the scores read as B; B is the warpgroup's
//     split dS tile (64 rows x 16 keys, hi and lo side by side in 128-byte
//     rows: 8 KB), written row-major from the score fragments.
//   - Shared memory: Q and dO of the block's 128 rows resident and raw (2
//     x 64 KB at D = 128, 2 x 32 KB at 64), each warpgroup's 64 rows a
//     tile of D / 32 boxes, split per 32-column box into registers for
//     each stage tile (the scores' A); one stage of 16 keys of K and V
//     split in place into hi and lo (4 x 8 KB; 4 x 4 KB); the two split
//     dS tiles (2 x 8 KB); at D = 128 16 KB more, so that a flush stages
//     the block's dQ (64 KB) over the stage, the dS tiles and them. 197,648
//     bytes with alignment and barriers at D = 128, 99,344 at 64.
//   - Registers a thread: dQ^T 64 (D = 128) or 32; half a box's split Q
//     or dO fragments (16), the score chains (up to 64 at D = 128, 32 at
//     64) and the two score tiles (16) while the scores run; lse and
//     delta (4); K^T's hi and lo (32 at D = 128, 16 at 64) while dQ^T's
//     products are issued.
//   - Per stage tile (16 keys) and warpgroup: split its half of K's and
//     V's boxes; S and dP, D / 32 chains each (A = Q or dO box from
//     registers, B = K or V box hi and lo, wgmma m64n16k8: 12 a box); dS;
//     dS split; gather K^T; dQ^T (wgmma m64n64k8, 6 an m64 block). Thread
//     0 loads the next stage tile once both warpgroups have gathered,
//     while the products run.
//   - Flush, once a group: both warpgroups' dQ^T * scale staged side by
//     side from the stage on, once every product of the group is done,
//     each as D / 32 32-column boxes of 64 rows, stored or added by
//     thread 0 through TMA (a 64-row tile wholly past Tq is neither
//     loaded nor written); the next group's first stage tile is loaded
//     after it.
//   - Grid: one dimension, the (batch, head) pairs fastest and the last
//     query tiles first (the most key tiles under causal). At B = 8, T =
//     2048, H = 12: 16 x 12 x 8 = 1,536 blocks. Under causal a block runs
//     the key tiles its last row sees; its first warpgroup's tiles past
//     its own diagonal (up to 4) are masked whole and add exact zeros.
//   - TMA's rank-3 tensor maps (ops/flash_attention.py:tma_geometry) read
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

constexpr int BQ = WGS * RES;  // query rows of a block, 64 a warpgroup
constexpr int NK = NS;         // keys of a stage tile

// The sizes of head_dim DD.
template <int DD>
struct Shape {
  static constexpr int BOXES = DD / 32;       // 32-column boxes of a row
  static constexpr int MB = DD / 64;          // m64 blocks of dQ^T
  static constexpr int HALF = BOXES / WGS;    // stage boxes a warpgroup splits
  static constexpr int ST = BOXES * ST_BOX;   // a stage tile, hi or lo
  static constexpr int RT = BOXES * RES_BOX;  // a warpgroup's Q, dO or dQ
  // the stage and the dS tiles: where a flush stages dQ, with the bytes
  // that lack
  static constexpr int OVER = 4 * ST + WGS * X_T;
  static constexpr int EXTRA = WGS * RT > OVER ? WGS * RT - OVER : 0;
  static constexpr size_t SMEM =
      1024 + 2 * WGS * (size_t)RT + OVER + EXTRA + 8 * 2;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

struct Params {
  Geo q, k;            // q's serves dO and dq; k's serves v
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dq's sum of each group
  int causal;
};

template <int DD>
__global__ void __launch_bounds__(THREADS, 1)
    dq_f32_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v,
                       __grid_constant__ const CUtensorMap map_do,
                       __grid_constant__ const CUtensorMap map_dq,
                       const Params p) {
  using S = Shape<DD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  unsigned char* const gq = smem_raw + (q_s - raw);
  // Q, dO (resident, raw; warpgroup w's rows at w RT); the stage's K hi, K
  // lo, V hi, V lo; the dS tiles (split), one a warpgroup; the flush's
  // extra bytes; the barriers
  const uint32_t do_s = q_s + WGS * S::RT, k_s = do_s + WGS * S::RT;
  const uint32_t v_s = k_s + 2 * S::ST, x_s = v_s + 2 * S::ST;
  unsigned char* const gk = gq + (k_s - q_s);
  unsigned char* const gv = gq + (v_s - q_s);
  const uint32_t q_full = k_s + S::OVER + S::EXTRA, st_full = q_full + 8;

  const int pairs = p.heads * p.batch;
  const int last = (p.tq + BQ - 1) / BQ - 1;
  const int q0 = (last - static_cast<int>(blockIdx.x) / pairs) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + NK - 1) / NK : 0;
  // the block's 64-row tiles that hold a query row
  const int rtiles = min(WGS, (p.tq - q0 + RES - 1) / RES);
  const int tid = threadIdx.x;
  const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;
  const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;

  auto load = [&](int j) {  // key tile j's K and V
    mbar_expect_tx(st_full, 2 * S::ST);
    for (int cb = 0; cb < S::BOXES; ++cb) {
      tma_load_3d(k_s + cb * ST_BOX, &map_k, kc + 32 * cb, j * NK, ko,
                  st_full);
      tma_load_3d(v_s + cb * ST_BOX, &map_v, kc + 32 * cb, j * NK, ko,
                  st_full);
    }
  };
  if (tid == 0 && ntiles > 0) {  // no load is left in flight at the exit
    mbar_init(q_full, 1);
    mbar_init(st_full, 1);
    mbar_fence_init();
    mbar_expect_tx(q_full, 2 * rtiles * S::RT);
    for (int t = 0; t < rtiles; ++t)
      for (int cb = 0; cb < S::BOXES; ++cb) {
        const uint32_t at = t * S::RT + cb * RES_BOX;
        tma_load_3d(q_s + at, &map_q, qc + 32 * cb, q0 + RES * t, qo,
                    q_full);
        tma_load_3d(do_s + at, &map_do, qc + 32 * cb, q0 + RES * t, qo,
                    q_full);
      }
    load(0);
  }
  __syncthreads();

  // warpgroup wg: the rows [q0 + 64 wg, q0 + 64 wg + 64) over all of D;
  // warp-uniform in the compiler's eyes (a role read from tid alone makes
  // ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int w0 = q0 + RES * wg;                  // the warpgroup's first row
  const int r_in = w0 + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // keys 8 jj + c_in + {0, 1}
  auto masked = [&](int k0) {
    return k0 + NK > p.tk || (p.causal && k0 + NK - 1 > w0 + off);
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
  // the warpgroup's score operands (A resident, B the stage) and its dS
  const unsigned char* const res_q = gq + wg * S::RT;
  const unsigned char* const res_do = gq + (do_s - q_s) + wg * S::RT;
  unsigned char* const own_x = gq + (x_s - q_s) + wg * X_T;
  const uint32_t own_xs = x_s + wg * X_T;

  if (ntiles > 0) mbar_wait(q_full, 0);
  int j = 0;
  bool first = true;
  do {  // a group: the key tiles up to the next multiple of FLUSH
    const int group_end = min(ntiles, j + FLUSH - j % FLUSH);
    float acc[S::MB][32];  // dQ^T
    zero_acc(acc);
    for (; j < group_end; ++j) {
      const int k0 = j * NK;
      mbar_wait(st_full, j & 1);
      split_stage<S::HALF, S::ST>(gk, S::HALF * wg, wtid);
      split_stage<S::HALF, S::ST>(gv, S::HALF * wg, wtid);
      fence_proxy_async();
      bar_sync(1, THREADS);
      float s[8], dp[8];
      scores<S::BOXES, S::ST, 2>(s, dp, res_q, k_s, res_do, v_s, 0, warp,
                                 lane);
      dq_tile(s, dp, lse, dl, masked(k0), k0, r_in, c_in, p, off);
      // dS as B; the previous tile's products that read it were waited
      // for
      put_split(own_x, dp, warp, lane, 0, 2);
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      TFragT<S::MB> fk;  // K^T
      gather_t<S::MB, S::ST>(fk, gk, 0, warp, lane);
      fence_acc(acc);
      wgmma_fence();
      acc_wgmma(acc, fk, own_xs);
      wgmma_commit();
      // every thread has gathered: the stage is free for the next tile
      // (within the group: the flush stages its sums there)
      bar_sync(1, THREADS);
      if (tid == 0 && j + 1 < group_end) load(j + 1);
      wgmma_wait<0>();
      fence_acc(acc);
    }
    // the flush, once both warpgroups' products are done (warpgroup 1's
    // staging reaches warpgroup 0's dS tile): dQ^T * scale staged from
    // the stage on, warpgroup w's tile at w RT, stored or added by TMA
    bar_sync(1, THREADS);
    stage_out(acc, gk + wg * S::RT, p.scale, 0, warp, lane);
    fence_proxy_async();
    bar_sync(1, THREADS);
    if (tid == 0) {
      if (rtiles == WGS)
        flush_out<S::BOXES, WGS>(&map_dq, k_s, qc, q0, qo, first);
      else
        flush_out<S::BOXES, 1>(&map_dq, k_s, qc, q0, qo, first);
      if (j < ntiles) load(j);
    }
    bar_sync(1, THREADS);
    first = false;
  } while (j < ntiles);
  if (tid == 0) bulk_wait<0>();
}

template <int DD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int batch,
           int heads, int tq, int tk, const long long* q_geo,
           const long long* k_geo, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!make_map_3d(&mq, q, q_geo, tq, RES) ||
      !make_map_3d(&mk, k, k_geo, tk, NK) ||
      !make_map_3d(&mv, v, k_geo, tk, NK) ||
      !make_map_3d(&mdo, dout, q_geo, tq, RES) ||
      !make_map_3d(&mdq, dq, q_geo, tq, RES))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dq_f32_sm90_kernel<DD>, Shape<DD>::SMEM);
  if (err) return err;
  const int blocks = (tq + BQ - 1) / BQ * heads * batch;
  dq_f32_sm90_kernel<DD><<<blocks, THREADS, Shape<DD>::SMEM, stream>>>(
      mq, mk, mv, mdo, mdq, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query rows of a block, keys of a stage tile, stage tiles of a group.
int flash_attn_dq_f32_sm90_tile() { return BQ; }
int flash_attn_dq_f32_sm90_stage() { return NK; }
int flash_attn_dq_f32_sm90_flush() { return FLUSH; }

// fp32 q, k, v and dout at D = 64 or 128 (D contiguous), addressed through
// q_geo (q, dout, dq) and k_geo (k, v) as flash_attn_dq_sm90 takes them;
// lse and delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another D,
// or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map
// refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_dq_f32_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int batch, int heads,
                           int tq, int tk, int d, const long long* q_geo,
                           const long long* k_geo, float scale, int causal,
                           void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (d != 64 && d != 128) return -1;
  if (encoder() == nullptr) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q, k, v, dout, lse, delta, dq, batch, heads,
                              tq, tk, q_geo, k_geo, scale, causal, s)
                 : launch<128>(q, k, v, dout, lse, delta, dq, batch, heads,
                               tq, tk, q_geo, k_geo, scale, causal, s);
}

}  // extern "C"
