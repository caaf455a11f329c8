// Flash attention dq in fp32 at head_dim 256 on Hopper's tensor cores
// (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 256, the dq TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _bwd): _bwd_dq_kernel (BHTD) and _bwd_dq_kernel_bthd (BTHD). From the
// forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing a
// [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dq = scale * dS . K
// under the contract of flash_attention_dkv_f32_d256_sm90.cu: the causal
// mask is aligned bottom-right and applied before the exponential; P and
// dS are not rounded; every sum is fp32 and dq is scaled in fp32, each
// group's sum before it is added in; a query row past Tq or with lse
// -1e30 gets P = 0; keys past Tk are masked.
//
// Precision: split TF32, as dk/dv's kernel: the score sums over D one
// chain per 32-column box, ((c0 + c1) + (c2 + c3)) a warpgroup, then the
// warpgroups' partial sums; dS split for dS . K; dQ summed over a group of
// FLUSH key tiles (128 keys, counted from key 0) in an accumulator, the
// groups' sums, times the scale, stored or added in fp32, in order, in dq
// in device memory by TMA (each block owns its rows). P and dS come from S and dP as dk/dv's kernel computes
// them (one fmaf, natural exp), so the two kernels' dS agree wherever their
// score sums do. tests/test_torch_flash_attention_f32_bwd.py emulates this
// arithmetic.
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. At B = 8, T = 2048, H = 3, D = 256, causal: 50,356,224
// visible scores, three products (S, dP, dS . K) of 2*D FLOPs a score,
// three tf32 products each: 232.0 GFLOP, 0.469 ms (77.35 GFLOP on the 67
// TFLOP/s FMA units: 1.154 ms), against 0.05 ms to move the inputs and the
// output once.
//
// Design (flash_attention_dkv_f32_d256_sm90.cu's, query-major; counted
// before the code).
//   - Registers: dQ of 64 query rows at D = 256 takes 128 registers a
//     thread of one warpgroup; the block's two warpgroups share the rows
//     and warpgroup w owns the columns [128 w, 128 w + 128) of D: its half
//     of dQ (64 registers) and of the sums over D of S = Q . K^T and dP =
//     dO . V^T, traded through shared memory. No producer warp.
//   - Operands: dQ = dS . K sums over keys, so a row-major K tile cannot be
//     its B; it runs transposed, dQ^T = K^T . dS^T: M the warpgroup's 128
//     columns of D (two m64 blocks), N the 64 query rows, K the keys; A
//     (K^T) gathered into registers from the split K stage tile the
//     scores read as B, B the split dS tile (64 rows x 16 keys, hi and lo
//     side by side in 128-byte rows, 8 KB) written row-major from the score
//     fragments, each warpgroup half of its rows.
//   - Shared memory: Q and dO of the block's 64 rows resident and raw (64
//     KB each), split per 32-column box into registers for each key tile
//     (the scores' A); one stage of 16 keys of K and V split in place into
//     hi and lo (4 x 16 KB); dS split (8 KB); the traded partials (4 x 4
//     KB): 221,184 bytes + alignment and barriers, 222,224.
//   - Registers a thread: dQ^T 64; half a box's split Q or dO fragments
//     (16), the score chains (up to 40) and sums (16) while the scores
//     run; K^T's hi and lo (32) while dQ^T's products are issued.
//   - Per key tile (16 keys) and warpgroup: split its half of K and V; S
//     and dP, 4 chains each (wgmma m64n16k8, 96 a tile); trade; dS; dS
//     split; gather K^T; dQ^T (wgmma m64n64k8, 12 a tile). Thread 0 loads
//     the next key tile once both warpgroups have gathered.
//   - Flush, once a group: dQ^T * scale staged in the stage's 64 KB as
//     dq's eight 32-column boxes of 64 rows, stored or added through TMA
//     by thread 0, as dk/dv's kernel flushes.
//   - Grid: one dimension, the (batch, head) pairs fastest and the last
//     query tiles first (the most key tiles under causal). At B = 8, T =
//     2048, H = 3: 32 x 3 x 8 = 768 blocks, one an SM.
//
// Plain C interface, loaded with ctypes; helpers from flash_f32_bwd.cuh.

#include <math.h>

#include "flash_f32_bwd.cuh"

namespace {

using namespace f32bwd;
using d256::geo_of;

constexpr int BQ = RES;  // query rows of a block
constexpr int NK = NS;   // keys of a stage tile
constexpr size_t SMEM = 1024 + 2 * (size_t)RES_T + 4 * (size_t)ST_T + X_T +
                        4 * PART * 4 + 8 * 2;
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

struct Params {
  Geo q, k;            // q's serves dO and dq; k's serves v
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  float* dq;
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dq once, at the end
  int causal;
};

__global__ void __launch_bounds__(THREADS, 1)
    dq_f32_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                            __grid_constant__ const CUtensorMap map_k,
                            __grid_constant__ const CUtensorMap map_v,
                            __grid_constant__ const CUtensorMap map_do,
                            __grid_constant__ const CUtensorMap map_dq,
                            const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  unsigned char* const gq = smem_raw + (q_s - raw);
  // Q, dO (resident, raw); the stage's K hi, K lo, V hi, V lo; dS (split);
  // the traded partials; the barriers
  const uint32_t do_s = q_s + RES_T, k_s = do_s + RES_T, v_s = k_s + 2 * ST_T;
  const uint32_t x_s = v_s + 2 * ST_T, part_s = x_s + X_T;
  unsigned char* const gdo = gq + RES_T;
  unsigned char* const gk = gq + (k_s - q_s);
  unsigned char* const gv = gq + (v_s - q_s);
  unsigned char* const gx = gq + (x_s - q_s);
  float* const part = reinterpret_cast<float*>(gq + (part_s - q_s));
  const uint32_t q_full = part_s + 4 * PART * 4, st_full = q_full + 8;

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
  const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;

  auto load = [&](int j) {  // key tile j's K and V
    mbar_expect_tx(st_full, 2 * ST_T);
    for (int cb = 0; cb < BOXES; ++cb) {
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
    mbar_expect_tx(q_full, 2 * RES_T);
    for (int cb = 0; cb < BOXES; ++cb) {
      tma_load_3d(q_s + cb * RES_BOX, &map_q, qc + 32 * cb, q0, qo, q_full);
      tma_load_3d(do_s + cb * RES_BOX, &map_do, qc + 32 * cb, q0, qo,
                  q_full);
    }
    load(0);
  }
  __syncthreads();

  // warpgroup wg: columns [128 wg, 128 wg + 128) of D for the rows [q0,
  // q0 + 64); warp-uniform in the compiler's eyes
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int r_in = q0 + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // keys 8 jj + c_in + {0, 1}
  const int box0 = OWN * wg;        // the warpgroup's first box
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
  auto slot = [&](int w, int prod) { return part + (w * 2 + prod) * PART; };

  if (ntiles > 0) mbar_wait(q_full, 0);
  int j = 0;
  bool first = true;
  do {  // a group: the key tiles up to the next multiple of FLUSH
    const int group_end = min(ntiles, j + FLUSH - j % FLUSH);
    float dq[2][32];
    zero_acc(dq);
    for (; j < group_end; ++j) {
      const int k0 = j * NK;
      mbar_wait(st_full, j & 1);
      split_stage(gk, box0, wtid);
      split_stage(gv, box0, wtid);
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      float s[8], dp[8];
      scores(s, dp, gq, k_s, gdo, v_s, box0, warp, lane);
      put(slot(wg, 0), wtid, s);
      put(slot(wg, 1), wtid, dp);
      bar_sync(1, THREADS);
      add_from(slot(1 - wg, 0), wtid, s);
      add_from(slot(1 - wg, 1), wtid, dp);
      dq_tile(s, dp, lse, dl, masked(k0), k0, r_in, c_in, p, off);
      // dS as B, each warpgroup its rows r_in + 8 wg; the previous tile's
      // products that read it were waited for before the trade
      put_split(gx, dp, warp, lane, wg, wg + 1);
      fence_proxy_async();
      bar_sync(1, THREADS);
      TFrag fk;  // K^T
      gather_t(fk, gk, wg, warp, lane);
      fence_acc(dq);
      wgmma_fence();
      acc_wgmma(dq, fk, x_s);
      wgmma_commit();
      // every thread has gathered: the stage is free for the next tile
      // (within the group: the flush stages its sums there)
      bar_sync(1, THREADS);
      if (tid == 0 && j + 1 < group_end) load(j + 1);
      wgmma_wait<0>();
      fence_acc(dq);
    }
    // the flush: dQ * scale staged in the stage's 64 KB (nobody reads it
    // after the last tile's barrier), stored or added by TMA
    stage_out(dq, gk, p.scale, wg, warp, lane);
    fence_proxy_async();
    bar_sync(1, THREADS);
    if (tid == 0) {
      flush_out(&map_dq, k_s, qc, q0, qo, first);
      if (j < ntiles) load(j);
    }
    bar_sync(1, THREADS);
    first = false;
  } while (j < ntiles);
  if (tid == 0) bulk_wait<0>();
}

}  // namespace

extern "C" {

// Query rows of a block, keys of a stage tile, stage tiles of a group.
int flash_attn_dq_f32_d256_sm90_tile() { return BQ; }
int flash_attn_dq_f32_d256_sm90_stage() { return NK; }
int flash_attn_dq_f32_d256_sm90_flush() { return FLUSH; }

// fp32 q, k, v and dout at D = 256 (D contiguous), addressed through q_geo
// (q, dout, dq) and k_geo (k, v) as flash_attn_dq_d256_sm90 takes them; lse
// and delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another D, or an
// empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map refused: a
// pointer or a stride not a multiple of 16 bytes).
int flash_attn_dq_f32_d256_sm90(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int batch,
                                int heads, int tq, int tk, int d,
                                const long long* q_geo,
                                const long long* k_geo, float scale,
                                int causal, void* stream) {
  if (d != D || batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!make_map_3d(&mq, q, q_geo, tq, BQ) ||
      !make_map_3d(&mk, k, k_geo, tk, NK) ||
      !make_map_3d(&mv, v, k_geo, tk, NK) ||
      !make_map_3d(&mdo, dout, q_geo, tq, BQ) ||
      !make_map_3d(&mdq, dq, q_geo, tq, BQ))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dq_f32_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tq + BQ - 1) / BQ * heads * batch;
  dq_f32_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, mdq, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
