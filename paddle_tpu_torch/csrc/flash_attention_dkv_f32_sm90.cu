// Flash attention dk and dv in fp32 at head_dim 64 and 128 on Hopper's
// tensor cores (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 64 and 128, the dk/dv TPU kernels
// of paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call
// by _bwd): _bwd_dkv_kernel (BHTD) and _bwd_dkv_kernel_bthd (BTHD). From
// the forward's lse and delta[r] = rowsum(dO[r] * out[r]), without writing
// a [Tq, Tk] tile to device memory:
//     P  = exp(s * scale - lse)    dP = dO . V^T    dS = P * (dP - delta)
//     dk = scale * dS^T . Q        dv = P^T . dO
// under the contract of ops/flash_attention.py's rounding rule, as
// flash_attention_dkv_f32_d256_sm90.cu meets it: the causal
// mask is aligned bottom-right (key c visible from row r iff c <= r + Tk -
// Tq) and applied before the exponential; P and dS are not rounded (the
// plain fp32 version rounds nothing); every sum is fp32 and dk is scaled
// in fp32, each group's sum before it is added in (below). A query row
// that takes no part (past Tq, or with lse -1e30: it sees no key) gets P
// = 0: its lse is replaced by +1e30 before the exponential.
//
// Precision: split TF32, as the head_dim-256 kernel: each operand a = hi +
// lo with hi = tf32_rna(a) and lo = tf32_rna(a - hi), each product lo_a .
// hi_b + hi_a . lo_b + hi_a . hi_b, three tf32 wgmma per 8-deep slice into
// one fp32 accumulator. Each 32-column box of D is a score chain of its
// own (12 products), the chains added in fp32: c0 + c1 at D = 64, ((c0 +
// c1) + (c2 + c3)) at 128. P and dS are split the same way for the second
// products. dK and dV sum over the query rows in the tensor cores'
// accumulators, whose fp32 sums need not round to nearest: a group of
// FLUSH stage tiles (128 query rows, counted from row 0) is summed in an
// accumulator, and the groups' sums are added in fp32, in order, in dk and
// dv in device memory: the first group's stored by TMA, each later one
// added by TMA's reduction in L2, each issued once every earlier one is
// complete (each block owns its keys: no other block adds to them, and the
// order is fixed). tests/test_torch_flash_attention_f32_bwd.py emulates
// this arithmetic with truncating tensor cores and sets the float64 bound
// chip_smoke.py holds the kernel to.
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. At the fp32 training shape (B = 8, T = 2048, H = 12, D = 64,
// causal) the visible scores number B*H*T*(T+1)/2 = 201,424,896 and each
// of the four products (S^T, dP^T, dV, dK) costs 2*D FLOPs a score, three
// tf32 products each: 309.4 GFLOP, 0.625 ms, against 1.539 ms for the same
// work on the 67 TFLOP/s FMA units (the SIMT kernel's route) and 0.09 ms
// to move the inputs and outputs once. At D = 128, B = 1, H = 6, T = 2048,
// non-causal (jit.load's shape in 6 heads): 77.3 GFLOP, 0.156 ms.
//
// Design (counted before the code: bytes of shared memory and registers a
// thread).
//   - Registers: dK^T and dV^T of 64 keys over all of D take D / 2 + D /
//     2 registers a thread of one warpgroup (128 at D = 128, 64 at 64).
//     With the scores' chains and the gathered operands that left no room
//     at D = 128 (255 registers and spills, when each warpgroup held both
//     for keys of its own). So the block's two warpgroups share its 64 keys
//     and split the work by role: warpgroup 0 runs S^T = K . Q^T, P and dV^T
//     = dO^T . P, warpgroup 1 dP^T = V . dO^T, dS = P * (dP - delta) and
//     dK^T = Q^T . dS, each with one accumulator of D / 2 registers. P
//     goes from warpgroup 0 to 1 through shared memory (4 KB). No score
//     tile is traded (the head_dim-256 kernel splits D, and trades partial
//     S and dP), and no exponential is taken twice. No producer warp:
//     thread 0 issues every TMA load.
//   - Operands. tf32 wgmma reads only K-major operands, and B comes from
//     shared memory, so the products over query rows run transposed: M = D
//     (D / 64 m64 blocks), N the 64 keys, K the 16 query rows of a stage
//     tile. A (dO^T, Q^T) is gathered into registers from the split
//     row-major stage tile; B is the small split P^T or dS^T tile (64 keys
//     x 16 query rows, hi and lo side by side in 128-byte rows: 8 KB),
//     written key-major from the score fragments.
//   - Shared memory: K and V of the block's 64 keys resident and raw (2 x
//     32 KB at D = 128, 2 x 16 KB at 64), split per 32-column box into
//     registers for each stage tile (the scores' A), as the head_dim-256
//     kernel splits them. One stage of 16 query rows of Q and dO, each
//     split in place into hi and lo (4 x 8 KB; 4 x 4 KB); the split P^T
//     and dS^T (2 x 8 KB); P (4 KB); at D = 128 12 KB more, so that a
//     flush stages dK and dV side by side over all of it. 132,112 bytes
//     with alignment and barriers at D = 128, 70,672 at 64.
//   - Registers a thread: the accumulator, 64 (D = 128) or 32; half a
//     box's split K or V fragments (16), the score chains in flight or
//     held (up to 24) and the tile's 8 values; lse and delta (8) after
//     them; the gathered dO^T or Q^T hi and lo (32 at D = 128, 16 at 64)
//     while the accumulating product is issued.
//   - Per stage tile (16 query rows): both warpgroups split the stage
//     (half of its boxes each); warpgroup 0 runs S^T, warpgroup 1 dP^T, D
//     / 32 chains each (A = K or V box from registers, B = Q or dO box hi
//     and lo, wgmma m64n16k8: 12 a box), at once; warpgroup 0 takes P
//     (natural exp of s * scale - lse, as the bf16 kernels) and writes it
//     raw and P^T split; warpgroup 1 reads it, takes dS and writes dS^T
//     split; each gathers its A (dO^T, Q^T) and issues its product
//     (wgmma m64n64k8, 6 an m64 block). Thread 0 loads the next stage tile
//     once both warpgroups have gathered, while the products run.
//   - Flush, once a group: dV^T and dK^T * scale staged side by side over
//     the stage, the P^T, dS^T and P tiles (and the 12 KB) once every
//     product of the group is done, each as D / 32 32-column boxes of 64
//     keys, stored or added by thread 0 through TMA (rows past Tk are not
//     written); the next group's first stage tile is loaded after it.
//   - Grid: one dimension, the (batch, head) pairs fastest and the lowest
//     key tiles first (the most query tiles under causal). At B = 8, T =
//     2048, H = 12: 32 x 12 x 8 = 3,072 blocks.
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

// The sizes of head_dim DD.
template <int DD>
struct Shape {
  static constexpr int BOXES = DD / 32;       // 32-column boxes of a row
  static constexpr int MB = DD / 64;          // m64 blocks of dK^T, dV^T
  static constexpr int ST = BOXES * ST_BOX;   // a stage tile, hi or lo
  static constexpr int RT = BOXES * RES_BOX;  // K, V, or a flush's dK or dV
  static constexpr int P_T = PART * 4;        // P, raw
  // the stage, P^T, dS^T and P: where a flush stages dK and dV, with the
  // bytes that lack
  static constexpr int OVER = 4 * ST + 2 * X_T + P_T;
  static constexpr int EXTRA = 2 * RT > OVER ? 2 * RT - OVER : 0;
  static constexpr size_t SMEM = 1024 + 2 * (size_t)RT + OVER + EXTRA + 8 * 2;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

struct Params {
  Geo q, k;            // q's serves dO; k's serves v, dk and dv
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  int heads, batch, tq, tk;
  float scale;  // of the scores, and of dk's sum of each group
  int causal;
};

template <int DD>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_f32_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                        __grid_constant__ const CUtensorMap map_k,
                        __grid_constant__ const CUtensorMap map_v,
                        __grid_constant__ const CUtensorMap map_do,
                        __grid_constant__ const CUtensorMap map_dk,
                        __grid_constant__ const CUtensorMap map_dv,
                        const Params p) {
  using S = Shape<DD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  unsigned char* const gk = smem_raw + (k_s - raw);
  // K, V (resident, raw); the stage's Q hi, Q lo, dO hi, dO lo; P^T, dS^T
  // (split); P (raw); the flush's extra bytes; the barriers
  const uint32_t v_s = k_s + S::RT, q_s = v_s + S::RT;
  const uint32_t do_s = q_s + 2 * S::ST, x_s = do_s + 2 * S::ST;
  unsigned char* const gq = gk + (q_s - k_s);
  unsigned char* const gdo = gk + (do_s - k_s);
  unsigned char* const gx = gk + (x_s - k_s);
  float* const pt = reinterpret_cast<float*>(gx + 2 * X_T);
  const uint32_t kv_full = q_s + S::OVER + S::EXTRA, st_full = kv_full + 8;

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
    mbar_expect_tx(st_full, 2 * S::ST);
    for (int cb = 0; cb < S::BOXES; ++cb) {
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
    mbar_expect_tx(kv_full, 2 * S::RT);
    for (int cb = 0; cb < S::BOXES; ++cb) {
      tma_load_3d(k_s + cb * RES_BOX, &map_k, kc + 32 * cb, c0, ko, kv_full);
      tma_load_3d(v_s + cb * RES_BOX, &map_v, kc + 32 * cb, c0, ko, kv_full);
    }
    load(0);
  }
  __syncthreads();

  // warpgroup wg: 0 runs S^T, P and dV^T, 1 dP^T, dS and dK^T, for the
  // keys [c0, c0 + 64) over all of D; warp-uniform in the compiler's eyes
  // (a role read from tid alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int kr = c0 + 16 * warp + (lane >> 2);  // and kr + 8
  const int c_in = 2 * (lane & 3);  // queries 8 jj + c_in + {0, 1}
  auto masked = [&](int q0) { return p.causal && c0 + KEYS - 1 > q0 + off; };
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  // the warpgroup's score operands (A resident, B the stage), the stage
  // tile its product's A is gathered from, and its B (P^T or dS^T)
  const unsigned char* const res = wg == 0 ? gk : gk + S::RT;
  const uint32_t sc_b = wg == 0 ? q_s : do_s;
  const unsigned char* const gat = wg == 0 ? gdo : gq;
  unsigned char* const own_x = gx + wg * X_T;
  const uint32_t own_xs = x_s + wg * X_T;
  constexpr int HALF = S::BOXES / WGS;  // stage boxes a warpgroup splits

  if (ntiles > 0) mbar_wait(kv_full, 0);
  int j = 0;
  bool first = true;
  do {  // a group: the stage tiles up to the next multiple of FLUSH
    const int group_end =
        min(ntiles, j + FLUSH - (begin / NQ + j) % FLUSH);
    float acc[S::MB][32];  // dV^T (warpgroup 0) or dK^T (1)
    zero_acc(acc);
    for (; j < group_end; ++j) {
      const int q0 = begin + j * NQ;
      mbar_wait(st_full, j & 1);
      split_stage<HALF, S::ST>(gq, HALF * wg, wtid);
      split_stage<HALF, S::ST>(gdo, HALF * wg, wtid);
      fence_proxy_async();
      bar_sync(1, THREADS);
      float x[8];  // S^T (warpgroup 0) or dP^T (1)
      scores<S::BOXES, S::ST, 1>(x, x, res, sc_b, res, sc_b, 0, warp, lane);
      float lse[4], dl[4];
      row_stats(p, row0, q0, c_in, lse, dl);
      // P, raw for warpgroup 1 and split as warpgroup 0's B; the products
      // of the previous tile that read them were waited for, and P read,
      // before the stage's barrier
      if (wg == 0) {
        probs_tile(x, lse, masked(q0), q0, kr, c_in, off, p.scale);
        put(pt, wtid, x);
        put_split(own_x, x, warp, lane, 0, 2);
        fence_proxy_async();
      }
      bar_sync(1, THREADS);
      if (wg == 1) {  // dS^T as warpgroup 1's B
        float pr[8];
        take(pt, wtid, pr);
        ds_tile(x, pr, dl);
        put_split(own_x, x, warp, lane, 0, 2);
        fence_proxy_async();
        bar_sync(3, 128);
      }
      TFragT<S::MB> f;  // dO^T (warpgroup 0) or Q^T (1)
      gather_t<S::MB, S::ST>(f, gat, 0, warp, lane);
      fence_acc(acc);
      wgmma_fence();
      acc_wgmma(acc, f, own_xs);
      wgmma_commit();
      // every thread has gathered and P is read: the stage is free for the
      // next tile (within the group: the flush stages its sums there)
      bar_sync(1, THREADS);
      if (tid == 0 && j + 1 < group_end) load(j + 1);
      wgmma_wait<0>();
      fence_acc(acc);
    }
    // the flush, once both warpgroups' products are done (a warpgroup's
    // staging reaches the other's tiles): dV^T at the stage, dK^T * scale
    // after it, stored or added by TMA
    bar_sync(1, THREADS);
    stage_out(acc, gq + wg * S::RT, wg == 0 ? 1.f : p.scale, 0, warp, lane);
    fence_proxy_async();
    bar_sync(1, THREADS);
    if (tid == 0) {
      flush_out<S::BOXES>(&map_dv, q_s, kc, c0, ko, first);
      flush_out<S::BOXES>(&map_dk, q_s + S::RT, kc, c0, ko, first);
      if (j < ntiles) load(j);
    }
    bar_sync(1, THREADS);
    first = false;
  } while (j < ntiles);
  if (tid == 0) bulk_wait<0>();
}

template <int DD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int batch,
           int heads, int tq, int tk, const long long* q_geo,
           const long long* k_geo, float scale, int causal,
           cudaStream_t stream) {
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
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  const int err = allow_smem(dkv_f32_sm90_kernel<DD>, Shape<DD>::SMEM);
  if (err) return err;
  const int blocks = (tk + KEYS - 1) / KEYS * heads * batch;
  dkv_f32_sm90_kernel<DD><<<blocks, THREADS, Shape<DD>::SMEM, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Keys of a block, query rows of a stage tile, stage tiles of a group.
int flash_attn_dkv_f32_sm90_tile() { return KEYS; }
int flash_attn_dkv_f32_sm90_stage() { return NQ; }
int flash_attn_dkv_f32_sm90_flush() { return FLUSH; }

// fp32 q, k, v and dout at D = 64 or 128 (D contiguous), addressed through
// q_geo (q, dout) and k_geo (k, v, dk, dv) as flash_attn_dkv_sm90 takes
// them; lse and delta [B, H, Tq] fp32. Returns a CUDA error, or -1 (another
// D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map
// refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_dkv_f32_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int batch,
                            int heads, int tq, int tk, int d,
                            const long long* q_geo, const long long* k_geo,
                            float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (d != 64 && d != 128) return -1;
  if (encoder() == nullptr) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(q, k, v, dout, lse, delta, dk, dv, batch,
                              heads, tq, tk, q_geo, k_geo, scale, causal, s)
                 : launch<128>(q, k, v, dout, lse, delta, dk, dv, batch,
                               heads, tq, tk, q_geo, k_geo, scale, causal,
                               s);
}

}  // extern "C"
