// Flash attention forward in fp32 at head_dim 256 on Hopper's tensor cores
// (sm_90a) through split TF32 (3xTF32): wgmma fed by TMA.
//
// Replaces, for fp32 inputs at head_dim 256, the forward TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _fwd): _fwd_kernel (BHTD) and _fwd_kernel_bthd (BTHD). For each query
// row r, without writing the [Tq, Tk] scores to device memory:
//     s[r, c] = (q[r] . k[c]) * scale          (fp32 products and sums)
//     lse[r]  = logsumexp over the visible c of s[r, c]
//     out[r]  = sum_c softmax(s[r])[c] * v[c]
// under the contract of flash_attention_fwd_f32_sm90.cu (head_dim 64 and
// 128): the causal mask is aligned bottom-right (key c visible from row r
// iff c <= r + Tk - Tq); masked scores take no part (the online softmax
// starts from -1e30); a row that sees no key gives out 0 and lse -1e30;
// the scale multiplies the fp32 scores; fp32 P is not rounded, and the row
// sum takes it as it is; lse is (B, H, Tq). A model with head_dim 256
// exported in fp32 (jit.save, then jit.load) runs it once a layer.
//
// Precision: split TF32, as the D = 64/128 kernel: each operand a = hi +
// lo with hi = tf32_rna(a) and lo = tf32_rna(a - hi), each product
//     lo_a . hi_b + hi_a . lo_b + hi_a . hi_b
// three tf32 wgmma per 8-deep slice, issued in that order into one fp32
// accumulator. A score sums 96 tf32 products over D = 256 (48 at D =
// 128), so no accumulator of the tensor cores (whose fp32 sums need not
// round to nearest) takes them all: each 32-column box of D is a chain of
// its own (4 slices, 12 products), and the chains are added in fp32,
// ((c0 + c1) + (c2 + c3)) over a warpgroup's 128 columns, then the two
// warpgroups' partial sums (fp32 addition commutes, so both hold the same
// score). P . V sums one key tile (4 slices of 8 keys, 12 products) in a
// new accumulator, added to the running output in one fused multiply-add,
// o = o * alpha + (P . V). tests/test_torch_flash_attention_f32.py
// emulates this arithmetic with truncating tensor cores and sets the
// float64 bound chip_smoke.py holds the kernel to.
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. The two products cost 2*D FLOPs per visible score each,
// three tf32 products of each 12*D. At the export path's shape (B = 1, T =
// 2048, H = 3, D = 256, non-causal) that is 38.65 GFLOP, 0.0781 ms, against
// 0.0075 ms to move q, k, v, out and lse once and 0.1923 ms for 4*D FLOPs
// a score on the 67 TFLOP/s of the FMA units; at the training shape (B =
// 8, T = 2048, H = 3, causal) 154.7 GFLOP, 0.3127 ms (FMA 0.7696).
//
// Design. Neither the D = 64/128 fp32 kernel's layout nor the bf16 D = 256
// forward's fits: a 64 x 256 fp32 output takes 128 registers a thread of a
// warpgroup, and the per-tile accumulator of P . V as many again; Q's hi
// and lo of 64 rows take 128 KB of shared memory, and one 32-key stage of
// K, V, K lo, V^T hi and V^T lo 160 KB, of the 227 KB a block may use.
//   - Split D within the block: two warpgroups (256 threads, up to 255
//     registers) on the same 64 query rows, warpgroup w owning columns
//     [128 w, 128 w + 128) of D: its half of the output (64 registers)
//     and of the tile's P . V (64), its half of the score sums. The
//     partial 64 x 32 score tiles are traded through shared memory, as in
//     flash_attention_dq_d256_sm90.cu, and both warpgroups run the same
//     softmax on the same scores. No producer warp (ptxas would hold the
//     block to 168 registers a thread): thread 0 issues every TMA load.
//   - Q raw, split per tile in registers: the Q tile stays as TMA wrote it
//     (64 KB, eight 32-column boxes); for each box a warpgroup owns it
//     reads the A fragments of Q from shared memory, splits them into hi
//     and lo in registers (32 registers a box) and issues the box's 12
//     wgmma m64n32k8 with K as B (register A): two boxes' worth at a
//     time. This keeps 96 KB of shared memory free, and a register A
//     reads a quarter of the shared-memory bytes that three passes of a
//     shared-memory A of hi and lo would.
//   - One stage of 32 keys (160 KB: K, split in place into K hi, K lo, raw
//     V, V^T hi, V^T lo). Each warpgroup splits the columns it owns, K as
//     soon as it lands, V while its first two boxes' score products run,
//     V into a transposed V^T (keys contiguous for each column of D: tf32
//     wgmma reads K-major operands only) in the D = 64/128 kernel's
//     permuted key order (within each 8-key group key 2t at t, 2t + 1 at
//     t + 4: what P's fragments hand the tensor cores). The raw V is free
//     once split, K once every score product has run: thread 0 loads tile
//     j + 1's K and V at the trade of tile j, and they land while tile
//     j's softmax and P . V run. A warpgroup's partial score tile goes
//     into its own half of K lo, which its score products no longer read;
//     a 256-thread barrier at the top of the next tile keeps it there
//     until the other warpgroup has read it.
//   - Scores: per box, wgmma m64n32k8 from registers (Q) and shared memory
//     (K hi, K lo), lo . hi, hi . lo, hi . hi per slice.
//   - Online softmax in registers (flash_f32.cuh, the D = 64/128
//     kernel's): exp2f on scores prescaled by scale * log2(e), the row
//     max and sum over a thread's values then its quad.
//   - P . V: P split in registers as wgmma's A (m64n128k8), V^T hi and lo
//     of the warpgroup's 128 columns as B; then o = o * alpha + ot.
//   - No software pipeline: a tile's scores, softmax and P . V run in turn;
//     the warpgroups meet at the trade once a tile.
//   - Grid: one dimension, the (batch, head) pairs fastest and the query
//     tiles from the last, so the long causal rows of every pair start
//     first. At B = 8, T = 2048, H = 3: 32 x 3 x 8 = 768 blocks, one an SM.
//   - Causal work: key tiles wholly above the diagonal are not loaded;
//     only tiles that cross it or the ragged edge are masked. TMA's rank-3
//     tensor maps (ops/flash_attention.py:tma_geometry) read both layouts
//     without a copy, and a box past a sequence's end reads zeros.
//   - Output: fp32 stores at the layout's strides, each warpgroup its
//     columns; lse (B, H, Tq) from warpgroup 0.
// Shared memory: 64 KB of Q and 160 KB of the stage, 230,424 bytes. One
// block per SM.
//
// Plain C interface, loaded with ctypes; the split-TF32 helpers from
// flash_f32.cuh, the trade and addressing from flash_d256.cuh, barrier,
// TMA and wgmma helpers from sm90.cuh.

#include <math.h>

#include "flash_d256.cuh"
#include "flash_f32.cuh"

namespace {

using namespace flash_f32;
using d256::add_from;
using d256::bar_sync;
using d256::Geo;
using d256::geo_of;
using d256::put;

constexpr int D = d256::D;
constexpr int WGS = d256::WGS;          // warpgroups, 128 columns of D each
constexpr int THREADS = d256::THREADS;
constexpr int BQ = 64;                  // query rows of a block
constexpr int BKV = d256::NT;           // keys of a tile (32)
constexpr int NJ = BKV / 8;             // 8-key slices of a tile
constexpr int KD = 4;                   // 8-deep slices of a 32-column box
constexpr int BOXES = D / 32;           // 32-column boxes of a row
constexpr int OWN = BOXES / WGS;        // boxes a warpgroup owns
constexpr int Q_BOX = BQ * 128;         // 64 rows x 32 fp32
constexpr int KV_BOX = BKV * 128;       // 32 keys x 32 fp32
constexpr int QT = BOXES * Q_BOX;       // the raw Q tile: 64 KB
constexpr int KVT = BOXES * KV_BOX;     // K, K lo, V, V^T hi or V^T lo
constexpr float NEG = d256::NEG;        // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM = 1024 + QT + 5 * (size_t)KVT + 8 * 3;
static_assert(SMEM <= SMEM_LIMIT, "shared memory");
static_assert(d256::PART * 4 <= KVT / WGS, "a partial in half of K lo");

struct Params {
  Geo q, k;
  float* out;  // q's layout and strides
  float* lse;  // [B, H, Tq]
  int heads, batch, tq, tk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// One 32-column box of Q split as wgmma's A: slice kd in [kd][0 .. 3],
// the fragment's (row r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4)
// of the box's columns 8 kd ..
struct QFrag {
  uint32_t hi[KD][4], lo[KD][4];
};

// The warpgroup thread (warp, lane)'s fragments of raw Q box `box` (64
// rows of 128 bytes, TMA's swizzle), split.
__device__ __forceinline__ void q_frags(QFrag& f, const unsigned char* box,
                                        int warp, int lane) {
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = 16 * warp + (lane >> 2) + 8 * (x & 1);
      const int col = 8 * kd + (lane & 3) + 4 * (x >> 1);
      const float a = *reinterpret_cast<const float*>(box + swz(row, col));
      const float h = tf32_rna(a);
      f.hi[kd][x] = __float_as_uint(h);
      f.lo[kd][x] = __float_as_uint(tf32_rna(a - h));
    }
}

__device__ __forceinline__ void fence_q(QFrag& f) {
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    fence_a(f.hi[kd]);
    fence_a(f.lo[kd]);
  }
}

// c = q k^T over one 32-column box, a new chain, issued (not waited for):
// kh the box of K hi, K lo one tile further; per slice lo . hi, hi . lo,
// hi . hi.
__device__ __forceinline__ void qk_box(float (&c)[BKV / 2], const QFrag& f,
                                       uint32_t kh) {
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const uint64_t dh = desc(kh + 32 * kd), dl = desc(kh + KVT + 32 * kd);
    const uint32_t* h = f.hi[kd];
    const uint32_t* l = f.lo[kd];
    wgmma_n32_tf32_rs(c, l[0], l[1], l[2], l[3], dh, kd != 0);
    wgmma_n32_tf32_rs(c, h[0], h[1], h[2], h[3], dl, 1);
    wgmma_n32_tf32_rs(c, h[0], h[1], h[2], h[3], dh, 1);
  }
}

// ot = P . v of one key tile over the warpgroup's 128 columns, new,
// issued: ph, pl P's hi and lo as A (4 registers per 8-key slice), vt the
// warpgroup's first row of V^T hi (V^T lo one tile further); per slice
// lo . hi, hi . lo, hi . hi.
__device__ __forceinline__ void pv_wgmma(float (&ot)[64],
                                         const uint32_t (&ph)[4 * NJ],
                                         const uint32_t (&pl)[4 * NJ],
                                         uint32_t vt) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const uint64_t dh = desc(vt + 32 * jj), dl = desc(vt + KVT + 32 * jj);
    const uint32_t* h = ph + 4 * jj;
    const uint32_t* l = pl + 4 * jj;
    wgmma_n128_tf32_rs(ot, l[0], l[1], l[2], l[3], dh, jj != 0);
    wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dl, 1);
    wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dh, 1);
  }
}

// The warpgroup's K boxes (16 KB from k) split by its thread t: hi in
// place, lo at the same offset of K lo.
__device__ __forceinline__ void split_k(unsigned char* k, int t) {
#pragma unroll
  for (int i = 0; i < OWN * KV_BOX / 16 / 128; ++i) {
    const int f = t + 128 * i;
    split4(k + 16 * f, k + KVT + 16 * f);
  }
}

// The warpgroup's columns [n_first, n_first + 128) of the raw V tile at v
// split by its thread t into V^T hi and lo (D rows of BKV keys, one box of
// 128-byte rows; V^T hi one tile after v): a warp reads 32 keys of 4
// columns and writes, for each column, 32 keys of one 128-byte row.
__device__ __forceinline__ void split_v(unsigned char* v, int n_first,
                                        int t) {
  unsigned char* const vh = v + KVT;
#pragma unroll
  for (int i = 0; i < OWN * KV_BOX / 16 / 128; ++i) {
    const int f = t + 128 * i;
    const int key = f % BKV, n0 = n_first + 4 * (f / BKV);
    const float4 a = *reinterpret_cast<const float4*>(
        v + (n0 >> 5) * KV_BOX + swz(key, n0 & 31));
    const int kt = vt_key(key);
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t o = swz(n0 + u, kt);
      const float h = tf32_rna(e[u]);
      *reinterpret_cast<float*>(vh + o) = h;
      *reinterpret_cast<float*>(vh + KVT + o) = tf32_rna(e[u] - h);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_f32_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                             __grid_constant__ const CUtensorMap map_k,
                             __grid_constant__ const CUtensorMap map_v,
                             const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  unsigned char* const gq = smem_raw + (q_s - raw);
  // K (split in place into K hi), K lo, raw V, V^T hi, V^T lo
  const uint32_t k_s = q_s + QT, v_s = k_s + 2 * KVT;
  unsigned char* const gk = gq + QT;
  unsigned char* const gv = gk + 2 * KVT;
  const uint32_t bar_s = v_s + 3 * KVT;
  const uint32_t q_full = bar_s, k_full = bar_s + 8, v_full = bar_s + 16;

  const int pairs = p.heads * p.batch;
  const int last = (p.tq + BQ - 1) / BQ - 1;
  const int q0 = (last - static_cast<int>(blockIdx.x) / pairs) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % pairs;
  const int b = bh / p.heads, h = bh % p.heads;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + BKV - 1) / BKV : 0;
  const int tid = threadIdx.x;
  const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;

  auto load = [&](int j) {  // key tile j's K and V
    mbar_expect_tx(k_full, KVT);
    mbar_expect_tx(v_full, KVT);
    for (int cb = 0; cb < BOXES; ++cb) {
      tma_load_3d(k_s + cb * KV_BOX, &map_k, kc + 32 * cb, j * BKV, ko,
                  k_full);
      tma_load_3d(v_s + cb * KV_BOX, &map_v, kc + 32 * cb, j * BKV, ko,
                  v_full);
    }
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_fence_init();
    const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
    mbar_expect_tx(q_full, QT);
    for (int cb = 0; cb < BOXES; ++cb)
      tma_load_3d(q_s + cb * Q_BOX, &map_q, qc + 32 * cb, q0, qo, q_full);
    if (ntiles > 0) load(0);
  }
  __syncthreads();

  // warpgroup wg: columns [128 wg, 128 wg + 128) of D for the rows [q0,
  // q0 + 64); warp-uniform in the compiler's eyes (a role read from tid
  // alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int r_in = q0 + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // columns 8 j + c_in + {0, 1}
  const int box0 = OWN * wg;        // the warpgroup's first box
  auto masked = [&](int c0) {
    return c0 + BKV > p.tk || (p.causal && c0 + BKV - 1 > q0 + off);
  };
  // the traded partial score tiles: each warpgroup's in its half of K lo
  float* const part_own =
      reinterpret_cast<float*>(gk + KVT + wg * (KVT / WGS));
  const float* const part_other =
      reinterpret_cast<const float*>(gk + KVT + (1 - wg) * (KVT / WGS));

  float o[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t phase = j & 1;
    // the other warpgroup has read this one's partial of tile j - 1 (in K
    // lo), and every warp's P . V of tile j - 1 is done (V^T)
    bar_sync(1, THREADS);
    mbar_wait(k_full, phase);
    split_k(gk + box0 * KV_BOX, wtid);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    // the score chains of the warpgroup's first two boxes (c0, c1), then
    // of its last two (e0, e1), each into arrays of its own: s = (c0 + c1)
    // + (e0 + e1). V is split while the first two run.
    float s[BKV / 2], c0[BKV / 2], c1[BKV / 2];
    {
      QFrag f0, f1;
      q_frags(f0, gq + box0 * Q_BOX, warp, lane);
      q_frags(f1, gq + (box0 + 1) * Q_BOX, warp, lane);
      fence_q(f0);
      fence_q(f1);
      wgmma_fence();
      qk_box(c0, f0, k_s + box0 * KV_BOX);
      qk_box(c1, f1, k_s + (box0 + 1) * KV_BOX);
      wgmma_commit();
      mbar_wait(v_full, phase);
      split_v(gv, 128 * wg, wtid);
      wgmma_wait<0>();
    }
    d256::fence2(c0, c1);
    d256::add2(s, c0, c1, true);
    {
      float e0[BKV / 2], e1[BKV / 2];
      QFrag f2, f3;
      q_frags(f2, gq + (box0 + 2) * Q_BOX, warp, lane);
      q_frags(f3, gq + (box0 + 3) * Q_BOX, warp, lane);
      fence_q(f2);
      fence_q(f3);
      wgmma_fence();
      qk_box(e0, f2, k_s + (box0 + 2) * KV_BOX);
      qk_box(e1, f3, k_s + (box0 + 3) * KV_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      d256::fence2(e0, e1);
      d256::add2(s, e0, e1, false);
    }
    // V^T written, and every warp's score products done: K lo is free
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    put(part_own, wtid, s);
    bar_sync(1, THREADS);  // the trade; K and raw V are free
    if (tid == 0 && j + 1 < ntiles) load(j + 1);
    add_from(part_other, wtid, s);
    softmax_tile<NJ>(s, m_run, l_run, alpha, masked(j * BKV), j * BKV, r_in,
                     c_in, p, off);
    uint32_t ph[4 * NJ], pl[4 * NJ];
    split_p<NJ>(ph, pl, s);
    float ot[64];
    fence_a(ph);
    fence_a(pl);
    wgmma_fence();
    pv_wgmma(ot, ph, pl, v_s + KVT + 128 * wg * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
#pragma unroll
    for (int e = 0; e < 64; ++e)
      o[e] = fmaf(o[e], alpha[(e >> 1) & 1], ot[e]);
  }

  // out = o / l of the warpgroup's columns and lse, rows past Tq not
  // stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_in + 8 * i;
    if (r >= p.tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (wg == 0 && (lane & 3) == 0)
      p.lse[((long long)b * p.heads + h) * p.tq + r] =
          l > 0.f ? m_run[i] * LN2 + logf(l) : NEG;
    float* const row =
        p.out + (long long)h * p.q.head_col + r * p.q.st_seq +
        (long long)(b * p.q.outer_b + h * p.q.outer_h) * p.q.st_outer +
        128 * wg;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<float2*>(row + 8 * jj + c_in) =
          make_float2(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
  }
}

}  // namespace

extern "C" {

// Rows of a query tile (a block) and of a key tile (the stage).
int flash_attn_fwd_f32_d256_sm90_tile_q() { return BQ; }
int flash_attn_fwd_f32_d256_sm90_tile_kv() { return BKV; }

// fp32 q, k, v at D = 256 (D contiguous), addressed through q_geo and
// k_geo (v shares k's) as flash_attn_fwd_f32_sm90 takes them; out takes
// q's addressing; lse is [B, H, Tq] fp32. Returns a CUDA error, or -1
// (another D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a
// tensor map refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_fwd_f32_d256_sm90(const void* q, const void* k,
                                 const void* v, void* out, void* lse,
                                 int batch, int heads, int tq, int tk, int d,
                                 const long long* q_geo,
                                 const long long* k_geo, float scale,
                                 int causal, void* stream) {
  if (d != D || batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap mq, mk, mv;
  if (!make_map_3d(&mq, q, q_geo, tq, BQ) ||
      !make_map_3d(&mk, k, k_geo, tk, BKV) ||
      !make_map_3d(&mv, v, k_geo, tk, BKV))
    return -3;
  Params p{};
  p.q = geo_of(q_geo);
  p.k = geo_of(k_geo);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  const int err = allow_smem(fwd_f32_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tq + BQ - 1) / BQ * heads * batch;
  fwd_f32_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                             static_cast<cudaStream_t>(stream)>>>(mq, mk, mv,
                                                                  p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
