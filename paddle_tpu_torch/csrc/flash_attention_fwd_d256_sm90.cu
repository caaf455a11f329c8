// Flash attention forward in bf16 at head_dim 256 on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs at head_dim 256, the forward TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (run through pl.pallas_call by
// _fwd): _fwd_kernel (BHTD) and _fwd_kernel_bthd (BTHD). For each query
// row r, without writing the [Tq, Tk] scores to device memory:
//     s[r, c] = (q[r] . k[c]) * scale          (fp32 products and sums)
//     lse[r]  = logsumexp over the visible c of s[r, c]
//     out[r]  = sum_c softmax(s[r])[c] * v[c]
// under the contract of ops/flash_attention.py's rounding rule: the causal
// mask is aligned bottom-right (key c visible from row r iff c <= r + Tk -
// Tq); the online softmax starts from -1e30; P is rounded to bf16 against
// the running row max before P . V, and the row sum takes the unrounded P;
// a row that sees no key gives out 0 and lse -1e30. lse (B, H, Tq) fp32
// is what the dq and dk/dv kernels rebuild P from. Any GPTConfig whose
// d_model / n_head is 256 reaches it (gpt2s's 768 in 3 heads, as Gemma's
// head_dim).
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. At B = 8, T = 2048, H = 3, D = 256, causal, the visible
// score entries number B*H*T*(T+1)/2 and the two products cost 2*D FLOPs
// an entry each: 51.6 GFLOP, 0.052 ms, against 0.03 ms to read q, k, v and
// write out once.
//
// Design (flash_attention_fwd_sm90.cu's at D = 64 and 128, rearranged for
// the registers and shared memory that D = 256 takes).
//   - Registers: a warpgroup's 64 x 256 fp32 output accumulator takes 128
//     registers a thread, the 64 x 64 score tile 32 and P packed in bf16
//     16: more than the 168 that ptxas gives a thread of a block with two
//     consumer warpgroups and a producer warp (flash_attention_bwd_sm90.cu
//     "Registers"). So the block has no producer warp: two consumer
//     warpgroups of 64 query rows each (256 threads, up to 255 registers),
//     and thread 0 issues every TMA load, at the top of an iteration, where
//     no wgmma is in flight and the stage's empty barrier shows it free.
//   - Shared memory: the 128-row Q tile (64 KB, four 64-column swizzle
//     atoms) and a ring of 2 stages of a 64-key K tile and V tile (32 KB
//     each): 192 KB. At the top of iteration j thread 0 loads tile j + 1
//     into the stage of tile j - 1, which both warpgroups released in
//     iteration j - 1 (after its P . V): each load has an iteration to
//     land. K and V have full barriers of their own (the TMA bytes), so
//     a tile's scores start before its V lands; the stage's empty barrier
//     takes one arrival per warpgroup.
//   - Loads: rank-3 tensor maps as the D = 64 kernel's (ops/
//     flash_attention.py:tma_geometry), so both layouts are read without a
//     copy and a box past a sequence's end reads zeros; keys past Tk are
//     masked.
//   - Scores: wgmma m64n64k16 with Q as A and K as B, both K-major, 16
//     slices over D (four atoms of four k16 slices).
//   - Online softmax in registers, as the D = 64 kernel: exp2f on scores
//     prescaled by scale * log2(e), the row max over the quad, the output
//     rescaled by alpha, the row sum summed over the quad at the end.
//   - P . V: P rounded to bf16 in registers, where the score fragment is
//     the A fragment of the next wgmma (m64n64k16, A from registers); V is
//     B, MN-major, through the bf16 transpose flag; one wgmma per k16 slice
//     and 64 output columns, 16 a tile.
//   - No software pipeline: each warpgroup runs a tile's scores, its
//     softmax and its P . V in turn, and the two warpgroups' products
//     cover each other's softmax. At D = 256 each product is 4x longer
//     than at D = 64 against the same softmax, and the D = 64 kernel's
//     pipeline (tile j's scores issued with tile j - 1's P . V, a second
//     ring slot of V in use) measured no faster here
//     (tools/torch_flash_fwd_ablation.py --d256 times what sets the pace).
//   - Grid: one dimension, the (batch, head) pairs fastest and the query
//     tiles from the last, so the long causal rows of every pair start
//     first. At B = 8, T = 2048, H = 3: 16 x 3 x 8 = 384 blocks, one an SM.
//   - Causal work: key tiles wholly above the diagonal are not loaded;
//     only tiles that cross it or the ragged edge are masked.
//   - Output: plain bf16 stores at the layout's strides; lse (B, H, Tq).
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int D = 256;
constexpr int HALVES = D / 64;       // 64-column swizzle atoms of a row
constexpr int BQ = 128;              // query rows per block
constexpr int BKV = 64;              // keys per K or V tile
constexpr int THREADS = 256;         // 2 consumer warpgroups
constexpr int Q_BOX = BQ * 128;      // 128 rows x 64 bf16
constexpr int KV_BOX = BKV * 128;    // 64 rows x 64 bf16
constexpr int KV_TILE = HALVES * KV_BOX;  // a K (or V) tile: 32 KB
constexpr int STAGES = 2;            // of the K and V ring
constexpr int WGS = 2;
constexpr float NEG = -1e30f;        // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM = 1024 + (size_t)HALVES * Q_BOX +
                        (size_t)STAGES * 2 * KV_TILE + 8 * (3 * STAGES + 1);
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

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
  void* out;   // q's layout and strides
  float* lse;  // [B, H, Tq]
  int heads, batch, tq, tk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// s = q k^T of one key tile, issued (not waited for): q_addr the
// warpgroup's 64 query rows, k_addr the tile's keys, one 64-column atom of
// D after the other
__device__ __forceinline__ void qk_wgmma(float (&s)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64<0>(s, desc(q_addr + hh * Q_BOX + 32 * kk),
                   desc(k_addr + hh * KV_BOX + 32 * kk), (hh | kk) != 0);
}

// o += round(P) . v of one key tile, issued: pa holds P's 4 k16 slices as
// wgmma's A, v_addr the tile's values (MN-major)
__device__ __forceinline__ void pv_wgmma(float (&o)[HALVES][32],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64_rs(o[hh], pa[kk],
                   desc(v_addr + hh * KV_BOX + kk * 16 * 128));
}

// The online softmax of one 64 x 64 score tile (keys c0 ..), in place: s
// becomes P = exp2(s * scale_log2 - m), masked entries 0; m and l of the
// thread's two rows (r, r + 8) move on, and alpha = exp2(m_old - m_new) is
// what o must be rescaled by. masked: the tile crosses the causal diagonal
// or the end of the keys.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int c0, int r,
                                             int c_in, const Params& p,
                                             int off) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * jj + c_in + c;
          const bool keep =
              col < p.tk && (!p.causal || col <= r + 8 * i + off);
          float& e = s[4 * jj + 2 * i + c];
          e = keep ? e * p.scale_log2 : -INFINITY;  // adds exactly 0
        }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= p.scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float tmax = NEG;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      tmax = fmaxf(tmax, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[i], tmax);
    alpha[i] = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& e = s[4 * jj + 2 * i + c];
        e = exp2f(e - m_new);
        sum += e;
      }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// P rounded to bf16, packed as wgmma's A: slice kk is s[8 kk .. 8 kk + 8)
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

__device__ __forceinline__ void fence_o(float (&o)[HALVES][32]) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_d256_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v,
                         const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + HALVES * Q_BOX;
  const uint32_t bar_s = ring + STAGES * 2 * KV_TILE;
  // tile t sits in stage t % 2 (K, then V); its barriers' phase is t / 2
  auto k_at = [&](int t) { return ring + (t & 1) * 2 * KV_TILE; };
  auto v_at = [&](int t) { return k_at(t) + KV_TILE; };
  auto k_full = [&](int t) { return bar_s + 8u * (t & 1); };
  auto v_full = [&](int t) { return bar_s + 8u * (2 + (t & 1)); };
  auto empty = [&](int t) { return bar_s + 8u * (4 + (t & 1)); };
  auto parity = [](int t) { return static_cast<uint32_t>((t >> 1) & 1); };
  const uint32_t q_full = bar_s + 8u * 3 * STAGES;

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

  auto load = [&](int t) {  // tile t's keys and values
    mbar_expect_tx(k_full(t), KV_TILE);
    mbar_expect_tx(v_full(t), KV_TILE);
    for (int hh = 0; hh < HALVES; ++hh) {
      tma_load_3d(k_at(t) + hh * KV_BOX, &map_k, kc + 64 * hh, t * BKV, ko,
                  k_full(t));
      tma_load_3d(v_at(t) + hh * KV_BOX, &map_v, kc + 64 * hh, t * BKV, ko,
                  v_full(t));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), WGS);  // one arrival per warpgroup
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
    const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
    mbar_expect_tx(q_full, HALVES * Q_BOX);
    for (int hh = 0; hh < HALVES; ++hh)
      tma_load_3d(q_s + hh * Q_BOX, &map_q, qc + 64 * hh, q0, qo, q_full);
    for (int t = 0; t < STAGES && t < ntiles; ++t) load(t);
  }
  __syncthreads();

  // warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64); warp-uniform
  // in the compiler's eyes (a role read from tid alone makes ptxas
  // serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  const int first_row = q0 + 64 * wg;
  const int r_in = first_row + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // columns 8 j + c_in + {0, 1}
  const uint32_t q_addr = q_s + wg * (64 * 128);
  auto masked = [&](int c0) {
    return c0 + BKV > p.tk || (p.causal && c0 + BKV - 1 > first_row + off);
  };

  float o[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hh][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    if (tid == 0 && j >= 1 && j + 1 < ntiles) {  // the header's refill
      mbar_wait(empty(j - 1), parity(j - 1));
      load(j + 1);
    }
    float s[32];
    uint32_t pa[4][4];
    mbar_wait(k_full(j), parity(j));
    wgmma_fence();
    qk_wgmma(s, q_addr, k_at(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, masked(j * BKV), j * BKV, r_in,
                 c_in, p, off);
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hh][e] *= alpha[(e >> 1) & 1];
    pack_p(pa, s);
    mbar_wait(v_full(j), parity(j));
    fence_o(o);
    wgmma_fence();
    pv_wgmma(o, pa, v_at(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_o(o);
    if (leader) mbar_arrive(empty(j));
  }

  // out = o / l and lse, rows past Tq not stored
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
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
    __nv_bfloat16* row =
        out + (long long)h * p.q.head_col + r * p.q.st_seq +
        (long long)(b * p.q.outer_b + h * p.q.outer_h) * p.q.st_outer;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(row + 64 * hh + 8 * jj + c_in) =
            pack_bf16(o[hh][4 * jj + 2 * i] * inv,
                      o[hh][4 * jj + 2 * i + 1] * inv);
  }
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

}  // namespace

extern "C" {

// Rows of a query tile (a block) and of a key or value tile (a ring stage).
int flash_attn_fwd_d256_sm90_tile_q() { return BQ; }
int flash_attn_fwd_d256_sm90_tile_kv() { return BKV; }

// bf16 q, k, v at D = 256 (D contiguous), addressed through q_geo and k_geo
// (v shares k's) as flash_attn_fwd_sm90 takes them; out takes q's
// addressing; lse is [B, H, Tq] fp32. Returns a CUDA error, or -1 (another
// D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a tensor map
// refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_fwd_d256_sm90(const void* q, const void* k, const void* v,
                             void* out, void* lse, int batch, int heads,
                             int tq, int tk, int d, const long long* q_geo,
                             const long long* k_geo, float scale, int causal,
                             void* stream) {
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
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.batch = batch;
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  const int err = allow_smem(fwd_d256_sm90_kernel, SMEM);
  if (err) return err;
  const int blocks = (tq + BQ - 1) / BQ * heads * batch;
  fwd_d256_sm90_kernel<<<blocks, THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
