// Flash attention forward in bf16 on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA.
//
// Replaces, for bf16 inputs at head_dim 64 and 128, the forward TPU
// kernels of paddle_tpu/ops/pallas/flash_attention.py (run through
// pl.pallas_call by _fwd): _fwd_kernel (BHTD) and _fwd_kernel_bthd (BTHD).
// For each query row r, without writing the [Tq, Tk] scores to device
// memory:
//     s[r, c] = (q[r] . k[c]) * scale          (fp32 products and sums)
//     lse[r]  = logsumexp over the visible c of s[r, c]
//     out[r]  = sum_c softmax(s[r])[c] * v[c]
// under the contract every flash kernel keeps (ops/flash_attention.py's
// rounding rule): the causal mask is aligned bottom-right (key c
// visible from row r iff c <= r + Tk - Tq); P is rounded to bf16 against
// the running row max before P . V, and the row sum takes the unrounded
// P; a row that sees no key gives out 0 and lse -1e30. lse (B, H, Tq) fp32
// is what the dq and dk/dv kernels rebuild P from.
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. At the training shape (B = 8, T = 2048, H = 12, D = 64,
// causal) the visible score entries number B*H*T*(T+1)/2, and the two
// products cost 2*D FLOPs an entry each: 51.6 GFLOP, 0.052 ms, against
// 0.03 ms to read q, k, v and write out once.
//
// Design (FlashAttention-3's shape, kept simple).
//   - Block: one per (128-query tile, head, batch), two consumer
//     warpgroups of 64 query rows each and one producer warp; query tiles
//     in reverse order, so that the long causal rows start first. At the
//     training shape 16 x 12 x 8 = 1,536 blocks, one an SM.
//   - Loads: the Q tile once, then key and value tiles of 64 rows through
//     a ring of 4 stages tracked by full/empty mbarriers, all by TMA with
//     the 128-byte swizzle. A rank-3 tensor map per operand, (H*D, T, B)
//     for BTHD and (D, T, B*H) for BHTD, with T a dimension of its own:
//     TMA zero-fills past a sequence's end, so no batch reads another's
//     rows and no layout needs a transposed copy. Keys past Tk are masked.
//   - Scores: wgmma m64n64k16 with Q as A and K as B, both K-major (a
//     64-column half of a row is one swizzle atom; D = 128 is two), fp32
//     in registers.
//   - Online softmax in registers: a row's 16 values of a thread, then the
//     4 lanes of its quad (two shuffles); exp2f on scores prescaled by
//     scale * log2(e); the output accumulator rescaled by alpha; the row
//     sum kept per thread and summed over the quad once at the end.
//   - P . V: P rounded to bf16 in registers, where the score accumulator's
//     fragment is already the A fragment of the next wgmma (m64n64k16, A
//     from registers); V is B, MN-major, through the transpose flag; one
//     wgmma per 64 output columns.
//   - Overlap: at D = 64 a 64 x 64 tile's 4,096 exponentials take the
//     SM's special-function units about as long as the tile's two
//     products take its tensor cores. So each warpgroup runs a software
//     pipeline: it issues tile j's scores and tile j-1's P . V together
//     and computes tile j's softmax while the product runs; o is rescaled
//     once that product is done. What still sets the pace is the latency
//     of each tile's softmax and handshakes, on two consumer warps a
//     scheduler (tools/torch_flash_fwd_ablation.py measures it).
//   - Causal work: key tiles wholly above the diagonal are not loaded;
//     only tiles that cross it or the ragged edge are masked.
//   - Output: plain bf16 stores at the layout's strides; lse (B, H, Tq).
// Shared memory: 16 KB of Q and 4 stages of 16 KB at D = 64; 32 KB and 4
// stages of 32 KB at D = 128. ptxas (CUDA 12.8) reports 122 (D = 64) and
// 154 (D = 128) registers and no spill; the SASS holds 16 and 32 HGMMA,
// the pipeline's prologue, loop and epilogue each issuing their own.
// Two blocks an SM (D = 64) held ptxas to 95 registers, spilled and
// serialized the wgmma.
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;                // query rows per block
constexpr int BKV = 64;                // key/value rows per ring stage
constexpr int THREADS = 288;           // 2 consumer warpgroups + 1 warp
constexpr int Q_BOX = BQ * 128;        // 128 rows x 64 bf16
constexpr int KV_BOX = BKV * 128;      // 64 rows x 64 bf16
constexpr int STAGES = 4;
constexpr float NEG = -1e30f;          // finite stand-in for -inf
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One operand's addressing: element (b, t, h, c) sits at the tensor-map
// coordinates (h * head_col + c, t, b * outer_b + h * outer_h) and at
// the element offset coordinate0 + t * st_seq + coordinate2 * st_outer.
struct Geo {
  long long st_seq, st_outer;
  int head_col, outer_b, outer_h;
};

struct Params {
  Geo q, k;
  void* out;   // q's layout and strides
  float* lse;  // [B, H, Tq]
  int heads, tq, tk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(D / 64) * Q_BOX +
         (size_t)STAGES * 2 * (D / 64) * KV_BOX + 8 * (2 * STAGES + 1);
}

// s = q k^T of one key tile, issued (not waited for): q_addr the warpgroup's
// 64 query rows, k_addr the tile's keys, one 64-column half of D after the
// other
template <int HALVES>
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
template <int HALVES>
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
// thread's two rows (r, r + 8) move on, and alpha = exp2(m_old - m_new)
// is what o must be rescaled by. masked: the tile crosses the causal
// diagonal or the end of the keys.
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

template <int HALVES>
__device__ __forceinline__ void rescale(float (&o)[HALVES][32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hh][e] *= alpha[(e >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                    __grid_constant__ const CUtensorMap map_k,
                    __grid_constant__ const CUtensorMap map_v,
                    const Params p) {
  constexpr int HALVES = D / 64;
  constexpr int STAGE = 2 * HALVES * KV_BOX;  // K halves, then V halves
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + HALVES * Q_BOX;
  const uint32_t bar_s = ring + STAGES * STAGE;
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (STAGES + s); };
  const uint32_t q_full = bar_s + 16u * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = p.tk - p.tq;  // causal: key c visible iff c <= r + off
  const int end = p.causal ? min(p.tk, min(q0 + BQ, p.tq) + off) : p.tk;
  const int ntiles = end > 0 ? (end + BKV - 1) / BKV : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warp's role, warp-uniform in the compiler's eyes (a role read
  // from tid alone makes ptxas serialize the wgmma)
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == 2) {  // producer warp: one thread issues every copy
    if (tid == 256) {
      const int qc = h * p.q.head_col, qo = b * p.q.outer_b + h * p.q.outer_h;
      const int kc = h * p.k.head_col, ko = b * p.k.outer_b + h * p.k.outer_h;
      mbar_expect_tx(q_full, HALVES * Q_BOX);
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load_3d(q_s + hh * Q_BOX, &map_q, qc + 64 * hh, q0, qo, q_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < ntiles; ++j) {
        const uint32_t ks = ring + stage * STAGE;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), STAGE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(ks + hh * KV_BOX, &map_k, kc + 64 * hh, j * BKV, ko,
                      full(stage));
          tma_load_3d(ks + (HALVES + hh) * KV_BOX, &map_v, kc + 64 * hh,
                      j * BKV, ko, full(stage));
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
  const int r_in = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and r_in + 8
  const int c_in = 2 * (lane & 3);  // columns 8 j + c_in + {0, 1}
  const int first_row = q0 + 64 * wg;

  const uint32_t q_addr = q_s + wg * (64 * 128);
  auto k_at = [&](int st) { return ring + st * STAGE; };
  auto v_at = [&](int st) { return ring + st * STAGE + HALVES * KV_BOX; };
  auto masked = [&](int c0) {
    return c0 + BKV > p.tk || (p.causal && c0 + BKV - 1 > first_row + off);
  };

  float o[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hh][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[4][4];  // round(P) of the last tile whose scores are done

  // Software pipeline: while the tensor cores multiply P of tile j - 1 by
  // its values, the warpgroup runs the softmax of tile j, whose scores
  // were issued first. o is rescaled by tile j's alpha once that product
  // is done; tile j - 1's stage is released then.
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    float s[32];
    mbar_wait(full(0), 0);
    wgmma_fence();
    qk_wgmma<HALVES>(s, q_addr, k_at(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, masked(0), 0, r_in, c_in, p, off);
    pack_p(pa, s);
  }
  int stage = 0;  // the stage of tile j - 1
  uint32_t phase = 0;
  for (int j = 1; j < ntiles; ++j) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    float s[32];
    mbar_wait(full(stage), phase);
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
    wgmma_fence();
    qk_wgmma<HALVES>(s, q_addr, k_at(stage));
    wgmma_commit();
    pv_wgmma<HALVES>(o, pa, v_at(prev));
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the product may still run
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, masked(j * BKV), j * BKV, r_in,
                 c_in, p, off);
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
    if (leader) mbar_arrive(empty(prev));
    rescale<HALVES>(o, alpha);
    pack_p(pa, s);
  }
  if (ntiles > 0) {  // the last tile's product
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
    wgmma_fence();
    pv_wgmma<HALVES>(o, pa, v_at(stage));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
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

template <int D>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& p, int batch,
           cudaStream_t s) {
  const int err = allow_smem(fwd_sm90_kernel<D>, smem_bytes<D>());
  if (err) return err;
  const dim3 grid((p.tq + BQ - 1) / BQ, p.heads, batch);
  fwd_sm90_kernel<D><<<grid, THREADS, smem_bytes<D>(), s>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of a query tile (a block) and of a key/value tile (a ring stage).
int flash_attn_fwd_sm90_tile_q() { return BQ; }
int flash_attn_fwd_sm90_tile_kv() { return BKV; }

// bf16 q, k, v (D = 64 or 128, D contiguous) addressed through q_geo and
// k_geo (v shares k's): {inner, outer, st_seq, st_outer, head_col,
// outer_b, outer_h}, element (b, t, h, c) at offset (h * head_col + c) +
// t * st_seq + (b * outer_b + h * outer_h) * st_outer; for BTHD
// {H*D, B, H*D, T*H*D, D, 1, 0}, for BHTD {D, B*H, D, T*D, 0, H, 1}. out
// takes q's addressing; lse is [B, H, Tq] fp32. Returns a CUDA error, or
// -1 (another D, or an empty size), -2 (no cuTensorMapEncodeTiled), -3 (a
// tensor map refused: a pointer or a stride not a multiple of 16 bytes).
int flash_attn_fwd_sm90(const void* q, const void* k, const void* v,
                        void* out, void* lse, int batch, int heads, int tq,
                        int tk, int d, const long long* q_geo,
                        const long long* k_geo, float scale, int causal,
                        void* stream) {
  if ((d != 64 && d != 128) || batch <= 0 || heads <= 0 || tq <= 0 ||
      tk <= 0)
    return -1;
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
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(mq, mk, mv, p, batch, s)
                 : launch<128>(mq, mk, mv, p, batch, s);
}

}  // extern "C"
