// Fused lm-head + softmax cross-entropy backward (dx and dW) in fp32 on
// Hopper's tensor cores (sm_90a) through split TF32 (3xTF32): wgmma fed by
// TMA.
//
// Replaces, for fp32 inputs, the two backward TPU kernels of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (each run through
// pl.pallas_call): _dx_kernel (by _dx_call) and _dw_kernel (by _dw_call).
// From the saved per-row lse and a per-row cotangent g, without an [N, V]
// buffer of logits or of d-logits:
//     dl[n, v] = (exp(x[n] . w[v] - lse[n]) - [v == label[n]]) * g[n]
//                in fp32 (the TPU kernel rounds it to W's dtype: fp32)
//     dx = dl . W   (N x D)        dW = dl^T . x   (V x D)
// with fp32 sums, each output stored once. Labels outside [0, V) hit no
// column. A GPT program built in fp32 runs it (the static_amp step too:
// fused_lm_head_ce is on neither AMP list).
//
// Precision: split TF32, as lmhead_ce_fwd_f32_sm90.cu. Each operand is
// written a = hi + lo with hi = tf32_rna(a) and lo = tf32_rna(a - hi), and
// each product is summed as hi . hi + (lo . hi + hi . lo) into two fp32
// accumulators: about 2^-22 of a product is dropped (TF32 alone, 10
// mantissa bits, puts about 1e-3 on a score at D = 768). This holds for
// both products: the score tile, and the product with the d-logits, which
// the kernel splits itself. The tensor cores' fp32 sums need not round to
// nearest (those of earlier generations truncate), so no accumulator of
// theirs runs long: each pair is new for 64 of D (score) or for one
// 64-column tile (product), merged once complete and added in fp32 (round
// to nearest) to a total (tests/test_torch_lmhead_ce_f32.py emulates this
// arithmetic with truncating tensor cores and sets the float64 bound that
// chip_smoke.py holds the kernel to).
//
// Bound on this card (H100 SXM, 494.7 TFLOP/s dense TF32, 3.35 TB/s):
// operations. The function needs 4*N*V*D FLOPs (the score tile, then the
// product with the d-logits); three tf32 products of each make 12*N*V*D:
// at N = 16384, D = 768, V = 32768 that is 4.95 TFLOP, 10.00 ms for each
// of dx and dW (24.62 ms for 4*N*V*D on the 67 TFLOP/s of the FMA units).
//
// Design. dx and dW are one kernel with the roles of x and W swapped: a
// block owns 32 "rows" (tokens for dx, vocab entries for dW) and sweeps
// 64-wide tiles of "columns" (the other side): out[r] = sum_c dl[r, c] *
// b[c].
//   - The output is held transposed, out^T [d, r] (wgmma M = 64 output
//     columns of D, N = the 32 rows). tf32 wgmma takes only K-major
//     operands from shared memory (no transpose flag), and the second
//     product's K is the column index c, along which the column tile b[c,
//     d] is not contiguous: so b^T is wgmma's A, from registers, gathered
//     from the TMA tile by each thread (the swizzle makes the gathers free
//     of bank conflicts; the output's rows are permuted to that end and put
//     back at the store), split into hi and lo there, and the d-logits are
//     the K-major B in shared memory. The score tile is built transposed
//     too, S^T [c, r] = b . x^T: A = the column tile from registers, the
//     same gather as a row-major tile, B = the row tile.
//   - Registers: a 32 x 768 fp32 output is 96 registers a thread over two
//     warpgroups (each owns 384 output columns, 6 tiles of m64n32); a
//     64-row output would need 192, which with its accumulator pairs and
//     A fragments does not fit. So each score tile is built once
//     (12*N*V*D), with no D split across blocks and no cluster exchange;
//     the price is N = 32 in every wgmma and a thin row tile.
//   - Score (64 columns x 32 rows over all of D): the two warpgroups split
//     D (warpgroup w takes the second 32-deep box of each 64-deep step);
//     each keeps its fp32 total in shared memory (to spare registers) and
//     the two totals are added there before the d-logits: each warpgroup
//     builds half of them (16 of the 32 rows), splits them and writes hi
//     and lo into a swizzled K-major tile (double-buffered).
//   - The row side's hi and lo come from a split launch into a scratch
//     [2, rows, D] (the TMA boxes of B need them in shared memory; a split
//     pass there would add 24 KB of shared-memory traffic a step), so the
//     score needs no pass over shared memory before its wgmma.
//   - Ring: 5 stages of 32 KB. A score step holds two column boxes (64 x
//     32 fp32) and the row side's hi and lo boxes (32 x 32 each); a product
//     step four column boxes (128 of D: one m64 tile for each warpgroup).
//     Each step opens with a block barrier, after which no wgmma group of
//     step h - 2 is in flight, and thread 0 refills that stage three loads
//     ahead once its warpgroup's first group of the step is issued (so that
//     the issue holds no wgmma back). Every thread keeps the next load's
//     position, the same in all of them, without a division.
//   - wgmma groups of 2 k8 slices (6 wgmma: 3 products each), their A
//     fragments in two register buffers, so one group stays in flight while
//     the next is gathered and split.
//   - D: the wrapper pads D to a multiple of 64 with zero columns; the
//     output is swept in slabs of 768 (a wider D rebuilds the scores once
//     a slab); a product step past D loads nothing and its rows are never
//     stored. Ragged N and V are zero-filled by TMA; d-logits of columns
//     past the last are 0 and rows past the last are not stored.
//   - Grid: (row tiles, column chunks). At N = 16384 dx has 512 row tiles
//     (3.9 waves of one block per SM on 132 SMs) and dW 1024 (7.8 waves).
//     Where the row tiles leave SMs idle (dx at N 511, 33, 1), the column
//     sweep is split into chunks, each writing fp32 partials [chunks,
//     rows, D] that a reduce launch sums in chunk order.
// Shared memory: 1 KB of alignment + 5 x 32 KB + 2 x 16 KB of d-logits + 16
// KB of score totals + the rows' lse, g and label + barriers, 214,440
// bytes; one block of 256 threads per SM. ptxas (CUDA 12.8) gives it all
// 255 registers a thread with a few dozen bytes of spill; the SASS holds
// HGMMA (chip_smoke.py's build phase prints both).
//
// Where the time goes (tools/torch_ce_bwd_f32_ablation.py on an H100, at
// N = 16384): PERF.md section 6 has the figures. The wgmma stream alone,
// with its barriers, waits and d-logits, takes well over the tensor
// cores' bound (N = 32 wgmma in groups of 6, one group in flight); the
// gathers and splits of A and the TMA loads add the rest. The next
// redesign's target is N: 64 rows a block, in a cluster of two CTAs that
// each own half of D and exchange partial score tiles through distributed
// shared memory.
//
// Plain C interface, loaded with ctypes; barrier, TMA and wgmma helpers
// from sm90.cuh.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int ROWS = 32;                  // output rows per block: wgmma N
constexpr int COLS = 64;                  // columns per column tile
constexpr int BOX = BOX_COLS_F32;         // depth of a TMA box: 32 fp32
constexpr int PAD = 2 * BOX;              // a score step's depth; D % PAD == 0
constexpr int MT = 6;                     // product steps per slab
constexpr int SLAB = MT * 128;            // output columns per pass: 768
constexpr int COL_BOX = COLS * BOX * 4;   // 8 KB
constexpr int ROW_BOX = ROWS * BOX * 4;   // 4 KB
constexpr int STAGE = 4 * COL_BOX;        // 32 KB
constexpr int STAGES = 5;                 // TMA ring
constexpr int DL = ROWS * COLS * 4;       // hi or lo of a d-logit tile: 8 KB
constexpr int CHUNK_C = ROWS * 128;       // 32 columns of it: 4 KB
constexpr int XCHG = 2 * 16 * 128 * 4;    // the score's partial sums: 16 KB
constexpr int THREADS = 256;              // 2 warpgroups
constexpr int KG = 2;                     // k8 slices per wgmma group
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * STAGE + 4 * DL + XCHG + 3 * ROWS * 4 +
         8 * STAGES;
}

// A label compared with indices in [0, range): -1 where it lies outside.
__device__ __forceinline__ int label_in(long long l, int range) {
  return (l >= 0 && l < range) ? static_cast<int>(l) : -1;
}

// Byte offset of fp32 (row, col) in a tile of 128-byte rows written with
// TMA's 128-byte swizzle: 16-byte chunk col / 4 XOR row % 8.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// The fp32 value at byte offset off of a tile in shared memory.
__device__ __forceinline__ float gather(const unsigned char* tile,
                                        uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// The split-TF32 pair of a: hi = tf32_rna(a), lo = tf32_rna(a - hi).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(a - h));
}

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// A of the score for the KG 8-deep slices from s0 of the warpgroup's
// 32-deep box (m64 columns x k8 each): a[k][q] is column 16 warp + g + 8
// (q & 1), depth 8 (s0 + k) + t + 4 (q >> 1). Lanes hit 32 banks: depth
// chunk (2 s + q / 2) ^ g.
__device__ __forceinline__ void load_score_a(uint32_t (&hi)[KG][4],
                                             uint32_t (&lo)[KG][4],
                                             const unsigned char* box, int s0,
                                             int warp, int g, int t) {
#pragma unroll
  for (int k = 0; k < KG; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split(gather(box, swz(16 * warp + g + 8 * (q & 1),
                            8 * (s0 + k) + t + 4 * (q >> 1))),
            hi[k][q], lo[k][q]);
}

// Output column (0..63, in the warpgroup's m64 tile) of accumulator row
// 16 warp + g + 8 i: a permutation chosen so that the gathers of
// load_prod_a hit 32 banks. The tile's two 32-deep boxes are warp / 2.
__device__ __forceinline__ int prod_col(int warp, int g, int i) {
  return 32 * (warp >> 1) + 16 * (g >> 2) + 4 * (2 * (warp & 1) + i) +
         (g & 3);
}

// A of the product (b^T) for the KG 8-column slices from s0 of the tile:
// a[k][q] is output column prod_col(warp, g, q & 1), tile column 8 (s0 +
// k) + t + 4 (q >> 1), read from the box of prod_col's 32 (the caller's
// box).
__device__ __forceinline__ void load_prod_a(uint32_t (&hi)[KG][4],
                                            uint32_t (&lo)[KG][4],
                                            const unsigned char* box, int s0,
                                            int warp, int g, int t) {
#pragma unroll
  for (int k = 0; k < KG; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split(gather(box, swz(8 * (s0 + k) + t + 4 * (q >> 1),
                            prod_col(warp, g, q & 1) & 31)),
            hi[k][q], lo[k][q]);
}

// One wgmma group, the three products of KG k8 slices: hi . hi into big,
// lo . hi + hi . lo into small (both new when fresh); A from registers,
// slice k's B hi and lo at descriptors of bh + 32 k and bl + 32 k (its
// K-major 128-byte rows) unless the slices cross into the next 32-column
// chunk of a d-logit tile (chunk bytes apart). No other instruction
// touches big or small while a group on them is in flight (ptxas would
// serialize every wgmma): they are fenced only when fresh, their last
// group waited for.
__device__ __forceinline__ void group(float (&big)[16], float (&small)[16],
                                      uint32_t (&ah)[KG][4],
                                      uint32_t (&al)[KG][4], uint32_t bh,
                                      uint32_t bl, bool fresh) {
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    fence_a(ah[k]);
    fence_a(al[k]);
  }
  if (fresh) {
    fence_regs(big);
    fence_regs(small);
  }
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const int acc = !(fresh && k == 0);
    const uint64_t dh = desc(bh + 32 * k), dl = desc(bl + 32 * k);
    wgmma_n32_tf32_rs(small, al[k][0], al[k][1], al[k][2], al[k][3], dh,
                      acc);
    wgmma_n32_tf32_rs(small, ah[k][0], ah[k][1], ah[k][2], ah[k][3], dl, 1);
    wgmma_n32_tf32_rs(big, ah[k][0], ah[k][1], ah[k][2], ah[k][3], dh, acc);
  }
  wgmma_commit();
}

// dst += big + small in fp32 (round to nearest): the two accumulators of
// a finished group merged, then added.
__device__ __forceinline__ void merge(float (&dst)[16], float (&big)[16],
                                      float (&small)[16]) {
  fence_regs(big);
  fence_regs(small);
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[e] += big[e] + small[e];
}

// One score step: the 4 k8 slices of the warpgroup's 32-deep box (box: its
// column box; bh, bl: the row side's hi and lo boxes) into the pair (sa,
// ss), new when fresh: 4 / KG groups, their A fragments alternating
// between two register buffers, each waited for two groups later.
// refill() after the first group.
template <typename Refill>
__device__ __forceinline__ void score_step(
    float (&sa)[16], float (&ss)[16], bool fresh, uint32_t (&ah)[2][KG][4],
    uint32_t (&al)[2][KG][4], const unsigned char* box, uint32_t bh,
    uint32_t bl, int warp, int g, int t, Refill&& refill) {
#pragma unroll
  for (int j = 0; j < 4 / KG; ++j) {
    if (j > 0) wgmma_wait<1>();
    load_score_a(ah[j & 1], al[j & 1], box, KG * j, warp, g, t);
    group(sa, ss, ah[j & 1], al[j & 1], bh + 32 * KG * j, bl + 32 * KG * j,
          fresh && j == 0);
    if (j == 0) refill();
  }
}

// One product step: the 8 k8 slices of the column tile for the
// warpgroup's m64 output tile (box: the column box of its first 32) into
// the pair (big, small), new for the step; once the previous step's
// groups are waited for (before the second group), its pair (pb, ps) is
// added to its output tile prev (when merge_prev). refill() after the
// first group.
template <typename Refill>
__device__ __forceinline__ void prod_step(
    float (&big)[16], float (&small)[16], float (&pb)[16], float (&ps)[16],
    float (&prev)[16], bool merge_prev, uint32_t (&ah)[2][KG][4],
    uint32_t (&al)[2][KG][4], const unsigned char* box, uint32_t dh,
    uint32_t dl, int warp, int g, int t, Refill&& refill) {
#pragma unroll
  for (int j = 0; j < 8 / KG; ++j) {
    if (j > 0) wgmma_wait<1>();
    if (j == 1 && merge_prev) merge(prev, pb, ps);
    load_prod_a(ah[j & 1], al[j & 1], box, KG * j, warp, g, t);
    const uint32_t off = (KG * j >> 2) * CHUNK_C + 32 * (KG * j & 3);
    group(big, small, ah[j & 1], al[j & 1], dh + off, dl + off, j == 0);
    if (j == 0) refill();
  }
}

// The block's sequence of loads: for each slab, for each column tile, kp
// score steps, then MT product steps. Every thread keeps the position of
// the next load (the same in all threads, so the compiler holds it in
// uniform registers, and without a division); thread 0 issues it into
// its ring stage.
struct Loads {
  int h = 0, p = 0, c0, sl = 0;  // load, its step in the tile, tile, slab

  __device__ __forceinline__ void issue(const CUtensorMap* map_b,
                                        const CUtensorMap* map_hi,
                                        const CUtensorMap* map_lo,
                                        uint32_t base, uint32_t bar,
                                        int row0, int d) const {
    const int kp = d / PAD;
    const int s = h % STAGES;
    const uint32_t full = bar + 8u * s, dst = base + s * STAGE;
    if (p < kp) {  // column boxes, the row side's hi and lo boxes
      mbar_expect_tx(full, STAGE);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int k0 = PAD * p + BOX * w;
        tma_load(dst + w * COL_BOX, map_b, k0, c0, full);
        tma_load(dst + 2 * COL_BOX + w * ROW_BOX, map_hi, k0, row0, full);
        tma_load(dst + 3 * COL_BOX + w * ROW_BOX, map_lo, k0, row0, full);
      }
    } else {  // the column boxes of 128 output columns, those before D
      const int d0 = sl * SLAB + 128 * (p - kp);
      const int nb = max(0, min(4, (d - d0) / BOX));
      mbar_expect_tx(full, nb * COL_BOX);
      for (int j = 0; j < nb; ++j)
        tma_load(dst + j * COL_BOX, map_b, d0 + BOX * j, c0, full);
    }
  }

  __device__ __forceinline__ void advance(int steps, int col_begin,
                                          int col_end) {
    ++h;
    if (++p == steps) {
      p = 0;
      c0 += COLS;
      if (c0 >= col_end) {
        c0 = col_begin;
        ++sl;
      }
    }
  }
};

// out (+ chunk * n_rows * d) [n_rows, d] = rows' sum over the chunk's
// columns c of dl[r, c] * b[c, :]. TOKEN_ROWS: rows are tokens (dx: b =
// W); else rows are vocab entries (dW: b = x). map_hi and map_lo: the
// rows' split; labels, g and lse belong to the tokens.
template <bool TOKEN_ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_f32_sm90_kernel(__grid_constant__ const CUtensorMap map_b,
                        __grid_constant__ const CUtensorMap map_hi,
                        __grid_constant__ const CUtensorMap map_lo,
                        const long long* __restrict__ labels,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        float* __restrict__ out, int n_rows, int n_cols,
                        int d, int tiles_per_chunk) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t dl_s = base + STAGES * STAGE;
  float* const xchg = reinterpret_cast<float*>(gbase + STAGES * STAGE +
                                               4 * DL);
  float* const row_lse = xchg + XCHG / 4;
  float* const row_g = row_lse + ROWS;
  int* const row_lbl = reinterpret_cast<int*>(row_g + ROWS);
  const uint32_t bar_s =
      base + STAGES * STAGE + 4 * DL + XCHG + 3 * ROWS * 4;

  const int row0 = blockIdx.x * ROWS;
  const int chunk = blockIdx.y;
  const int col_begin = chunk * tiles_per_chunk * COLS;
  const int col_end = min(n_cols, col_begin + tiles_per_chunk * COLS);
  const int ntiles = (col_end - col_begin + COLS - 1) / COLS;
  const int kp = d / PAD;
  const int steps = kp + MT;
  const int nslabs = (d + SLAB - 1) / SLAB;
  const int total = nslabs * ntiles * steps;
  const int tid = threadIdx.x;
  Loads next;
  next.c0 = col_begin;
  // the next load, by thread 0, if the sequence has one; all threads move
  // on
  auto load = [&]() {
    if (next.h < total) {
      if (tid == 0)
        next.issue(&map_b, &map_hi, &map_lo, base, bar_s, row0, d);
      next.advance(steps, col_begin, col_end);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_s + 8u * s, 1);
    mbar_fence_init();
  }
  for (int i = 0; i < STAGES - 2; ++i) load();
  if (TOKEN_ROWS && tid < ROWS) {
    const int r = row0 + tid;
    const bool ok = r < n_rows;
    row_lse[tid] = ok ? lse[r] * LOG2E : 0.f;
    row_g[tid] = ok ? g[r] : 0.f;
    row_lbl[tid] = ok ? label_in(labels[r], n_cols) : -1;
  }
  __syncthreads();

  // warpgroup wg, warp-uniform in the compiler's eyes (a role read from
  // tid alone makes ptxas serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // step h of the sequence: its stage, once loaded. Every thread has
  // waited for all but its last wgmma group, so after the barrier no
  // group of step h - 2 is in flight and the steps' loads (load(), after
  // each step's first group, so that warp 0's issue does not hold back
  // its warpgroup's first wgmma) refill that stage with load h + STAGES -
  // 2.
  int h = 0;
  auto begin = [&]() {
    const int s = h % STAGES;
    mbar_wait(bar_s + 8u * s, (h / STAGES) & 1);
    wgmma_wait<1>();
    __syncthreads();
    ++h;
    return s;
  };

  float o[MT][16];
  uint32_t ah[2][KG][4], al[2][KG][4];
  for (int sl = 0; sl < nslabs; ++sl) {
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int e = 0; e < 16; ++e) o[k][e] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      const int c0 = col_begin + t * COLS;

      // 1. partial score S^T[c, r] over the warpgroup's boxes of D: a new
      // pair of accumulators every two steps (64 of D), added once
      // complete into the warpgroup's fp32 total, kept in shared memory
      // (mine, a thread's 16 values 128 floats apart) to spare registers;
      // nothing in flight across the loop's back edge (ptxas serializes
      // every wgmma of the kernel otherwise)
      float sa[16], ss[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sa[e] = ss[e] = 0.f;
      float* const mine = xchg + wg * 16 * 128 + wtid;
      auto add = [&](bool first) {
        fence_regs(sa);
        fence_regs(ss);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          mine[e * 128] = (first ? 0.f : mine[e * 128]) + (sa[e] + ss[e]);
      };
      auto score = [&](bool fresh) {
        const int s = begin();
        const uint32_t sb = base + s * STAGE;
        score_step(sa, ss, fresh, ah, al, gbase + s * STAGE + wg * COL_BOX,
                   sb + 2 * COL_BOX + wg * ROW_BOX,
                   sb + 3 * COL_BOX + wg * ROW_BOX, warp, gq, tq, load);
      };
      int p = 0;
      for (; p + 1 < kp; p += 2) {
        score(true);
        score(false);
        wgmma_wait<0>();
        add(p == 0);
      }
      if (p < kp) {
        score(true);
        wgmma_wait<0>();
        add(p == 0);
      }

      // 2. the full score (the two halves of D added), d-logits, split,
      // into the swizzled K-major tile dl[t & 1]: warpgroup wg writes rows
      // [16 wg, 16 wg + 16) (fragment entries 8 wg .. 8 wg + 7)
      float c_lse[2] = {0.f, 0.f}, c_g[2] = {0.f, 0.f};
      int c_lbl[2] = {-1, -1};
      if (!TOKEN_ROWS) {  // dW: the tokens of this thread's score columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = c0 + 16 * warp + gq + 8 * i;
          if (c < n_cols) {
            c_lse[i] = lse[c] * LOG2E;
            c_g[i] = g[c];
            c_lbl[i] = label_in(labels[c], n_rows);
          }
        }
      }
      __syncthreads();
      const uint32_t dh = dl_s + (t & 1) * 2 * DL, dlo = dh + DL;
      unsigned char* const gdh = gbase + STAGES * STAGE + (t & 1) * 2 * DL;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = 8 * wg + q;
        const float sc =
            mine[e * 128] + xchg[((1 - wg) * 16 + e) * 128 + wtid];
        const int i = (e >> 1) & 1;
        const int cl = 16 * warp + gq + 8 * i;   // column in the tile
        const int rl = 8 * (e >> 2) + 2 * tq + (e & 1);  // row in the block
        const int c = c0 + cl, r = row0 + rl;
        const float l2 = TOKEN_ROWS ? row_lse[rl] : c_lse[i];
        const float gg = TOKEN_ROWS ? row_g[rl] : c_g[i];
        const bool hit = TOKEN_ROWS ? c == row_lbl[rl] : r == c_lbl[i];
        const float ex = exp2f(fmaf(sc, LOG2E, -l2));
        const float v =
            (r < n_rows && c < n_cols) ? (ex - (hit ? 1.f : 0.f)) * gg : 0.f;
        const float vh = tf32_rna(v);
        const uint32_t off = (cl >> 5) * CHUNK_C + swz(rl, cl & 31);
        *reinterpret_cast<float*>(gdh + off) = vh;
        *reinterpret_cast<float*>(gdh + DL + off) = tf32_rna(v - vh);
      }
      fence_proxy_async();
      __syncthreads();

      // 3. out^T[d, r] += b^T[d, c] . dl^T[c, r]: step k gives warpgroup
      // wg output columns slab + 128 k + 64 wg + [0, 64), a new pair of
      // accumulators ((b0, m0) on even steps, (b1, m1) on odd) added into
      // o[k] once complete
      float b0[16], m0[16], b1[16], m1[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) b0[e] = m0[e] = b1[e] = m1[e] = 0.f;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const int s = begin();
        const unsigned char* box =
            gbase + s * STAGE + (2 * wg + (warp >> 1)) * COL_BOX;
        if (k & 1)
          prod_step(b1, m1, b0, m0, o[k - 1], true, ah, al, box, dh, dlo,
                    warp, gq, tq, load);
        else
          prod_step(b0, m0, b1, m1, o[k > 0 ? k - 1 : 0], k > 0, ah, al,
                    box, dh, dlo, warp, gq, tq, load);
      }
      wgmma_wait<0>();
      if (MT & 1)
        merge(o[MT - 1], b0, m0);
      else
        merge(o[MT - 1], b1, m1);
    }

    // 4. the slab's outputs, stored once (un-permuted, un-transposed)
    float* const dst = out + (size_t)chunk * n_rows * d;
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = row0 + 8 * (e >> 2) + 2 * tq + (e & 1);
        const int dd = sl * SLAB + 128 * k + 64 * wg +
                       prod_col(warp, gq, (e >> 1) & 1);
        if (r < n_rows && dd < d) dst[(size_t)r * d + dd] = o[k][e];
      }
  }
}

// hi and lo [n] of a [n] (n4 = n / 4), as the score's B operand.
template <bool TOKEN_ROWS>
__global__ void bwd_f32_split_kernel(const float4* __restrict__ a,
                                     float4* __restrict__ hi,
                                     float4* __restrict__ lo, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = a[i];
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                 tf32_rna(v.w));
    hi[i] = h;
    lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                        tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
  }
}

// out = sum over the n_chunks fp32 partials ([n_chunks, total]), in order.
template <bool TOKEN_ROWS>
__global__ void bwd_f32_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out,
                                      long long total, int n_chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < n_chunks; ++c) sum += part[(size_t)c * total + i];
    out[i] = sum;
  }
}

int grid_for(long long work) {
  const long long want = (work + 255) / 256;
  return static_cast<int>(want < 4096 ? want : 4096);
}

template <bool TOKEN_ROWS>
int launch(const CUtensorMap& map_b, const CUtensorMap& map_hi,
           const CUtensorMap& map_lo, const float* a, float* hi, float* lo,
           const long long* labels, const float* g, const float* lse,
           float* part, float* out, int n_rows, int n_cols, int d,
           int tiles_per_chunk, int n_chunks, cudaStream_t s) {
  const long long n4 = (long long)n_rows * d / 4;
  bwd_f32_split_kernel<TOKEN_ROWS><<<grid_for(n4), 256, 0, s>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  auto kernel = bwd_f32_sm90_kernel<TOKEN_ROWS>;
  err = allow_smem(kernel, smem_bytes());
  if (err) return err;
  const dim3 grid((n_rows + ROWS - 1) / ROWS, n_chunks);
  kernel<<<grid, THREADS, smem_bytes(), s>>>(
      map_b, map_hi, map_lo, labels, g, lse, n_chunks > 1 ? part : out,
      n_rows, n_cols, d, tiles_per_chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err || n_chunks == 1) return err;
  const long long total = (long long)n_rows * d;
  bwd_f32_reduce_kernel<TOKEN_ROWS><<<grid_for(total), 256, 0, s>>>(
      part, out, total, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Geometry the wrapper and its tests read.
int lmhead_ce_bwd_f32_sm90_rows() { return ROWS; }
int lmhead_ce_bwd_f32_sm90_cols() { return COLS; }
int lmhead_ce_bwd_f32_sm90_slab() { return SLAB; }
int lmhead_ce_bwd_f32_sm90_pad() { return PAD; }

// fp32 backward: token_rows = 1 computes dx (a = x [n_rows = N, d], b = W
// [n_cols = V, d]); token_rows = 0 computes dW (a = W, b = x). scratch:
// [2, n_rows, d] fp32 (a's hi and lo); out [n_rows, d] fp32;
// part: [n_chunks, n_rows, d] fp32 scratch when n_chunks > 1, else NULL.
// Chunk s covers column tiles [s * tiles_per_chunk, (s + 1) *
// tiles_per_chunk) of lmhead_ce_bwd_f32_sm90_cols(), and no chunk may
// start at or past n_cols. Returns a CUDA error, or -1 (d not a multiple
// of lmhead_ce_bwd_f32_sm90_pad(), an empty size, a bad split), -2 (no
// cuTensorMapEncodeTiled), -3 (a tensor map refused: a pointer not 16-byte
// aligned).
int lmhead_ce_bwd_f32_sm90(const void* a, const void* b, const void* labels,
                           const void* g, const void* lse, void* scratch,
                           void* part, void* out, int n_rows, int n_cols,
                           int d, int tiles_per_chunk, int n_chunks,
                           int token_rows, void* stream) {
  if (d <= 0 || d % PAD || n_rows <= 0 || n_cols <= 0 ||
      tiles_per_chunk <= 0 || n_chunks <= 0 ||
      (long long)(n_chunks - 1) * tiles_per_chunk * COLS >= n_cols ||
      (n_chunks > 1) != (part != nullptr))
    return -1;
  if (encoder() == nullptr) return -2;
  float* hi = static_cast<float*>(scratch);
  float* lo = hi + (size_t)n_rows * d;
  CUtensorMap map_b, map_hi, map_lo;
  if (!make_map_2d(&map_b, b, n_cols, d, COLS, true) ||
      !make_map_2d(&map_hi, hi, n_rows, d, ROWS, true) ||
      !make_map_2d(&map_lo, lo, n_rows, d, ROWS, true))
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const long long* lbl = static_cast<const long long*>(labels);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(lse);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  return token_rows
             ? launch<true>(map_b, map_hi, map_lo, ap, hi, lo, lbl, gp, lp,
                            pp, op, n_rows, n_cols, d, tiles_per_chunk,
                            n_chunks, s)
             : launch<false>(map_b, map_hi, map_lo, ap, hi, lo, lbl, gp, lp,
                             pp, op, n_rows, n_cols, d, tiles_per_chunk,
                             n_chunks, s);
}

}  // extern "C"
