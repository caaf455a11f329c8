// What the fp32 flash backward kernels in split TF32 share
// (flash_attention_dkv_f32_d256_sm90.cu, flash_attention_dq_f32_d256_sm90.cu
// at head_dim 256; flash_attention_dkv_f32_sm90.cu and
// flash_attention_dq_f32_sm90.cu at 64 and 128): resident
// 64-row tiles (keys for dk/dv, query rows for dq) kept raw in shared
// memory and split into registers a box at a time; 16-row stage tiles of
// the other side (query rows for dk/dv, keys for dq) split in place into
// tf32 hi and lo; the score chains over 32-column boxes of D; the split P
// or dS tile the accumulating products take as B; the transposed A
// fragments gathered from a split stage tile; the exponentials of a dk/dv
// tile and of a dq tile; and the flush of a group's fp32 accumulators into the output
// through TMA. A block's two warpgroups share one resident tile. The
// defaults of the templates are head_dim 256's, where warpgroup w owns
// the 32-column boxes [4 w, 4 w + 4) of D and the two trade their partial
// 64 x 16 score tiles; at 64 and 128 each runs its own products over all
// of D (dk/dv: S^T, P and dV^T; dP^T, dS and dK^T. dq: S, dP, dS and dQ^T
// for 64 query rows of its own).

#pragma once

#include "flash_d256.cuh"
#include "flash_f32.cuh"

namespace f32bwd {

using namespace flash_f32;
using d256::bar_sync;
using d256::Geo;

constexpr int D = d256::D;
constexpr int WGS = d256::WGS;
constexpr int THREADS = d256::THREADS;
constexpr int RES = 64;                // rows of the resident tile
constexpr int NS = 16;                 // rows of a stage tile
constexpr int KD = 4;                  // 8-deep slices of a 32-column box
constexpr int BOXES = D / 32;          // 32-column boxes of a row
constexpr int OWN = BOXES / WGS;       // boxes a warpgroup owns
constexpr int RES_BOX = RES * 128;     // a box of the resident tile
constexpr int ST_BOX = NS * 128;       // a box of a stage tile
constexpr int RES_T = BOXES * RES_BOX; // a resident tile: 64 KB
constexpr int ST_T = BOXES * ST_BOX;   // a stage tile (hi or lo): 16 KB
constexpr int X_T = RES * 128;         // a split 64 x 16 B tile, hi | lo
constexpr int PART = RES * NS;         // floats of a traded partial tile
constexpr int FLUSH = 8;               // stage tiles a group accumulates
constexpr float NEG = d256::NEG;
constexpr float FAR = d256::FAR;

// Half a 32-column box of the resident tile (two 8-deep slices) split as
// wgmma's A: slice kd0 + k in [k][0 .. 3], the fragment's (row r, column
// t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of the box's columns 8 (kd0 +
// k) ..
struct Half {
  uint32_t hi[2][4], lo[2][4];
};

// The warpgroup thread (warp, lane)'s fragments of slices kd0, kd0 + 1 of
// raw box `box` (64 rows of 128 bytes, TMA's swizzle), split.
__device__ __forceinline__ void half_frags(Half& f, const unsigned char* box,
                                           int kd0, int warp, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = 16 * warp + (lane >> 2) + 8 * (x & 1);
      const int col = 8 * (kd0 + k) + (lane & 3) + 4 * (x >> 1);
      const float a = *reinterpret_cast<const float*>(box + swz(row, col));
      const float h = tf32_rna(a);
      f.hi[k][x] = __float_as_uint(h);
      f.lo[k][x] = __float_as_uint(tf32_rna(a - h));
    }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    fence_a(f.hi[k]);
    fence_a(f.lo[k]);
  }
}

// c (+)= A B^T over slices kd0, kd0 + 1 of one 32-column box, issued (not
// waited for): bh the box of the stage tile's hi (its lo LO bytes, one
// stage tile, further); per slice lo . hi, hi . lo, hi . hi; slice 0
// starts the chain.
template <int LO = ST_T>
__device__ __forceinline__ void half_chain(float (&c)[8], const Half& f,
                                           uint32_t bh, int kd0) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int kd = kd0 + k;
    const uint64_t dh = desc(bh + 32 * kd), dl = desc(bh + LO + 32 * kd);
    const uint32_t* h = f.hi[k];
    const uint32_t* l = f.lo[k];
    wgmma_n16_tf32_rs(c, l[0], l[1], l[2], l[3], dh, kd != 0);
    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dl, 1);
    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dh, 1);
  }
}

// The two (partial, at head_dim 256) 64 x 16 score tiles over the BX
// boxes box0 .. box0 + BX - 1: s = A B^T (A from the resident tile ra, B
// the stage tile at sa, its lo LO bytes on), then (NP 2) dp the same from
// rb and sb; one chain a box, added in fp32 as ((c0 + c1) + (c2 + c3)) (BX
// 4) or c0 + c1 (BX 2). Chain n is product n / BX's chain over box box0 +
// n % BX, in arrays of its own (a chain issued into arrays an earlier one had
// filled and the code had read gave wrong sums on the card, and so did
// these chains while the two products ran as two calls of one function).
// Each chain runs as two groups of two slices (6 wgmma), each waited for
// before the next group's fragments are split (half a box's fragments, 16
// registers: dk/dv's accumulators leave no room for more; splitting one
// group's fragments while the group before it ran, in two buffers, made
// neither kernel faster). A chain is added in once waited for.
template <int BX = OWN, int LO = ST_T, int NP = 2>
__device__ __forceinline__ void scores(float (&s)[8], float (&dp)[8],
                                       const unsigned char* ra, uint32_t sa,
                                       const unsigned char* rb, uint32_t sb,
                                       int box0, int warp, int lane) {
  static_assert(BX == 2 || BX == 4, "chains of a product");
  static_assert(NP == 1 || NP == 2, "products");
  float c[NP * BX][8];
  Half f;
  // fold chain n, waited for: at BX 4 the product's first two boxes summed
  // in its first chain's arrays, the third kept, the fourth completing s
  // or dp; at BX 2 the second completing it
  auto fold = [&](int n) {
    fence_regs(c[n]);
    float(&x)[8] = n < BX ? s : dp;
    const int first = n & ~(BX - 1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (BX == 4 && (n & 3) == 1) c[first][e] += c[n][e];
      if (BX == 4 && (n & 3) == 3)
        x[e] = c[first][e] + (c[n - 1][e] + c[n][e]);
      if (BX == 2 && (n & 1) == 1) x[e] = c[first][e] + c[n][e];
    }
  };
#pragma unroll
  for (int i = 0; i < 2 * NP * BX; ++i) {
    const int n = i >> 1, kd0 = 2 * (i & 1);
    const unsigned char* const res = n < BX ? ra : rb;
    const uint32_t st = n < BX ? sa : sb;
    const int box = box0 + n % BX;
    if (i >= 1) {
      // step i - 1, the last to read f, is done; fold its chain if it was
      // the chain's second group
      wgmma_wait<0>();
      if (!(i & 1)) fold(n - 1);
    }
    half_frags(f, res + box * RES_BOX, kd0, warp, lane);
    wgmma_fence();
    half_chain<LO>(c[n], f, st + box * ST_BOX, kd0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fold(NP * BX - 1);
}

// The NB boxes box0 .. box0 + NB - 1 of a stage tile at `tile` split by
// warpgroup thread t: hi in place, lo at the same offset LO bytes (one
// stage tile) on.
template <int NB = OWN, int LO = ST_T>
__device__ __forceinline__ void split_stage(unsigned char* tile, int box0,
                                            int t) {
  unsigned char* const own = tile + box0 * ST_BOX;
#pragma unroll
  for (int i = 0; i < NB * ST_BOX / 16 / 128; ++i) {
    const int f = t + 128 * i;
    split4(own + 16 * f, own + LO + 16 * f);
  }
}

// The thread's 8 values of a 64 x 16 fp32 tile fragment in a traded slot
// (float4 i of thread t at float4 128 i + t); read back, or added.
__device__ __forceinline__ void put(float* part, int t, const float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    reinterpret_cast<float4*>(part)[128 * i + t] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

__device__ __forceinline__ void take(const float* part, int t,
                                     float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 y = reinterpret_cast<const float4*>(part)[128 * i + t];
    x[4 * i] = y.x;
    x[4 * i + 1] = y.y;
    x[4 * i + 2] = y.z;
    x[4 * i + 3] = y.w;
  }
}

__device__ __forceinline__ void add_from(const float* part, int t,
                                         float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 y = reinterpret_cast<const float4*>(part)[128 * i + t];
    x[4 * i] += y.x;
    x[4 * i + 1] += y.y;
    x[4 * i + 2] += y.z;
    x[4 * i + 3] += y.w;
  }
}

// dk/dv: lse and delta of the thread's query rows q0 + 8 jj + c_in + c at
// [2 jj + c]; a row past Tq or with lse -1e30 takes no part (+1e30, so P =
// 0), and a row past Tq has delta 0
template <typename Params>
__device__ __forceinline__ void row_stats(const Params& p, long long row0,
                                          int q0, int c_in, float (&lse)[4],
                                          float (&dl)[4]) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = q0 + 8 * jj + c_in + c;
      const float l = r < p.tq ? p.lse[row0 + r] : NEG;
      lse[2 * jj + c] = l > 0.5f * NEG ? l : FAR;
      dl[2 * jj + c] = r < p.tq ? p.delta[row0 + r] : 0.f;
    }
}

// One 64-key x 16-query tile, in place: s (S^T) becomes P = exp(s * scale
// - lse), fp32. The thread's keys are kr and kr + 8, its queries q0 + 8 jj
// + c_in + {0, 1}; masked: the tile crosses the causal diagonal.
__device__ __forceinline__ void probs_tile(float (&s)[8],
                                           const float (&lse)[4],
                                           bool masked, int q0, int kr,
                                           int c_in, int off, float scale) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * jj + 2 * i + c;
        float x = fmaf(s[e], scale, -lse[2 * jj + c]);
        if (masked && kr + 8 * i > q0 + 8 * jj + c_in + c + off)
          x = -INFINITY;  // expf gives exactly 0
        s[e] = expf(x);
      }
}

// The same tile's dp (dP^T) becomes dS = P * (dP - delta), fp32, from its
// P (pr).
__device__ __forceinline__ void ds_tile(float (&dp)[8], const float (&pr)[8],
                                        const float (&dl)[4]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) dp[e] = pr[e] * (dp[e] - dl[2 * (e >> 2) + (e & 1)]);
}

// Both: s becomes P, dp becomes dS.
__device__ __forceinline__ void dkv_tile(float (&s)[8], float (&dp)[8],
                                         const float (&lse)[4],
                                         const float (&dl)[4], bool masked,
                                         int q0, int kr, int c_in, int off,
                                         float scale) {
  probs_tile(s, lse, masked, q0, kr, c_in, off, scale);
  ds_tile(dp, s, dl);
}

// dq: one 64-row x 16-key tile, in place: dp (dP) becomes dS = P * (dP -
// delta), fp32, with P = exp(s * scale - lse). The thread's rows are r and
// r + 8 (their lse in lse, their delta in dl), its keys k0 + 8 jj + c_in +
// {0, 1}; masked: the tile crosses the causal diagonal or the end of the
// keys. p holds scale, tk and causal.
template <typename Params>
__device__ __forceinline__ void dq_tile(const float (&s)[8], float (&dp)[8],
                                        const float (&lse)[2],
                                        const float (&dl)[2], bool masked,
                                        int k0, int r, int c_in,
                                        const Params& p, int off) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
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

// A 64 x 16 accumulator fragment x (row 16 warp + lane / 4 + 8 i, column
// 8 jj + 2 (lane % 4) + c at x[4 jj + 2 i + c]) split into the B tile at
// `tile`: 64 rows of 128 bytes, hi in columns 0 .. 15, lo in 16 .. 31
// (K-major, TMA's swizzle). Only the rows of i in [i0, i1).
__device__ __forceinline__ void put_split(unsigned char* tile,
                                          const float (&x)[8], int warp,
                                          int lane, int i0, int i1) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < i0 || i >= i1) continue;
    const int row = 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + 2 * (lane & 3) + c;
        const float e = x[4 * jj + 2 * i + c];
        const float h = tf32_rna(e);
        *reinterpret_cast<float*>(tile + swz(row, col)) = h;
        *reinterpret_cast<float*>(tile + swz(row, 16 + col)) =
            tf32_rna(e - h);
      }
  }
}

// The transposed A of an accumulating product from a split stage tile at
// `tile` (hi; lo LO bytes, one stage tile, on): for m-block mb of the MB
// the warpgroup owns (columns 128 wg + 64 mb .. of D as rows of A: wg 0
// where a warpgroup owns all of D) and 8-row slice ks of the stage (as
// A's depth), the fragment's (m r, k t), (r + 8, t), (r, t + 4), (r + 8,
// t + 4), r = 16 warp + lane / 4, t = lane % 4.
template <int MB = 2>
struct TFragT {
  uint32_t hi[MB][2][4], lo[MB][2][4];
};
using TFrag = TFragT<2>;

template <int MB, int LO = ST_T>
__device__ __forceinline__ void gather_t(TFragT<MB>& f,
                                         const unsigned char* tile, int wg,
                                         int warp, int lane) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 128 * wg + 64 * mb + 16 * warp + (lane >> 2) +
                        8 * (x & 1);
        const int row = 8 * ks + (lane & 3) + 4 * (x >> 1);
        const uint32_t o = (col >> 5) * ST_BOX + swz(row, col & 31);
        f.hi[mb][ks][x] = *reinterpret_cast<const uint32_t*>(tile + o);
        f.lo[mb][ks][x] =
            *reinterpret_cast<const uint32_t*>(tile + LO + o);
      }
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      fence_a(f.hi[mb][ks]);
      fence_a(f.lo[mb][ks]);
    }
}

// acc[mb] (64 columns of D x 64 rows of the B tile) += A^T . B over the 16
// stage rows, issued: A from gather_t, B the split tile at `x` (hi in its
// columns 0 .. 15, lo in 16 .. 31); per slice lo . hi, hi . lo, hi . hi.
template <int MB>
__device__ __forceinline__ void acc_wgmma(float (&acc)[MB][32],
                                          const TFragT<MB>& f, uint32_t x) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t dh = desc(x + 32 * ks), dl = desc(x + 64 + 32 * ks);
      const uint32_t* h = f.hi[mb][ks];
      const uint32_t* l = f.lo[mb][ks];
      wgmma_n64_tf32_rs(acc[mb], l[0], l[1], l[2], l[3], dh, 1);
      wgmma_n64_tf32_rs(acc[mb], h[0], h[1], h[2], h[3], dl, 1);
      wgmma_n64_tf32_rs(acc[mb], h[0], h[1], h[2], h[3], dh, 1);
    }
}

template <int MB>
__device__ __forceinline__ void fence_acc(float (&a)[MB][32]) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) fence_regs(a[mb]);
}

template <int MB>
__device__ __forceinline__ void zero_acc(float (&a)[MB][32]) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) a[mb][e] = 0.f;
}

// A group's sums, times mul, into the 64-row tile at `tile` (the output's
// 32-column boxes of 64 rows, TMA's swizzle): acc[mb][4 jj + 2 i + c] is
// column 128 wg + 64 mb + 16 warp + lane / 4 + 8 i of D and row 8 jj + 2
// (lane % 4) + c of the tile.
template <int MB>
__device__ __forceinline__ void stage_out(const float (&acc)[MB][32],
                                          unsigned char* tile, float mul,
                                          int wg, int warp, int lane) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      const int col =
          128 * wg + 64 * mb + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      *reinterpret_cast<float*>(tile + (col >> 5) * RES_BOX +
                                swz(row, col & 31)) = acc[mb][e] * mul;
    }
}

// Thread 0's part of a flush: the staged tiles (TILES 64-row tiles of NB
// boxes each, one after the other from `src`; box cb of tile t at the
// coordinates (c0 + 32 cb, r0 + 64 t, c2) of the output) stored (the first
// group) or added, in fp32, to what earlier groups left there (TMA's
// reduction in L2). Every earlier bulk operation of the block is complete
// first, so each element's sums are added in the groups' order; the
// shared memory is free again on return.
template <int NB = BOXES, int TILES = 1>
__device__ __forceinline__ void flush_out(const CUtensorMap* map,
                                          uint32_t src, int c0, int r0,
                                          int c2, bool first) {
  bulk_wait<0>();
#pragma unroll
  for (int cb = 0; cb < NB * TILES; ++cb) {
    const int x = c0 + 32 * (cb % NB), y = r0 + RES * (cb / NB);
    if (first)
      tma_store_3d(map, src + cb * RES_BOX, x, y, c2);
    else
      tma_reduce_add_3d(map, src + cb * RES_BOX, x, y, c2);
  }
  bulk_commit();
  bulk_wait_read<0>();
}

}  // namespace f32bwd
