// What the fp32 flash backward kernels at head_dim 256 in split TF32 share
// (flash_attention_dkv_f32_d256_sm90.cu, flash_attention_dq_f32_d256_sm90.cu):
// a block of two warpgroups on one resident 64-row tile (keys for dk/dv,
// query rows for dq) kept raw in shared memory, warpgroup w owning the
// 32-column boxes [4 w, 4 w + 4) of D; 16-row stage tiles of the other
// side (query rows for dk/dv, keys for dq) split in place into tf32 hi
// and lo; the partial 64 x 16 score tiles traded between the warpgroups;
// the split P or dS tile the accumulating products take as B; the
// transposed A fragments gathered from a split stage tile; and the flush
// of a group's fp32 accumulators into the output through TMA.

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
// waited for): bh the box of the stage tile's hi (its lo one stage tile
// further); per slice lo . hi, hi . lo, hi . hi; slice 0 starts the chain.
__device__ __forceinline__ void half_chain(float (&c)[8], const Half& f,
                                           uint32_t bh, int kd0) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int kd = kd0 + k;
    const uint64_t dh = desc(bh + 32 * kd), dl = desc(bh + ST_T + 32 * kd);
    const uint32_t* h = f.hi[k];
    const uint32_t* l = f.lo[k];
    wgmma_n16_tf32_rs(c, l[0], l[1], l[2], l[3], dh, kd != 0);
    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dl, 1);
    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dh, 1);
  }
}

// The two partial 64 x 16 score tiles over the warpgroup's boxes box0 ..
// box0 + 3: s = A B^T (A from the resident tile ra, B the stage tile at
// sa), then dp the same from rb and sb; one chain a box, ((c0 + c1) + (c2
// + c3)) in fp32. Chain n is product n / 4's chain over box box0 + n % 4,
// in arrays of its own (a chain issued into arrays an earlier one had
// filled and the code had read gave wrong sums on the card, and so did
// these chains while the two products ran as two calls of one function).
// Each chain runs as two groups of two slices (6 wgmma), each waited for
// before the next group's fragments are split (half a box's fragments, 16
// registers: dk/dv's accumulators leave no room for more; splitting one
// group's fragments while the group before it ran, in two buffers, made
// neither kernel faster). A chain is added in once waited for.
__device__ __forceinline__ void scores(float (&s)[8], float (&dp)[8],
                                       const unsigned char* ra, uint32_t sa,
                                       const unsigned char* rb, uint32_t sb,
                                       int box0, int warp, int lane) {
  float c[8][8];
  Half f;
  // fold chain n, waited for: the product's first two boxes summed in its
  // first chain's arrays, the third kept, the fourth completing s or dp
  auto fold = [&](int n) {
    fence_regs(c[n]);
    float(&x)[8] = n < 4 ? s : dp;
    const int first = n & 4;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if ((n & 3) == 1) c[first][e] += c[n][e];
      if ((n & 3) == 3) x[e] = c[first][e] + (c[n - 1][e] + c[n][e]);
    }
  };
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = i >> 1, kd0 = 2 * (i & 1);
    const unsigned char* const res = n < 4 ? ra : rb;
    const uint32_t st = n < 4 ? sa : sb;
    const int box = box0 + (n & 3);
    if (i >= 1) {
      // step i - 1, the last to read f, is done; fold its chain if it was
      // the chain's second group
      wgmma_wait<0>();
      if (!(i & 1)) fold((i - 2) >> 1);
    }
    half_frags(f, res + box * RES_BOX, kd0, warp, lane);
    wgmma_fence();
    half_chain(c[n], f, st + box * ST_BOX, kd0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fold(7);
}

// The warpgroup's boxes box0 .. box0 + 3 of a stage tile at `tile` split
// by its thread t: hi in place, lo at the same offset one stage tile on.
__device__ __forceinline__ void split_stage(unsigned char* tile, int box0,
                                            int t) {
  unsigned char* const own = tile + box0 * ST_BOX;
#pragma unroll
  for (int i = 0; i < OWN * ST_BOX / 16 / 128; ++i) {
    const int f = t + 128 * i;
    split4(own + 16 * f, own + ST_T + 16 * f);
  }
}

// The thread's 8 values of a 64 x 16 fp32 tile fragment in a traded slot
// (float4 i of thread t at float4 128 i + t), and the other's added.
__device__ __forceinline__ void put(float* part, int t, const float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    reinterpret_cast<float4*>(part)[128 * i + t] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
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
// `tile` (hi; lo one stage tile on): for the warpgroup's m-block mb
// (columns 128 wg + 64 mb .. of D as rows of A) and 8-row slice ks of the
// stage (as A's depth), the fragment's (m r, k t), (r + 8, t), (r, t + 4),
// (r + 8, t + 4), r = 16 warp + lane / 4, t = lane % 4.
struct TFrag {
  uint32_t hi[2][2][4], lo[2][2][4];
};

__device__ __forceinline__ void gather_t(TFrag& f, const unsigned char* tile,
                                         int wg, int warp, int lane) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
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
            *reinterpret_cast<const uint32_t*>(tile + ST_T + o);
      }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      fence_a(f.hi[mb][ks]);
      fence_a(f.lo[mb][ks]);
    }
}

// acc[mb] (64 columns of D x 64 rows of the B tile) += A^T . B over the 16
// stage rows, issued: A from gather_t, B the split tile at `x` (hi in its
// columns 0 .. 15, lo in 16 .. 31); per slice lo . hi, hi . lo, hi . hi.
__device__ __forceinline__ void acc_wgmma(float (&acc)[2][32], const TFrag& f,
                                          uint32_t x) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
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

__device__ __forceinline__ void fence_acc(float (&a)[2][32]) {
  fence_regs(a[0]);
  fence_regs(a[1]);
}

__device__ __forceinline__ void zero_acc(float (&a)[2][32]) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) a[mb][e] = 0.f;
}

// A group's sums, times mul, into the 64-row tile at `tile` (the output's
// eight 32-column boxes of 64 rows, TMA's swizzle): acc[mb][4 jj + 2 i +
// c] is column 128 wg + 64 mb + 16 warp + lane / 4 + 8 i of D and row 8 jj
// + 2 (lane % 4) + c of the block's tile.
__device__ __forceinline__ void stage_out(const float (&acc)[2][32],
                                          unsigned char* tile, float mul,
                                          int wg, int warp, int lane) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      const int col =
          128 * wg + 64 * mb + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      *reinterpret_cast<float*>(tile + (col >> 5) * RES_BOX +
                                swz(row, col & 31)) = acc[mb][e] * mul;
    }
}

// Thread 0's part of a flush: the staged tile (eight boxes from `src`) at
// rows r0 .. of the (b, h) whose coordinates are (c0 + 32 box, r0, c2)
// stored (the first group) or added, in fp32, to what earlier groups left
// there (TMA's reduction in L2). Every earlier bulk operation of the block
// is complete first, so each element's sums are added in the groups'
// order; the shared memory is free again on return.
__device__ __forceinline__ void flush_out(const CUtensorMap* map,
                                          uint32_t src, int c0, int r0,
                                          int c2, bool first) {
  bulk_wait<0>();
#pragma unroll
  for (int cb = 0; cb < BOXES; ++cb) {
    if (first)
      tma_store_3d(map, src + cb * RES_BOX, c0 + 32 * cb, r0, c2);
    else
      tma_reduce_add_3d(map, src + cb * RES_BOX, c0 + 32 * cb, r0, c2);
  }
  bulk_commit();
  bulk_wait_read<0>();
}

}  // namespace f32bwd
