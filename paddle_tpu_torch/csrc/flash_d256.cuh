// What the flash kernels at head_dim 256 that split D between two
// warpgroups share (the bf16 backward's flash_attention_dq_d256_sm90.cu
// and flash_attention_dkv_d256_sm90.cu, the fp32 forward's
// flash_attention_fwd_f32_d256_sm90.cu): a block of two warpgroups on one
// 64-row tile (query rows for dq and the forward, keys for dk/dv),
// warpgroup w owning 128 columns of D; 32-row tiles of the other side
// (keys for dq and the forward, query rows for dk/dv); the partial 64 x 32
// score tiles each warpgroup sums over its columns, traded through shared
// memory; and the rank-3 tensor maps (bf16) of ops/flash_attention.py's
// tma_geometry.

#pragma once

#include "sm90.cuh"

namespace d256 {

using namespace sm90;

constexpr int D = 256;
constexpr int HALVES = D / 64;   // 64-column swizzle atoms of a row
constexpr int NT = 32;           // rows of a ring stage's tile
constexpr int KS = NT / 16;      // k16 slices of a ring tile
constexpr int WGS = 2;           // warpgroups, 128 columns of D each
constexpr int THREADS = 128 * WGS;
constexpr int STAGES = 3;
constexpr int T_BOX = NT * 128;  // a 64-column atom of a ring tile
constexpr int PART = 64 * NT;    // floats of a traded partial score tile
constexpr float NEG = -1e30f;  // the forward's lse of a row that sees no key
constexpr float FAR = 1e30f;   // lse of a row that takes no part: P = 0

// One operand's addressing, as flash_attention_fwd_sm90.cu's: element
// (b, t, h, c) at tensor-map coordinates (h * head_col + c, t, b * outer_b
// + h * outer_h) and at element offset coordinate0 + t * st_seq +
// coordinate2 * st_outer.
struct Geo {
  long long st_seq, st_outer;
  int head_col, outer_b, outer_h;
};

// d = A . B^T over two k16 steps (k0 and k0 + 1) of one 64-column atom of
// D, issued (not waited for): A's 64 rows at a_addr, B's NT rows at
// b_addr, both K-major
__device__ __forceinline__ void ss_chain(float (&d)[NT / 2], uint32_t a_addr,
                                         uint32_t b_addr, int k0) {
#pragma unroll
  for (int kk = k0; kk < k0 + 2; ++kk)
    wgmma_n32(d, desc(a_addr + 32 * kk), desc(b_addr + 32 * kk), kk != k0);
}

// acc += A . B, issued: A's KS k16 slices in registers, B the ring tile's
// rows at b_addr (the warpgroup's first atom), MN-major, 16 rows a slice,
// one 64-column atom after the other
__device__ __forceinline__ void rs_wgmma(float (&acc)[2][32],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64_rs(acc[hh], a[kk], desc(b_addr + hh * T_BOX + kk * 16 * 128));
}

// s rounded to bf16, packed as wgmma's A: slice kk is s[8 kk .. 8 kk + 8)
__device__ __forceinline__ void pack(uint32_t (&a)[KS][4],
                                     const float (&s)[NT / 2]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

__device__ __forceinline__ void fence2(float (&a)[NT / 2],
                                       float (&b)[NT / 2]) {
  fence_regs(a);
  fence_regs(b);
}

// x = a + b (fresh, or x += a + b), elementwise in fp32
__device__ __forceinline__ void add2(float (&x)[NT / 2], const float (&a)[NT / 2],
                                     const float (&b)[NT / 2], bool fresh) {
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) x[e] = fresh ? a[e] + b[e] : x[e] + (a[e] + b[e]);
}

__device__ __forceinline__ void fence_acc(float (&a)[2][32]) {
  fence_regs(a[0]);
  fence_regs(a[1]);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The thread's NT / 2 values of a 64 x NT fp32 tile fragment in a traded
// slot: float4 i of thread t at float4 128 i + t, so a warp's accesses are
// contiguous
__device__ __forceinline__ void put(float* part, int t,
                                    const float (&x)[NT / 2]) {
#pragma unroll
  for (int i = 0; i < NT / 8; ++i)
    reinterpret_cast<float4*>(part)[128 * i + t] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

__device__ __forceinline__ void add_from(const float* part, int t,
                                         float (&x)[NT / 2]) {
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const float4 y = reinterpret_cast<const float4*>(part)[128 * i + t];
    x[4 * i] += y.x;
    x[4 * i + 1] += y.y;
    x[4 * i + 2] += y.z;
    x[4 * i + 3] += y.w;
  }
}

// Tensor map of one operand: geo = {inner, outer, st_seq, st_outer, ...}
// in elements; boxes of 64 columns x rows x 1.
inline bool make_map_3d(CUtensorMap* map, const void* ptr,
                        const long long* geo, int seq, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(geo[0]),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(geo[1])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(geo[2]) * 2,
                                 static_cast<cuuint64_t>(geo[3]) * 2};
  return make_map(map, ptr, 3, dims, strides, rows);
}

inline Geo geo_of(const long long* geo) {
  return Geo{geo[2], geo[3], static_cast<int>(geo[4]),
             static_cast<int>(geo[5]), static_cast<int>(geo[6])};
}

}  // namespace d256
