// What the fp32 flash forwards in split TF32 share
// (flash_attention_fwd_f32_sm90.cu at head_dim 64 and 128,
// flash_attention_fwd_f32_d256_sm90.cu at 256): the split of an operand
// into tf32 hi and lo, the 128-byte swizzle of a fp32 box, V^T's permuted
// keys, the online softmax of a score tile and P's split as wgmma's A.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace flash_f32 {

using namespace sm90;

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float4 tf32_rna4(float4 a) {
  return make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z),
                     tf32_rna(a.w));
}

// The 4 fp32 values at hi split in place: hi := tf32_rna(a), and lo :=
// tf32_rna(a - hi) (a - hi is exact in fp32).
__device__ __forceinline__ void split4(unsigned char* hi, unsigned char* lo) {
  float4* const h4 = reinterpret_cast<float4*>(hi);
  const float4 a = *h4;
  const float4 h = tf32_rna4(a);
  *reinterpret_cast<float4*>(lo) =
      tf32_rna4(make_float4(a.x - h.x, a.y - h.y, a.z - h.z, a.w - h.w));
  *h4 = h;
}

// Byte offset of fp32 (row, col < 32) in a box of 128-byte rows written
// with TMA's 128-byte swizzle: 16-byte chunk col / 4 XOR row % 8.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// The place of key `key` in its tile's V^T: within each 8-key group, key
// 2t sits at t and key 2t + 1 at t + 4 (what the P fragments hand the
// tensor cores).
__device__ __forceinline__ int vt_key(int key) {
  return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
}

// The online softmax of one 64 x 8 NJ score tile (keys c0 ..), in place,
// as flash_attention_fwd_sm90.cu's: s becomes P = exp2(s * scale_log2 -
// m), masked entries 0; m and l of the thread's two rows (r, r + 8) move
// on, and alpha = exp2(m_old - m_new) is what o must be rescaled by.
// masked: the tile crosses the causal diagonal or the end of the keys. p
// holds tk, causal and scale_log2 (scale * log2(e)).
template <int NJ, typename Params>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * NJ],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked,
                                             int c0, int r, int c_in,
                                             const Params& p, int off) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
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
    for (int e = 0; e < 4 * NJ; ++e) s[e] *= p.scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float tmax = -1e30f;  // the online softmax's start, a finite -inf
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      tmax = fmaxf(tmax, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m[i], tmax);
    alpha[i] = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
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

// P's hi and lo as wgmma's A, slice jj in registers 4 jj .. 4 jj + 3: (row
// r, key 2t), (r + 8, 2t), (r, 2t + 1), (r + 8, 2t + 1) -- the fragment's
// (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4) under V^T's permutation.
template <int NJ>
__device__ __forceinline__ void split_p(uint32_t (&ph)[4 * NJ],
                                        uint32_t (&pl)[4 * NJ],
                                        const float (&s)[4 * NJ]) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float e = s[4 * jj + ((x & 1) << 1) + (x >> 1)];
      const float h = tf32_rna(e);
      ph[4 * jj + x] = __float_as_uint(h);
      pl[4 * jj + x] = __float_as_uint(tf32_rna(e - h));
    }
}

// Tensor map of one fp32 operand: geo = {inner, outer, st_seq, st_outer,
// ...} in elements; boxes of 32 columns x rows x 1.
inline bool make_map_3d(CUtensorMap* map, const void* ptr,
                        const long long* geo, int seq, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(geo[0]),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(geo[1])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(geo[2]) * 4,
                                 static_cast<cuuint64_t>(geo[3]) * 4};
  return make_map(map, ptr, 3, dims, strides, rows, true);
}

}  // namespace flash_f32
