// Fused Adam(W) update, one pass in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_adam.py: _kernel (run
// through pl.pallas_call by fused_adam). For every element, exactly as
// fused_adam.py:30-40:
//     m = b1 * m + (1 - b1) * g
//     v = b2 * v + (1 - b2) * g * g
//     denom = sqrt(v) / sqrt(1 - b2p) + eps
//     step = lr * (m / denom) / (1 - b1p)   (+ lr * wd * p for AdamW)
//     p = p - step, cast to p's dtype
// with p in bf16 or fp32, g in p's dtype or (bf16 p) in fp32, m and v in
// fp32, all arithmetic in fp32. An fp32 g beside a bf16 p is what a
// global-norm clip hands over: it scales each bf16 gradient by an fp32
// factor, and the product is fp32 (the JAX package's promotion), which
// the TPU kernel reads as it is.
// lr, b1p and b2p are read from device memory (the learning rate arrives
// as a device feed each step and the beta powers are device state), so a
// step makes no host read per parameter.
//
// Bound on this card (H100 SXM): bytes. Each element reads p, g, m, v and
// writes p, m, v: 22 bytes in bf16 (2+2+4+4 read, 2+4+4 written), 28 in
// fp32, against about 15 FLOPs, far below the card's 295 FLOPs per byte.
// At the training shape (gpt.wte, 32768 x 768 bf16) that is 553.6 MB, at
// least 0.165 ms at 3.35 TB/s.
//
// Design. The TPU kernel walks (rows, cols) VMEM blocks, and its
// dispatch rule keeps 1-D and unaligned params on the jnp path for the
// TPU's (8, 128) tiling. A CUDA elementwise pass has no tiling to respect:
// every floating param of any shape goes through this kernel, viewed as a
// flat array. A grid-stride loop over elements, with 16-byte vectors
// where the pointers and the count allow (4 elements per thread step; a
// scalar tail and an all-scalar path otherwise), keeps each load and
// store a full coalesced sector; the grid is a few waves of 256-thread
// blocks on the 132 SMs. In place: p, m and v are written where they were
// read, so the update allocates nothing.
//
// Plain C interface, loaded with ctypes: the entry point launches one
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Coef {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2 (host double)
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float lr, float bc1,
                                         float bc2, const Coef& k) {
  m = k.b1 * m + k.c1 * g;
  v = k.b2 * v + k.c2 * g * g;
  const float denom = sqrtf(v) / bc2 + k.eps;
  float step = lr * (m / denom) / bc1;
  if (k.wd != 0.f) step = step + lr * k.wd * p;
  p = p - step;
}

template <typename T, typename G>
__global__ void __launch_bounds__(THREADS)
adam_kernel(T* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ lr_ptr,
            const float* __restrict__ b1p_ptr,
            const float* __restrict__ b2p_ptr, long long n, Coef k,
            int vec4) {
  const float lr = *lr_ptr;
  const float bc1 = 1.f - *b1p_ptr;
  const float bc2 = sqrtf(1.f - *b2p_ptr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    // 4 elements per step: m and v as float4, p and g four at a time
    const long long n4 = n / 4;
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (long long q = i0; q < n4; q += stride) {
      float4 mm = m4[q], vv = v4[q];
      float pe[4], ge[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = load(p, 4 * q + e);
        ge[e] = load(g, 4 * q + e);
      }
      adam_one(pe[0], ge[0], mm.x, vv.x, lr, bc1, bc2, k);
      adam_one(pe[1], ge[1], mm.y, vv.y, lr, bc1, bc2, k);
      adam_one(pe[2], ge[2], mm.z, vv.z, lr, bc1, bc2, k);
      adam_one(pe[3], ge[3], mm.w, vv.w, lr, bc1, bc2, k);
      m4[q] = mm;
      v4[q] = vv;
#pragma unroll
      for (int e = 0; e < 4; ++e) put(p, 4 * q + e, pe[e]);
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float pe = load(p, i), mm = m[i], vv = v[i];
    adam_one(pe, load(g, i), mm, vv, lr, bc1, bc2, k);
    m[i] = mm;
    v[i] = vv;
    put(p, i, pe);
  }
}

}  // namespace

extern "C" {

// One Adam(W) step over n elements, in place on p, m and v. p is bf16
// (is_bf16 bit 0) or fp32; g is bf16 (bit 1) or fp32: both bits, p and g
// bf16; bit 0 alone, a bf16 p with an fp32 g; neither, both fp32. m and
// v fp32; lr, b1p and b2p point to one fp32 each on the device. wd = 0
// is Adam, wd > 0 AdamW. c1 = 1 - b1 and c2 = 1 - b2 come from the host,
// computed in double.
int fused_adam_step(void* p, const void* g, void* m, void* v, const void* lr,
                    const void* b1p, const void* b2p, long long n, float b1,
                    float c1, float b2, float c2, float eps, float wd,
                    int is_bf16, int sms, void* stream) {
  if (n <= 0) return 0;
  const Coef k{b1, c1, b2, c2, eps, wd};
  const bool p_bf16 = is_bf16 & 1, g_bf16 = (is_bf16 >> 1) & 1;
  if (g_bf16 && !p_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 =
      (reinterpret_cast<size_t>(m) % 16 == 0) &&
      (reinterpret_cast<size_t>(v) % 16 == 0) &&
      (reinterpret_cast<size_t>(p) % (4 * (p_bf16 ? 2 : 4)) == 0) &&
      (reinterpret_cast<size_t>(g) % (4 * (g_bf16 ? 2 : 4)) == 0);
  const long long work = vec4 ? (n + 3) / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lr_f = static_cast<const float*>(lr);
  const float* b1p_f = static_cast<const float*>(b1p);
  const float* b2p_f = static_cast<const float*>(b2p);
  if (p_bf16 && g_bf16) {
    adam_kernel<<<(int)blocks, THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g),
        static_cast<float*>(m), static_cast<float*>(v), lr_f, b1p_f, b2p_f, n,
        k, vec4);
  } else if (p_bf16) {
    adam_kernel<<<(int)blocks, THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v), lr_f, b1p_f, b2p_f, n,
        k, vec4);
  } else {
    adam_kernel<<<(int)blocks, THREADS, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v), lr_f, b1p_f, b2p_f, n,
        k, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
