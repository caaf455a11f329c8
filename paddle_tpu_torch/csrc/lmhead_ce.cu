// Fused lm-head + softmax cross-entropy for Hopper (sm_90a): the combine
// launch of every forward.
//
// Finishes, for both dtypes, the forward TPU kernel of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (run through pl.pallas_call):
//   _stats_kernel (by _stats_call): for each token row n, without writing
//     the [N, V] logits to device memory,
//         lse[n] = logsumexp_v (x[n] . w[v])
//         nll[n] = lse[n] - (x[n] . w[label[n]])   (0 picked if the label
//                                                 lies outside [0, V))
//     Its partial stats (max, sum-exp, picked) per (row tile, vocabulary
//     chunk) come from the tensor cores: bf16 in lmhead_ce_fwd_sm90.cu,
//     fp32 in lmhead_ce_fwd_f32_sm90.cu (split TF32). This file's combine
//     launch merges them. The backward (dx, dW) is lmhead_ce_bwd_sm90.cu
//     (bf16) and lmhead_ce_bwd_f32_sm90.cu (fp32, split TF32).
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes; it reads 3 x chunks x N
// fp32 partials and writes 2 x N fp32, microseconds at the training shapes.
//
// Combine. lmhead_ce_combine: one thread per row merges the S partials
// exactly as the cross-shard combine of fused_lmhead_ce.py:344-348 does:
// mg = max m, l = sum l*exp(m - mg), picked = sum picked; then
// lse = mg + log(l > 0 ? l : 1) and nll = lse - picked.
//
// Plain C interface, loaded with ctypes: the entry point launches one
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;  // finite stand-in for -inf, as on the TPU

__global__ void combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ pk_part,
                               float* __restrict__ nll,
                               float* __restrict__ lse, int n, int n_chunks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float mg = NEG;
  for (int s = 0; s < n_chunks; ++s) mg = fmaxf(mg, m_part[(size_t)s * n + r]);
  float l = 0.f, picked = 0.f;
  for (int s = 0; s < n_chunks; ++s) {
    const size_t at = (size_t)s * n + r;
    l += l_part[at] * expf(m_part[at] - mg);
    picked += pk_part[at];
  }
  const float out = mg + logf(l > 0.f ? l : 1.f);
  lse[r] = out;
  nll[r] = out - picked;
}

}  // namespace

extern "C" {

// Merge the n_chunks partials of each row (of lmhead_ce_fwd_sm90 or
// lmhead_ce_fwd_f32_sm90) into lse and nll ([n] fp32).
int lmhead_ce_combine(const void* m_part, const void* l_part,
                      const void* pk_part, void* nll, void* lse, int n,
                      int n_chunks, void* stream) {
  constexpr int kThreads = 128;
  combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(pk_part), static_cast<float*>(nll),
      static_cast<float*>(lse), n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
