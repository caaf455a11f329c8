// Fused lm-head + softmax cross-entropy backward (dx and dW) in bf16 on
// Hopper's tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces, for bf16 inputs, the two backward TPU kernels of
// paddle_tpu/ops/pallas/fused_lmhead_ce.py (each run through
// pl.pallas_call): _dx_kernel (by _dx_call) and _dw_kernel (by _dw_call).
// From the saved per-row lse and a per-row cotangent g, without an [N, V]
// buffer of logits or of d-logits:
//     dl[n, v] = (exp(x[n] . w[v] - lse[n]) - [v == label[n]]) * g[n],
//                rounded to bf16 (fused_lmhead_ce.py:211, :244)
//     dx = dl . W   (N x D)        dW = dl^T . x   (V x D)
// fp32 sums, each output cast to bf16 once. Labels outside [0, V) hit no
// column. fp32 inputs take lmhead_ce_bwd_f32_sm90.cu (split TF32).
//
// Bound on this card (H100 SXM, bf16 at 989 TFLOP/s, 3.35 TB/s):
// operations. The function needs 4*N*V*D FLOPs (the score tile, then the
// product with the d-logits): at N=4096 (seq 512), D=768, V=32768 that is
// 412.3 GFLOP, 0.417 ms; at N=16384 (seq 2048) 1649.3 GFLOP, 1.667 ms.
// Reading x and W once takes 0.02 and 0.04 ms.
//
// Design. dx and dW are one kernel with the roles of x and W swapped: a
// block owns 64 "rows" (tokens for dx, vocab entries for dW) and sweeps
// 64-wide tiles of "columns" (the other side); out[r] = sum_c dl[r, c] *
// b[c]. What bounds the shape is the register file: a 64 x 768 fp32
// accumulator is 49,152 of the SM's 65,536 registers, so it cannot live in
// one block beside the score tile. So D is split across blocks: block
// (row tile, half) owns 384 output columns, and its two consumer
// warpgroups 192 each (64 x 192 fp32 accumulators, 96 registers a
// thread). Each block builds the full score tile over all of D, so a
// D=768 problem costs 6*N*V*D FLOPs (2 score tiles + 1 product), not 4;
// the alternative that keeps 4 (a cluster of 2 exchanging partial score
// tiles through distributed shared memory every column tile) was not
// taken: it puts a cluster barrier and 4-way partial sums on every tile.
// The score tile is split between the two warpgroups by columns (32
// each), so it is built once per block.
//   - The row tile (64 x D bf16, K-major, 128-byte swizzle) is loaded once
//     by TMA and stays resident: 96 KB at D=768, at most 128 KB (D <= 1024).
//   - One producer thread keeps TMA loads of the column tile in flight
//     through a ring of 4-7 stages of 16 KB, tracked by full/empty
//     mbarriers: a stage holds two 64 x 64 boxes, two adjacent 64-column
//     chunks of D (one box per stage was slower: every stage costs a
//     handshake). Each chunk is loaded once and serves both products:
//     K-major as wgmma's B of the score tile, MN-major (the transpose
//     flag) as B of the second product. The pairs of the block's own 384
//     columns come last in each tile's order, so only they are held until
//     the second product; the rest are released as soon as the score
//     wgmma that read them completes.
//   - Score: wgmma m64n32k16 (A = row tile, B = 32 columns of the column
//     tile), fp32 in registers. d-logits formed in registers from the
//     accumulator fragment, exp as exp2f on scores prescaled by log2(e),
//     rounded to bf16 where the TPU rounds them, and written into an 8 KB
//     swizzled tile (double-buffered) that both warpgroups read as wgmma's
//     A operand: each needs all 64 columns of it.
//   - Second product: wgmma m64n64k16 into the register accumulators, one
//     per 64-column chunk of the warpgroup's 192.
//   - Grid: (row tiles, D halves): dx at N=4096 has 64 x 2 = 128 blocks,
//     about one wave on 132 SMs, with no vocabulary split, fp32 partials or
//     reduce launch. Ragged N and V are zero-filled by TMA out of bounds;
//     d-logits of columns past the last are 0 and rows past the last are
//     not stored. D must be a multiple of 8 (TMA's 16-byte row pitch); the
//     wrapper pads any other D with zero columns.
// Budget: 384 threads (2 consumer warpgroups + 1 producer warpgroup),
// __launch_bounds__(384, 1) caps ptxas at 168 registers a thread; ptxas
// (CUDA 12.8) reports 160 (dx) and 152 (dW) registers, no spill, and each
// kernel's SASS holds 20 HGMMA (chip_smoke.py's build phase prints these).
// Shared memory: 1 KB of alignment slack + (2 ceil(kc / 2) + 2) x 8 KB +
// stages x 16 KB + barriers, 230,520 bytes at D=768 (kc = 12 chunks, 7
// stages); one block per SM.
// Measured on an H100 (tools/torch_ce_bwd_ablation.py): with no loads after
// the first column tile the kernel keeps 93-100% of its time, and with
// neither product still 63-68%: the ring's handshakes and the per-tile
// d-logit exchange, not the tensor cores or the memory, set the pace; that
// is the next redesign's target.
//
// Plain C interface, loaded with ctypes. The barrier, TMA and wgmma
// helpers and the tensor-map encoding are sm90.cuh's.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TILE = 64;                      // rows, columns, chunk depth
constexpr int CHUNK = TILE * TILE * 2;        // one 64 x 64 bf16 box: 8 KB
constexpr int SLAB_CHUNKS = 3;                // 192 columns per warpgroup
constexpr int HALF_CHUNKS = 2 * SLAB_CHUNKS;  // 384 columns per block
constexpr int MAX_CHUNKS = 16;                // D <= 1024: row tile resident
constexpr int STAGE = 2 * CHUNK;              // two boxes per ring stage
constexpr int HALF_PAIRS = HALF_CHUNKS / 2;
constexpr int MAX_STAGES = 7;
constexpr int MIN_STAGES = HALF_PAIRS + 1;
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// Pair of chunks (128 columns of D) loaded at position p of a column tile:
// first the pairs outside the block's half [lo, lo + n_half), then the
// half's own.
__device__ __forceinline__ int pair_at(int p, int kp, int lo, int n_half) {
  const int rest = kp - n_half;
  return p < rest ? (p < lo ? p : p + n_half) : lo + (p - rest);
}

// A label compared with indices in [0, range): -1 where it lies outside.
__device__ __forceinline__ int label_in(long long l, int range) {
  return (l >= 0 && l < range) ? static_cast<int>(l) : -1;
}

// out[r, :] = sum over columns c of dl[r, c] * b[c, :]. TOKEN_ROWS: rows
// are tokens (dx: a = x, b = W); else rows are vocab entries (dW: a = W,
// b = x). labels, g and lse belong to the tokens.
template <bool TOKEN_ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_sm90_kernel(__grid_constant__ const CUtensorMap map_a,
                    __grid_constant__ const CUtensorMap map_b,
                    const long long* __restrict__ labels,
                    const float* __restrict__ g,
                    const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ out, int n_rows, int n_cols,
                    int d, int kc, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int kp = (kc + 1) / 2;                     // chunk pairs
  const uint32_t a_s = base;                       // 2 kp resident chunks
  const uint32_t b_s = a_s + 2 * kp * CHUNK;       // the ring
  const uint32_t dl_s = b_s + stages * STAGE;      // 2 d-logit tiles
  const uint32_t bar_s = dl_s + 2 * CHUNK;         // full, empty, a_full
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (stages + s); };
  const uint32_t a_full = bar_s + 16u * stages;

  const int row0 = blockIdx.x * TILE;
  const int lo = blockIdx.y * HALF_PAIRS;          // in pairs
  const int n_half = min(lo + HALF_PAIRS, kp) - lo;
  const int ntiles = (n_cols + TILE - 1) / TILE;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(a_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform in the compiler's eyes (a role
  // read from tid alone makes ptxas serialize the wgmma)
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == 2) {  // producer warpgroup: one thread issues every copy
    if (tid == 256) {
      mbar_expect_tx(a_full, 2 * kp * CHUNK);
      for (int j = 0; j < 2 * kp; ++j)
        tma_load(a_s + j * CHUNK, &map_a, j * TILE, row0, a_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        for (int p = 0; p < kp; ++p) {
          const int q = pair_at(p, kp, lo, n_half);
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), STAGE);
          tma_load(b_s + stage * STAGE, &map_b, 2 * q * TILE, t * TILE,
                   full(stage));
          tma_load(b_s + stage * STAGE + CHUNK, &map_b, (2 * q + 1) * TILE,
                   t * TILE, full(stage));
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: score columns [32 wg, 32 wg + 32) of each tile,
  // output columns of chunks [lo + 3 wg, lo + 3 wg + 3)
  const int wg = role;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  const int r_in = 16 * warp + (lane >> 2);  // fragment rows r_in, r_in + 8
  const int c_in = 2 * (lane & 3);           // fragment columns c_in + {0,1}
  const int mine = 2 * lo + SLAB_CHUNKS * wg;  // first chunk of the slab
  const int mine_lo = mine >> 1, mine_hi = (mine + SLAB_CHUNKS - 1) >> 1;

  float row_lse[2] = {0.f, 0.f}, row_g[2] = {0.f, 0.f};
  int row_lbl[2] = {-1, -1};
  if (TOKEN_ROWS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + r_in + 8 * i;
      if (r < n_rows) {
        row_lse[i] = lse[r] * LOG2E;
        row_g[i] = g[r];
        row_lbl[i] = label_in(labels[r], n_cols);
      }
    }
  }

  float o[SLAB_CHUNKS][32];
#pragma unroll
  for (int cc = 0; cc < SLAB_CHUNKS; ++cc)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[cc][e] = 0.f;

  mbar_wait(a_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * TILE;
    const int stage0 = stage;  // ring stage of position 0 of this tile

    // dW: lse, g and label belong to the columns (tokens)
    float col_lse[8], col_g[8];
    int col_lbl[8];
    if (!TOKEN_ROWS) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + 32 * wg + 8 * (q >> 1) + c_in + (q & 1);
        const bool ok = c < n_cols;
        col_lse[q] = ok ? lse[c] * LOG2E : 0.f;
        col_g[q] = ok ? g[c] : 0.f;
        col_lbl[q] = ok ? label_in(labels[c], n_rows) : -1;
      }
    }

    // 1. score columns of this warpgroup over all of D
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    fence_regs(s);
    wgmma_fence();
    int held = -1;  // stage read by the last group, to release after it
    for (int p = 0; p < kp; ++p) {
      const int q = pair_at(p, kp, lo, n_half);
      mbar_wait(full(stage), phase);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a_addr = a_s + (2 * q + h) * CHUNK;
        const uint32_t b_addr = b_s + stage * STAGE + h * CHUNK +
                                wg * (32 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n32(s, desc(a_addr + 32 * kk), desc(b_addr + 32 * kk),
                    (p | h | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && leader) mbar_arrive(empty(held));
      const bool keep = q >= mine_lo && q <= mine_hi;
      held = keep ? -1 : stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (held >= 0 && leader) mbar_arrive(empty(held));

    // 2. d-logits, rounded to bf16, into the swizzled tile dl[t & 1]
    const uint32_t dl_addr = dl_s + (t & 1) * CHUNK;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r_loc = r_in + 8 * i;
        const int r = row0 + r_loc;
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int q = 2 * n8 + jj;
          const int c = c0 + 32 * wg + 8 * n8 + c_in + jj;
          const float l2 = TOKEN_ROWS ? row_lse[i] : col_lse[q];
          const float gg = TOKEN_ROWS ? row_g[i] : col_g[q];
          const bool hit = TOKEN_ROWS ? c == row_lbl[i] : r == col_lbl[q];
          const float e = exp2f(fmaf(s[4 * n8 + 2 * i + jj], LOG2E, -l2));
          v[jj] = (r < n_rows && c < n_cols) ? (e - (hit ? 1.f : 0.f)) * gg
                                             : 0.f;
        }
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
        const int k = 32 * wg + 8 * n8 + c_in;
        const uint32_t at = dl_addr + r_loc * 128 +
                            ((((k >> 3) ^ (r_loc & 7)) << 4) | ((k & 7) * 2));
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                     "r"(*reinterpret_cast<const uint32_t*>(&h))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, 256;" ::: "memory");

    // 3. o[slab] += dl (64 x 64) . b[tile columns, slab]
#pragma unroll
    for (int cc = 0; cc < SLAB_CHUNKS; ++cc) fence_regs(o[cc]);
    wgmma_fence();
    // unconditional, so that no wgmma sits on a divergent path: a chunk
    // past D reads a stage of this tile and its columns are never stored
#pragma unroll
    for (int cc = 0; cc < SLAB_CHUNKS; ++cc) {
      const int j = min(mine + cc, 2 * (lo + n_half) - 1);
      const int st = (stage0 + (kp - n_half) + (j / 2 - lo)) % stages;
      const uint32_t b_addr = b_s + st * STAGE + (j & 1) * CHUNK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n64<1>(o[cc], desc(dl_addr + 32 * kk),
                     desc(b_addr + kk * 16 * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cc = 0; cc < SLAB_CHUNKS; ++cc) fence_regs(o[cc]);
    if (leader) {
      for (int q = mine_lo; q <= mine_hi; ++q)
        if (q < lo + n_half)
          mbar_arrive(empty((stage0 + (kp - n_half) + (q - lo)) % stages));
    }
  }

  // 4. the slab's rows, cast once
#pragma unroll
  for (int cc = 0; cc < SLAB_CHUNKS; ++cc) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + r_in + 8 * i;
        const int col = (mine + cc) * TILE + 8 * n8 + c_in;
        if (r < n_rows && col < d)
          *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)r * d + col]) =
              __floats2bfloat162_rn(o[cc][4 * n8 + 2 * i],
                                    o[cc][4 * n8 + 2 * i + 1]);
      }
    }
  }
}

int stages_for(int kc) {
  const int kp = (kc + 1) / 2;
  const int rest =
      SMEM_LIMIT - 1024 - (2 * kp + 2) * CHUNK - 16 * MAX_STAGES - 8;
  return rest / STAGE < MAX_STAGES ? rest / STAGE : MAX_STAGES;
}

}  // namespace

extern "C" {

// Geometry the wrapper and its tests read.
int lmhead_ce_sm90_tile() { return TILE; }
int lmhead_ce_sm90_half() { return HALF_CHUNKS * TILE; }
int lmhead_ce_sm90_slab() { return SLAB_CHUNKS * TILE; }
int lmhead_ce_sm90_max_d() { return MAX_CHUNKS * TILE; }

// bf16 backward: token_rows = 1 computes dx (a = x [n_rows = N, d], b = W
// [n_cols = V, d]); token_rows = 0 computes dW (a = W, b = x). out is
// [n_rows, d] bf16. Returns a CUDA error, or -1 (d not a multiple of 8 or
// above lmhead_ce_sm90_max_d()), -2 (no cuTensorMapEncodeTiled), -3 (a
// tensor map refused: a pointer not 16-byte aligned).
int lmhead_ce_bwd_sm90(const void* a, const void* b, const void* labels,
                       const void* g, const void* lse, void* out, int n_rows,
                       int n_cols, int d, int token_rows, void* stream) {
  const int kc = (d + TILE - 1) / TILE;
  if (d <= 0 || d % 8 || kc > MAX_CHUNKS || n_rows <= 0 || n_cols <= 0)
    return -1;
  if (encoder() == nullptr) return -2;
  CUtensorMap map_a, map_b;
  if (!make_map_2d(&map_a, a, n_rows, d, TILE) ||
      !make_map_2d(&map_b, b, n_cols, d, TILE))
    return -3;
  const int stages = stages_for(kc);
  if (stages < MIN_STAGES) return -1;
  const size_t smem = 1024 + (size_t)(2 * ((kc + 1) / 2) + 2) * CHUNK +
                      (size_t)stages * STAGE + 16 * stages + 8;
  const dim3 grid((n_rows + TILE - 1) / TILE,
                  (kc + HALF_CHUNKS - 1) / HALF_CHUNKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lbl = static_cast<const long long*>(labels);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(lse);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  auto kernel = token_rows ? bwd_sm90_kernel<true> : bwd_sm90_kernel<false>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, THREADS, smem, s>>>(map_a, map_b, lbl, gp, lp, o, n_rows,
                                     n_cols, d, kc, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
