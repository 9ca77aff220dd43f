// Kernel K3: the fused traffic MLP, in two entry points.
//
// agac_mlp_plan replaces the JAX package's ops/pallas_mlp.py::_kernel
// (:49-58): features [G, E, F] bf16 + mask [G, E] -> int32 weights
// [G, E], i.e. relu(bf16(x @ w1) + b1) -> relu(bf16(h @ w2) + b2) ->
// bf16(h @ w3) + b3, then the quantizer of plan_block.cuh on each group
// row, with nothing but the weights leaving the chip.
//
// agac_mlp_scores runs the same MLP on packed rows [N, F] -> f32 scores
// [N] for the fleet planner's score_rows (where the JAX package lets XLA
// do the matmuls).  Every row goes through the same code in the same
// order wherever it sits in the batch, so a row scores bit-identically
// in a 32-row incremental wave and in a 2.5M-row full repack; the
// resident planner's bit-exact check against the full repack rests on
// that, and a library GEMM, which picks its algorithm by shape, does not
// promise it.
//
// Arithmetic order (the contract of pallas_mlp.py:40-58): products of
// bf16 operands are exact in f32 and accumulate in f32; each matmul
// result rounds to bf16, the bf16 bias adds with one more rounding to
// bf16, then ReLU.
//
// Bound on the H100: 2 (F H + H H + H) flops per row, 35 kflop at F = 8,
// H = 128, so G = 16384, E = 16 is 9.2 Gflop: 9.3 us at the 989 TFLOP/s
// bf16 tensor-core rate, against 5.5 MB of traffic (1.6 us).  This first
// version is deliberately simple and runs on the CUDA cores in f32 FMA
// (67 TFLOP/s peak, so >= 137 us): one thread per hidden unit (H <= 128),
// w1, w2, w3 and the biases resident in shared memory per block, 32 rows
// of activations per pass in shared memory, 32 f32 accumulators per
// thread in registers.  wgmma with TMA-fed tiles is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "plan_block.cuh"

namespace {

constexpr int kThreads = 128;    // one thread per hidden unit
constexpr int kChunk = 32;       // rows per pass, accumulators per thread
constexpr int kBlockRows = 256;  // rows per block (score mode; a target
                                 // for plan mode, rounded to whole groups)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared memory: f32 w1 [F, H], b1, b2, w3 [H], x chunk [kChunk, F],
// scores [rows_per_block]; then bf16 w2 [H, H] and h [kChunk, H].
__host__ __device__ inline size_t smem_bytes(int F, int H,
                                             int rows_per_block) {
  return sizeof(float) *
             (static_cast<size_t>(F) * H + 3 * H + kChunk * F +
              rows_per_block) +
         sizeof(__nv_bfloat16) * (static_cast<size_t>(H) * H + kChunk * H);
}

template <bool kPlan>
__global__ void __launch_bounds__(kThreads) mlp_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
    const __nv_bfloat16* __restrict__ w3, const __nv_bfloat16* __restrict__ b3,
    float* __restrict__ scores_out, int32_t* __restrict__ weights_out,
    long long n_rows, int F, int H, int E, int rows_per_block) {
  extern __shared__ float smem[];
  float* w1s = smem;
  float* b1s = w1s + F * H;
  float* b2s = b1s + H;
  float* w3s = b2s + H;
  float* xs = w3s + H;
  float* sc = xs + kChunk * F;
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(sc + rows_per_block);
  __nv_bfloat16* hs = w2s + H * H;

  const int t = threadIdx.x;
  for (int i = t; i < H * H; i += kThreads) w2s[i] = w2[i];
  for (int i = t; i < F * H; i += kThreads) w1s[i] = bf(w1[i]);
  for (int i = t; i < H; i += kThreads) {
    b1s[i] = bf(b1[i]);
    b2s[i] = bf(b2[i]);
    w3s[i] = bf(w3[i]);
  }
  const float b3v = bf(b3[0]);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows_here = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const bool active = t < H;
  __syncthreads();

  for (int c0 = 0; c0 < rows_here; c0 += kChunk) {
    for (int i = t; i < kChunk * F; i += kThreads) {
      const int r = i / F;
      xs[i] = (c0 + r < rows_here)
                  ? bf(x[(row0 + c0 + r) * F + (i - r * F)])
                  : 0.0f;
    }
    __syncthreads();

    // layer 1: h = relu(bf16(bf16(x @ w1) + b1))
    if (active) {
      for (int r = 0; r < kChunk; ++r) {
        float acc = 0.0f;
        for (int k = 0; k < F; ++k) acc = fmaf(xs[r * F + k], w1s[k * H + t], acc);
        const float h = fmaxf(bf16_round(bf16_round(acc) + b1s[t]), 0.0f);
        hs[r * H + t] = __float2bfloat16_rn(h);
      }
    }
    __syncthreads();

    // layer 2: h = relu(bf16(bf16(h @ w2) + b2)), k in order 0..H-1
    float acc[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) acc[r] = 0.0f;
    if (active) {
      for (int k = 0; k < H; ++k) {
        const float w = bf(w2s[k * H + t]);
#pragma unroll
        for (int r = 0; r < kChunk; ++r) acc[r] = fmaf(bf(hs[r * H + k]), w, acc[r]);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        const float h = fmaxf(bf16_round(bf16_round(acc[r]) + b2s[t]), 0.0f);
        hs[r * H + t] = __float2bfloat16_rn(h);
      }
    }
    __syncthreads();

    // layer 3: s = bf16(bf16(h @ w3) + b3), one warp per row, a fixed
    // lane order then a fixed shuffle tree
    const int warp = t >> 5;
    const int lane = t & 31;
    for (int r = warp; r < kChunk; r += kThreads / 32) {
      float p = 0.0f;
      for (int j = lane; j < H; j += 32) p = fmaf(bf(hs[r * H + j]), w3s[j], p);
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0 && c0 + r < rows_here) {
        const float s = bf16_round(bf16_round(p) + b3v);
        if (kPlan) {
          sc[c0 + r] = s;
        } else {
          scores_out[row0 + c0 + r] = s;
        }
      }
    }
    __syncthreads();
  }

  if (kPlan) {
    // the quantizer over this block's whole groups (rows_per_block is a
    // multiple of E); the loop count is uniform across the block so every
    // warp takes part in every shuffle
    const int width = agac::row_width(E);
    const int per_warp = 32 / width;
    const int groups_here = rows_here / E;
    const int warp = t >> 5;
    const int lane = t & 31;
    for (int g0 = 0; g0 < groups_here; g0 += (kThreads / 32) * per_warp) {
      const int g = g0 + warp * per_warp + lane / width;
      const bool valid = g < groups_here;
      const int gg = valid ? g : 0;
      const long long base = row0 + static_cast<long long>(gg) * E;
      agac::plan_row(sc + gg * E, mask + base, weights_out + base, E,
                     lane % width, width, valid);
    }
  }
}

template <bool kPlan>
int launch(const void* x, const void* mask, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* w3, const void* b3,
           void* scores_out, void* weights_out, long long n_rows, int F,
           int H, int E, int rows_per_block, void* stream) {
  const size_t smem = smem_bytes(F, H, rows_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel<kPlan>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  using bf16 = __nv_bfloat16;
  mlp_kernel<kPlan><<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(b3),
      static_cast<float*>(scores_out), static_cast<int32_t*>(weights_out),
      n_rows, F, H, E, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features [G, E, F] bf16, mask [G, E] bool -> weights [G, E] int32
extern "C" int agac_mlp_plan(const void* x, const void* mask, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, void* out,
                             long long G, int E, int F, int H, void* stream) {
  const int groups_per_block = E >= kBlockRows ? 1 : kBlockRows / E;
  return launch<true>(x, mask, w1, b1, w2, b2, w3, b3, nullptr, out, G * E,
                      F, H, E, groups_per_block * E, stream);
}

// rows [N, F] bf16 -> scores [N] f32
extern "C" int agac_mlp_scores(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, long long N, int F,
                               int H, void* stream) {
  return launch<false>(x, nullptr, w1, b1, w2, b2, w3, b3, out, nullptr, N, F,
                       H, 1, kBlockRows, stream);
}
