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
// bf16 operands are exact in f32 and accumulate in f32, over the
// contraction in ascending order; each matmul result rounds to bf16, the
// bf16 bias adds with one more rounding to bf16, then ReLU.  The last
// layer's dot sums lane l's units l, l + 32, l + 64, ... in ascending
// order, then the 32 lanes in a fixed shuffle tree.
//
// Bound on the H100: 2 (F H + H H + H) flops per row, 35 kflop at F = 8,
// H = 128, so G = 16384, E = 16 is 9.2 Gflop: 9.3 us at the 989 TFLOP/s
// bf16 tensor-core rate, against 5.5 MB of traffic (1.6 us).  This first
// version is deliberately simple and runs on the CUDA cores in f32 FMA
// (67 TFLOP/s peak, so >= 137 us).  wgmma with TMA-fed tiles is the later
// step.
//
// Design: 128 threads a block, each owning one hidden unit of a pass of
// 128 units (H > 128 takes ceil(H / 128) passes, any H, any F).  Rows go
// kChunk at a time (32, or 8 when H is so wide that 32 rows of the
// hidden layer would not fit in shared memory), with kChunk f32
// accumulators per thread.  w1 and w2 sit whole in shared memory when
// they fit together in kResidentBytes (H = 128 at F = 8 does) and
// otherwise stream through it in tiles of kKTile contraction rows x 128
// units.  The layer-1 activations of a chunk, [kChunk, H] bf16, stay in
// shared memory as layer 2's operand; layer 2's output goes 128 units at
// a time through a [kChunk, 128] buffer into the running layer-3 dot, so
// the whole second hidden layer is never held.  The chunk size and the
// tiling change which loads happen, never a row's arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "plan_block.cuh"

namespace {

constexpr int kThreads = 128;    // one hidden unit per thread per pass
constexpr int kUnits = kThreads; // hidden units per pass
constexpr int kWarps = kThreads / 32;
constexpr int kKTile = 32;       // contraction rows per streamed tile
constexpr int kBlockRows = 256;  // rows per block (score mode; a target
                                 // for plan mode, rounded to whole groups)
// w1 and w2 stay resident in shared memory (bf16) up to this size
constexpr size_t kResidentBytes = 96 * 1024;
// the kChunk = 32 layout is used while it takes at most this much
constexpr size_t kWideBytes = 200 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ inline bool resident(int F, int H) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(F) * H +
                                  static_cast<size_t>(H) * H) <=
         kResidentBytes;
}

// Shared memory: f32 x tile [kChunk, kKTile] and scores
// [rows_per_block]; bf16 h1 [kChunk, H], h2 [kChunk, kUnits], then either
// w1 [F, H] and w2 [H, H] (resident) or one tile [kKTile, kUnits].
__host__ __device__ inline size_t smem_bytes(int chunk, int F, int H,
                                             int rows_per_block) {
  const size_t w = resident(F, H)
                       ? static_cast<size_t>(F) * H +
                             static_cast<size_t>(H) * H
                       : static_cast<size_t>(kKTile) * kUnits;
  return sizeof(float) * (static_cast<size_t>(chunk) * kKTile +
                          rows_per_block) +
         sizeof(__nv_bfloat16) * (static_cast<size_t>(chunk) * H +
                                  static_cast<size_t>(chunk) * kUnits + w);
}

// Rows [k0, k0 + kt) x units [u0, u0 + kUnits) of a [K, H] matrix into a
// [kKTile, kUnits] tile, zero past H.
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* tile,
                                            const __nv_bfloat16* w, int H,
                                            int k0, int kt, int u0) {
  for (int i = threadIdx.x; i < kt * kUnits; i += kThreads) {
    const int kk = i / kUnits;
    const int u = i - kk * kUnits;
    tile[i] = (u0 + u < H) ? w[static_cast<long long>(k0 + kk) * H + u0 + u]
                           : __float2bfloat16_rn(0.0f);
  }
}

template <bool kPlan, int kChunk>
__global__ void __launch_bounds__(kThreads) mlp_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
    const __nv_bfloat16* __restrict__ w3, const __nv_bfloat16* __restrict__ b3,
    float* __restrict__ scores_out, int32_t* __restrict__ weights_out,
    long long n_rows, int F, int H, int E, int rows_per_block) {
  constexpr int kRowsPerWarp = kChunk / kWarps;
  extern __shared__ float smem[];
  float* xs = smem;                                  // [kChunk, kKTile]
  float* sc = xs + kChunk * kKTile;                  // [rows_per_block]
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(sc + rows_per_block);
  __nv_bfloat16* h2 = h1 + kChunk * H;               // [kChunk, kUnits]
  __nv_bfloat16* wbuf = h2 + kChunk * kUnits;
  const bool whole = resident(F, H);
  __nv_bfloat16* w1s = wbuf;                         // resident: [F, H]
  __nv_bfloat16* w2s = wbuf + F * H;                 // resident: [H, H]

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  if (whole) {
    for (int i = t; i < F * H; i += kThreads) w1s[i] = w1[i];
    for (int i = t; i < H * H; i += kThreads) w2s[i] = w2[i];
  }
  const float b3v = bf(b3[0]);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows_here = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));

  for (int c0 = 0; c0 < rows_here; c0 += kChunk) {
    // layer 1: h1 = relu(bf16(bf16(x @ w1) + b1)), k in order 0..F-1
    for (int u0 = 0; u0 < H; u0 += kUnits) {
      const int j = u0 + t;
      float acc[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) acc[r] = 0.0f;
      for (int k0 = 0; k0 < F; k0 += kKTile) {
        const int kt = min(kKTile, F - k0);
        __syncthreads();   // every thread is done with the last tiles
        for (int i = t; i < kChunk * kKTile; i += kThreads) {
          const int r = i / kKTile;
          const int kk = i - r * kKTile;
          xs[i] = (c0 + r < rows_here && kk < kt)
                      ? bf(x[(row0 + c0 + r) * F + k0 + kk])
                      : 0.0f;
        }
        if (!whole) load_w_tile(wbuf, w1, H, k0, kt, u0);
        __syncthreads();
        const __nv_bfloat16* wt = whole ? w1s + k0 * H + u0 : wbuf;
        const int ws = whole ? H : kUnits;
        if (j < H) {
          for (int kk = 0; kk < kt; ++kk) {
            const float w = bf(wt[kk * ws + t]);
#pragma unroll
            for (int r = 0; r < kChunk; ++r)
              acc[r] = fmaf(xs[r * kKTile + kk], w, acc[r]);
          }
        }
      }
      if (j < H) {
        const float bias = bf(b1[j]);
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
          h1[r * H + j] = __float2bfloat16_rn(
              fmaxf(bf16_round(bf16_round(acc[r]) + bias), 0.0f));
      }
    }

    // layers 2 and 3, 128 units at a time: h2 = relu(bf16(bf16(h1 @ w2)
    // + b2)) with k in order 0..H-1, then each lane's running share of
    // the dot h2 . w3
    float part[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) part[i] = 0.0f;
    for (int u0 = 0; u0 < H; u0 += kUnits) {
      const int j = u0 + t;
      float acc[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) acc[r] = 0.0f;
      for (int k0 = 0; k0 < H; k0 += kKTile) {
        const int kt = min(kKTile, H - k0);
        __syncthreads();   // h1 is complete; the last tile is done with
        if (!whole) {
          load_w_tile(wbuf, w2, H, k0, kt, u0);
          __syncthreads();
        }
        const __nv_bfloat16* wt = whole ? w2s + k0 * H + u0 : wbuf;
        const int ws = whole ? H : kUnits;
        if (j < H) {
          for (int kk = 0; kk < kt; ++kk) {
            const float w = bf(wt[kk * ws + t]);
#pragma unroll
            for (int r = 0; r < kChunk; ++r)
              acc[r] = fmaf(bf(h1[r * H + k0 + kk]), w, acc[r]);
          }
        }
      }
      if (j < H) {
        const float bias = bf(b2[j]);
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
          h2[r * kUnits + t] = __float2bfloat16_rn(
              fmaxf(bf16_round(bf16_round(acc[r]) + bias), 0.0f));
      }
      __syncthreads();
      const int units = min(kUnits, H - u0);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        for (int u = lane; u < units; u += 32)
          part[i] = fmaf(bf(h2[r * kUnits + u]), bf(w3[u0 + u]), part[i]);
      }
    }

    // layer 3: s = bf16(bf16(h2 @ w3) + b3), the lanes in a fixed
    // shuffle tree
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      float p = part[i];
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0 && c0 + r < rows_here) {
        const float s = bf16_round(bf16_round(p) + b3v);
        if (kPlan) {
          sc[c0 + r] = s;
        } else {
          scores_out[row0 + c0 + r] = s;
        }
      }
    }
  }
  __syncthreads();

  if (kPlan) {
    // the quantizer over this block's whole groups (rows_per_block is a
    // multiple of E); the loop count is uniform across the block so every
    // warp takes part in every shuffle
    const int width = agac::row_width(E);
    const int per_warp = 32 / width;
    const int groups_here = rows_here / E;
    for (int g0 = 0; g0 < groups_here; g0 += kWarps * per_warp) {
      const int g = g0 + warp * per_warp + lane / width;
      const bool valid = g < groups_here;
      const int gg = valid ? g : 0;
      const long long base = row0 + static_cast<long long>(gg) * E;
      agac::plan_row(sc + gg * E, mask + base, weights_out + base, E,
                     lane % width, width, valid);
    }
  }
}

template <bool kPlan, int kChunk>
int launch(const void* x, const void* mask, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* w3, const void* b3,
           void* scores_out, void* weights_out, long long n_rows, int F,
           int H, int E, int rows_per_block, void* stream) {
  const size_t smem = smem_bytes(kChunk, F, H, rows_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel<kPlan, kChunk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  using bf16 = __nv_bfloat16;
  mlp_kernel<kPlan, kChunk><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(b3),
      static_cast<float*>(scores_out), static_cast<int32_t*>(weights_out),
      n_rows, F, H, E, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// kChunk = 32 unless its layout would take more than kWideBytes
template <bool kPlan>
int dispatch(const void* x, const void* mask, const void* w1, const void* b1,
             const void* w2, const void* b2, const void* w3, const void* b3,
             void* scores_out, void* weights_out, long long n_rows, int F,
             int H, int E, int rows_per_block, void* stream) {
  if (smem_bytes(32, F, H, rows_per_block) <= kWideBytes)
    return launch<kPlan, 32>(x, mask, w1, b1, w2, b2, w3, b3, scores_out,
                             weights_out, n_rows, F, H, E, rows_per_block,
                             stream);
  return launch<kPlan, 8>(x, mask, w1, b1, w2, b2, w3, b3, scores_out,
                          weights_out, n_rows, F, H, E, rows_per_block,
                          stream);
}

}  // namespace

// features [G, E, F] bf16, mask [G, E] bool -> weights [G, E] int32
extern "C" int agac_mlp_plan(const void* x, const void* mask, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, void* out,
                             long long G, int E, int F, int H, void* stream) {
  const int groups_per_block = E >= kBlockRows ? 1 : kBlockRows / E;
  return dispatch<true>(x, mask, w1, b1, w2, b2, w3, b3, nullptr, out, G * E,
                        F, H, E, groups_per_block * E, stream);
}

// rows [N, F] bf16 -> scores [N] f32
extern "C" int agac_mlp_scores(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, long long N, int F,
                               int H, void* stream) {
  return dispatch<false>(x, nullptr, w1, b1, w2, b2, w3, b3, out, nullptr, N,
                         F, H, 1, kBlockRows, stream);
}
