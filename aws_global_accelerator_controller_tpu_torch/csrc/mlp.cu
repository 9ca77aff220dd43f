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
// Arithmetic (the contract of pallas_mlp.py:40-58): products of bf16
// operands are exact and accumulate in f32; each matmul result rounds to
// bf16, the bf16 bias adds with one more rounding to bf16, then ReLU;
// the score is bf16(bf16(h2 . w3) + b3).
//
// Bound on the H100: 2 (F H + H H + H) flops per row, 35 kflop at F = 8,
// H = 128, so G = 16384, E = 16 is 9.2 Gflop: 9.3 us at the 989 TFLOP/s
// bf16 tensor-core rate, against 5.5 MB of traffic (1.6 us).  The MLP is
// bound by its operations, and only the tensor cores reach that rate.
//
// Two routes, chosen by F and H alone (never by N, G, E, an alignment or
// the stream), with the same values:
//
// - The tensor-core route (mlp_tc_kernel) for F <= 16 and H in 64, 128,
//   192, 256, which holds the main path's F = 8, H = 128 and 256.
//   * Persistent CTAs of two warpgroups, one CTA an SM; the grid is the
//     SMs, or fewer where the rows need fewer.  Each CTA copies w1
//     (zero-padded to 16 rows) and w2 into shared memory once, in
//     16-byte chunks placed as a 128-byte-swizzled TMA box would place
//     them: boxes of 64 output columns x every contraction row, the
//     MN-major ("transposed") B operand that gmma_desc describes
//     (flash_common.cuh).  b1, b2 and w3 go there too, and the largest
//     column norms of w1 and w2 (the bounds below).  At H = 256 the
//     weights take 138 KB, at H = 128 37 KB.  Nothing is cached across
//     calls (a train step updates the params in place) and nothing is
//     pre-swizzled by another launch.
//   * A warpgroup takes a 64-row tile at a time (its tiles are the
//     worker's items in turn, the next tile's x loaded into registers
//     before this tile's products).  x is the A operand of layer 1 in
//     registers (one k16 step, columns past F zero), read by 16-bit
//     loads, so a view at any offset takes the same route.
//   * Layer 1: wgmma m64n64k16, A in registers, one per 64 columns; the
//     epilogue rounds as above and repacks the accumulators into layer
//     2's A fragments (pack_acc): h1 never touches shared memory.
//   * Layer 2: wgmma m64n64k16 over the H / 16 k16 steps in ascending
//     order, in output chunks of 128 columns at H = 256 (64 below) so
//     that h1's fragments and one chunk's accumulators fit the
//     registers.  Each chunk's epilogue folds straight into layer 3, so
//     h2 is never held whole.
//   * The CUDA-core route's values.  A tensor core sums a k16 step
//     otherwise than a sequential f32 fmaf chain, and truncates, so its
//     f32 sum lies a little off the chain's; where a bf16 rounding point
//     lies between the two, the epilogue's output differs (rare, but a
//     row whose score cancels then moves by up to 150 bf16 ulps of it:
//     chip_checks.py ties).  So a sum a is taken as it is only where the
//     epilogue gives the same output at a - e and a + e (near_tie; the
//     epilogue is monotone), e a bound on the distance of the two sums
//     (layer 1: 48 2^-24 ||x|| max_j ||w1_j||; layer 2: 24 2^-24 |a| +
//     48 / sqrt(H) 2^-24 ||h1|| max_j ||w2_j||: four times the smallest
//     scale at which chip_checks.py ties saw no value differ).  Every
//     other sum is summed again as the CUDA-core route sums it, one fmaf
//     after another in ascending k: layer 1's from x in global memory,
//     layer 2's from a copy of each warp's rows of h1 in shared memory
//     (16-byte loads).
//   * Layer 3 runs on the CUDA cores in the CUDA-core route's order: the
//     32 lane shares of columns c % 32 (here a row's quad holds all 32,
//     8 a lane), each ascending over its columns by fmaf, then that
//     route's shuffle tree over them.
//   * Plan mode: a worker's item is whole groups, floor(64 / E) of them
//     in one tile for E <= 64, one group over ceil(E / 64) tiles above;
//     the scores go to the warpgroup's shared buffer and then through
//     agac::plan_row as the CUDA-core route does (same width, same
//     lanes, a loop count uniform across the warp).  Masked and padding
//     rows run through the MLP and the quantizer zeroes them.
//   * Registers (nvcc -Xptxas -v, sm_90a; scores / plan entry): 162 /
//     168 at H = 64, 184 / 185 at 128, 215 / 217 at 192, 252 / 255 at
//     256, no spills.
//   * Shared memory: at H = 256 the weights and h1's copy take 205 KB,
//     which leaves the plan entry room for a group of up to 2752 rows
//     (43 tiles; 12288 at H = 192, 19776 at 128, 25216 at 64).  A plan
//     whose item does not fit takes the CUDA-core route, which gives the
//     same values (plan_tc_route, asked by agac_mlp_plan_tc_route);
//     launch_tc still refuses such an item with cudaErrorInvalidValue, a
//     guard no caller reaches.
//   * Bits: a row's score is the CUDA-core route's (on every row that
//     chip_checks.py ties and the card tests drew), so it does not
//     depend on the batch either, and the plan entry's scores are the
//     row entry's.
//
// - The CUDA-core route (mlp_kernel) for every other width, any F and
//   any H.  128 threads a block, each owning one hidden unit of a pass of
//   128 units (H > 128 takes ceil(H / 128) passes).  Rows go kChunk at a
//   time (32, or 8 when H is so wide that 32 rows of the hidden layer
//   would not fit in shared memory), with kChunk f32 accumulators per
//   thread, each dot a sequential fmaf chain over the contraction in
//   ascending order.  w1 and w2 sit whole in shared memory when they fit
//   together in kResidentBytes and otherwise stream through it in tiles
//   of kKTile contraction rows x 128 units.  The layer-1 activations of a
//   chunk stay in shared memory as layer 2's operand; layer 2's output
//   goes 128 units at a time through a [kChunk, 128] buffer into the
//   running layer-3 dot (lane l's units l, l + 32, ... in ascending
//   order, then the 32 lanes in a fixed shuffle tree).  The chunk size
//   and the tiling change which loads happen, never a row's arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_common.cuh"
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


// ---------------------------------------------------------------------------
// The tensor-core route: F <= 16, H in 64, 128, 192, 256.

namespace af = agac_flash;

constexpr int kTcGroups = 2;                 // consumer warpgroups a CTA
constexpr int kTcThreads = kTcGroups * 128;
constexpr int kTile = 64;                    // rows a warpgroup tile
constexpr int kTcMaxSmem = 227 * 1024;       // the H100's per-CTA limit

__host__ __device__ inline bool tc_route(int F, int H) {
  return F >= 1 && F <= 16 && H >= 64 && H <= 256 && H % 64 == 0;
}

// Shared layout of the weights: w2 as kBoxes boxes of kH rows x 64
// columns (128 bytes a row, 16-byte chunk j of row k at j ^ (k % 8)),
// then w1 as kBoxes boxes of 16 rows x 64 columns, then b1, b2 (bf16)
// and w3 (f32), the squared column-norm maxima of w1 and w2, each warp's
// rows of h1, then the warpgroups' plan-mode scores.
template <int kH>
struct TcShape {
  static constexpr int kBoxes = kH / 64;
  static constexpr int kW2Box = kH * 128;
  static constexpr int kW1Box = 16 * 128;
  static constexpr int kW2Bytes = kBoxes * kW2Box;
  static constexpr int kW1Bytes = kBoxes * kW1Box;
  static constexpr int kSteps = kH / 16;      // layer 2's k16 steps
  static constexpr int kNC = kH == 256 ? 128 : 64;   // columns a chunk
  static constexpr int kChunks = kH / kNC;
  static constexpr int kChunkBoxes = kNC / 64;
  // one bit a sum of a chunk (near_tie)
  using Bits = std::conditional_t<kNC == 128, uint64_t, uint32_t>;
  // layer 2's slack per ||h1|| max_j ||w2_j|| (near_tie): 48 / sqrt(kH)
  // units of 2^-24
  static constexpr float kTieS =
      (kH == 64 ? 6.0f : kH == 128 ? 4.25f : kH == 192 ? 3.5f : 3.0f) *
      0x1p-24f;
  // each warp's 16 rows of h1 (bf16), a row kH + 8 apart so that the
  // quad's stores of a fragment hit 32 banks
  static constexpr int kH1Stride = kH + 8;
  static constexpr int kH1Bytes = kTcGroups * 4 * 16 * kH1Stride * 2;
  // the weights, b1 and b2 (bf16), w3 (f32), the two maxima (16 bytes),
  // h1, and 1 KB to align the swizzled boxes
  static constexpr int kFixedBytes =
      kW2Bytes + kW1Bytes + 8 * kH + 16 + kH1Bytes + 1024;
};

template <int kH>
__host__ __device__ inline int tc_smem_bytes(int item_tiles) {
  return TcShape<kH>::kFixedBytes +
         static_cast<int>(sizeof(float)) * kTcGroups * item_tiles * kTile;
}

// the most tiles a plan item may have beside the weights at kH: the
// tc_smem_bytes that fit in kTcMaxSmem
template <int kH>
constexpr int tc_max_plan_tiles() {
  return (kTcMaxSmem - TcShape<kH>::kFixedBytes) /
         (static_cast<int>(sizeof(float)) * kTcGroups * kTile);
}

inline bool tc_plan_fits(int H, int item_tiles) {
  return item_tiles <= (H == 64    ? tc_max_plan_tiles<64>()
                        : H == 128 ? tc_max_plan_tiles<128>()
                        : H == 192 ? tc_max_plan_tiles<192>()
                                   : tc_max_plan_tiles<256>());
}

// the rows of a plan item on the tensor-core route: floor(64 / E) whole
// groups in one tile, or one group
inline int tc_plan_item_rows(int E) {
  return E <= kTile ? (kTile / E) * E : E;
}

// the plan entry's route: the tensor cores where tc_route holds and the
// item fits their shared memory; a group too large for it takes the
// CUDA-core route, which gives the same values
inline bool plan_tc_route(int E, int F, int H) {
  return tc_route(F, H) &&
         tc_plan_fits(H, (tc_plan_item_rows(E) + kTile - 1) / kTile);
}

// One 16-byte chunk (8 columns from column 8 j) of row k of a row-major
// [rows, kH] matrix into its swizzled place; rows >= rows_in are zero.
template <int kH>
__device__ __forceinline__ void put_chunk(uint8_t* dst, int box_bytes,
                                          const __nv_bfloat16* src, int k,
                                          int j, int rows_in, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k < rows_in) {
    const __nv_bfloat16* p = src + static_cast<long long>(k) * kH + 8 * j;
    if (vec) {
      v = *reinterpret_cast<const uint4*>(p);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = static_cast<uint32_t>(q[2 * e]) |
               (static_cast<uint32_t>(q[2 * e + 1]) << 16);
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const int c = j % 8;
  *reinterpret_cast<uint4*>(dst + (j / 8) * box_bytes + k * 128 +
                            ((c ^ (k % 8)) << 4)) = v;
}

// Columns c and c + 1 of row `row` of x [rows, F] as a bf16 pair, zero
// past F and for a row outside the tile (16-bit loads: any offset).
__device__ __forceinline__ uint32_t x_pair(const __nv_bfloat16* x,
                                           long long row, int c, int F,
                                           bool valid) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(x) + row * F + c;
  const uint32_t lo = valid && c < F ? p[0] : 0u;
  const uint32_t hi = valid && c + 1 < F ? p[1] : 0u;
  return lo | (hi << 16);
}

// This lane's A fragment of layer 1 for the tile of `rows` rows from
// row0: rows 16 w + lane / 4 and + 8 of warp w, columns 2 (lane % 4) and
// + 8 (the m16n8k16 A layout).
__device__ __forceinline__ void load_x(uint32_t (&a)[4],
                                       const __nv_bfloat16* x,
                                       long long row0, int rows, int F) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  a[0] = x_pair(x, row0 + r, c, F, r < rows);
  a[1] = x_pair(x, row0 + r + 8, c, F, r + 8 < rows);
  a[2] = x_pair(x, row0 + r, c + 8, F, r < rows);
  a[3] = x_pair(x, row0 + r + 8, c + 8, F, r + 8 < rows);
}

// Rows of tile `tile` of item `item` (items of item_rows rows, the last
// one cut at n_rows).
__device__ __forceinline__ int tile_rows(long long item, int tile,
                                         long long n_rows, int item_rows) {
  const long long in_item =
      min(static_cast<long long>(item_rows), n_rows - item * item_rows);
  return min(kTile, static_cast<int>(in_item) - tile * kTile);
}

// relu(bf16(bf16(a) + b)) of a column pair, packed: the CUDA-core
// route's epilogue (bf16_round, the f32 add, bf16_round, fmaxf) in bf16x2
// instructions.  The add rounds the exact sum of two bf16 numbers to
// bf16 once, where the CUDA-core route rounds it to f32 first; that
// double rounding is innocuous (24 >= 2 * 8 + 2 bits: S. A. Figueroa,
// "When is double rounding innocuous?", SIGNUM Newsl. 30(3), 1995), so
// both give the same bf16.
__device__ __forceinline__ __nv_bfloat162 layer_out(float a0, float a1,
                                                    __nv_bfloat162 bias) {
  return __hmax2(__hadd2(__floats2bfloat162_rn(a0, a1), bias),
                 __float2bfloat162_rn(0.0f));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 of a packed pair as floats.
__device__ __forceinline__ float lo_bf(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Column j of row k of a matrix that put_chunk placed in boxes of 64
// columns of box_bytes each.
__device__ __forceinline__ float w_at(const uint8_t* base, int box_bytes,
                                      int k, int j) {
  return bf(*reinterpret_cast<const __nv_bfloat16*>(
      base + (j >> 6) * box_bytes + k * 128 +
      ((((j >> 3) & 7) ^ (k & 7)) << 4) + (j & 7) * 2));
}

// Near a rounding point.  The tensor cores sum a dot in another order and
// rounding than the CUDA-core route's fmaf chain, so the two f32 sums
// differ by a little.  layer_out is monotone, so where it gives the same
// output at a - e and a + e, e a bound on that difference, both sums give
// it.  Bits 0 and 1: a0's and a1's outputs may differ.
__device__ __forceinline__ uint32_t near_tie(float a0, float a1, float e0,
                                             float e1, __nv_bfloat162 bias) {
  const uint32_t d = as_u32(layer_out(a0 - e0, a1 - e1, bias)) ^
                     as_u32(layer_out(a0 + e0, a1 + e1, bias));
  return static_cast<uint32_t>((d & 0xffffu) != 0u) |
         (static_cast<uint32_t>((d >> 16) != 0u) << 1);
}

// The bounds e of near_tie, in units of 2^-24: layer 1 (one k16 step of
// F <= 16 products) kTieX ||x|| max_j ||w1_j||; layer 2 (H / 16 steps)
// kTieV |a| + TcShape::kTieS ||h1|| max_j ||w2_j||.  A sum inside its
// bound is summed again as the CUDA-core route sums it.
constexpr float kTieX = 48.0f * 0x1p-24f;
constexpr float kTieV = 24.0f * 0x1p-24f;

// Sum over the quad (the four lanes of a row), then the square root.
__device__ __forceinline__ float quad_norm(float ss) {
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  return sqrtf(ss);
}

// h1 . w2[:, j] for a row of h1 (`row`, in shared memory), as the
// CUDA-core route sums it: one fmaf after another, k ascending from 0.
template <int kH>
__device__ __forceinline__ float h1_chain(const __nv_bfloat16* row, int j,
                                          const uint8_t* w2s) {
  using S = TcShape<kH>;
  const uint8_t* col = w2s + (j >> 6) * S::kW2Box + (j & 7) * 2;
  const int cj = (j >> 3) & 7;
  float v = 0.0f;
#pragma unroll 4
  for (int k0 = 0; k0 < kH; k0 += 8) {
    const uint4 h = *reinterpret_cast<const uint4*>(row + k0);
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = bf(*reinterpret_cast<const __nv_bfloat16*>(
          col + (k0 + i) * 128 + ((cj ^ i) << 4)));
    const uint32_t hk[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v = fmaf(lo_bf(hk[i]), w[2 * i], v);
      v = fmaf(hi_bf(hk[i]), w[2 * i + 1], v);
    }
  }
  return v;
}

// The score shares of one 64-row tile (rows of it: `rows`; x of its
// first row at xt; h1s this warp's rows of h1): part[r][m][e] for this
// lane's row 16 w + lane / 4 + 8 r, the sum of h2 . w3 over the columns
// c with c % 32 = 8 m + 2 (lane % 4) + e, ascending: the CUDA-core
// route's lane shares.
template <int kH>
__device__ __forceinline__ void tile_parts(
    float (&part)[2][4][2], const uint32_t (&xa)[4], const uint8_t* w1s,
    const uint8_t* w2s, uint64_t w1d, uint64_t w2d,
    const __nv_bfloat162* b1s, const __nv_bfloat162* b2s, const float2* w3s,
    __nv_bfloat16* h1s, const unsigned short* xt, int F, int rows,
    float w1n, float w2n) {
  using S = TcShape<kH>;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int lr = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const bool valid[2] = {lr < rows, lr + 8 < rows};
  // layer 1: h1 = relu(bf16(bf16(x @ w1) + b1)), one k16 step a box of 64
  // columns, repacked as layer 2's A fragments (n-tiles 2 kk and 2 kk + 1
  // are k16 step kk)
  float ex[2];
  {
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = lo_bf(xa[i]), h = hi_bf(xa[i]);
      ss[i & 1] = fmaf(h, h, fmaf(l, l, ss[i & 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float n = quad_norm(ss[r]);
      ex[r] = valid[r] ? kTieX * n * w1n : 0.0f;
    }
  }
  uint32_t h1[S::kSteps][4];
#pragma unroll
  for (int b = 0; b < S::kBoxes; ++b) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    af::fence_acc(acc);
    af::wgmma_fence();
    af::wgmma_rs<64, 0>(acc, xa, w1d + ((b * S::kW1Box) >> 4));
    af::wgmma_commit();
    af::wgmma_wait<0>();
    af::fence_acc(acc);
    uint32_t tie = 0u;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tie |= near_tie(acc[n][2 * r], acc[n][2 * r + 1], ex[r], ex[r],
                        b1s[32 * b + 4 * n + tq])
               << (4 * n + 2 * r);
    while (tie) {
      const int bit = __ffs(tie) - 1;
      tie &= tie - 1;
      const int j = 64 * b + 8 * (bit >> 2) + 2 * tq + (bit & 1);
      const unsigned short* xr =
          xt + static_cast<long long>(lr + 8 * ((bit >> 1) & 1)) * F;
      float xv[16], wv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        xv[k] = k < F ? __uint_as_float(static_cast<uint32_t>(xr[k]) << 16)
                      : 0.0f;
        wv[k] = w_at(w1s, S::kW1Box, k, j);
      }
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < F) v = fmaf(xv[k], wv[k], v);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (bit == 4 * n + i) acc[n][i] = v;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int kk = 4 * b + m;
      const __nv_bfloat162 lo = b1s[8 * kk + tq];
      const __nv_bfloat162 hi = b1s[8 * kk + 4 + tq];
      h1[kk][0] = as_u32(layer_out(acc[2 * m][0], acc[2 * m][1], lo));
      h1[kk][1] = as_u32(layer_out(acc[2 * m][2], acc[2 * m][3], lo));
      h1[kk][2] =
          as_u32(layer_out(acc[2 * m + 1][0], acc[2 * m + 1][1], hi));
      h1[kk][3] =
          as_u32(layer_out(acc[2 * m + 1][2], acc[2 * m + 1][3], hi));
    }
  }
  // h1 to shared memory too, for the sums summed again (the last tile's
  // are read by now)
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < S::kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(
          h1s + (lane / 4 + 8 * (i & 1)) * S::kH1Stride + 16 * kk +
          8 * (i >> 1) + 2 * tq) = h1[kk][i];
  __syncwarp();
  // layer 2's bounds, from ||h1|| of each row (a padding row's sums
  // summed again read nothing outside the tile)
  float es[2];
  {
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = lo_bf(h1[kk][i]), h = hi_bf(h1[kk][i]);
        ss[i & 1] = fmaf(h, h, fmaf(l, l, ss[i & 1]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      es[r] = S::kTieS * quad_norm(ss[r]) * w2n;
    }
  }
  // layers 2 and 3, a chunk of kNC output columns at a time
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) part[r][m][0] = part[r][m][1] = 0.0f;
#pragma unroll
  for (int c = 0; c < S::kChunks; ++c) {
    float acc[S::kNC / 8][4];
#pragma unroll
    for (int n = 0; n < S::kNC / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    const uint64_t chunk_d =
        w2d + ((c * S::kChunkBoxes * S::kW2Box) >> 4);
    af::fence_acc(acc);
    af::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < S::kSteps; ++k16)
      af::wgmma_rs_groups<64, S::kChunkBoxes, S::kW2Box>(
          acc, h1[k16], chunk_d + ((k16 * 16 * 128) >> 4));
    af::wgmma_commit();
    af::wgmma_wait<0>();
    af::fence_acc(acc);
    typename S::Bits tie = 0u;
#pragma unroll
    for (int n = 0; n < S::kNC / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float a0 = acc[n][2 * r], a1 = acc[n][2 * r + 1];
        tie |= static_cast<typename S::Bits>(near_tie(
                   a0, a1, fmaf(fabsf(a0), kTieV, es[r]),
                   fmaf(fabsf(a1), kTieV, es[r]),
                   b2s[(c * S::kNC + 8 * n) / 2 + tq]))
               << (4 * n + 2 * r);
      }
    // sums near a rounding point, summed again
    while (tie) {
      const int bit = (S::kNC == 128 ? __ffsll(static_cast<long long>(tie))
                                     : __ffs(static_cast<int>(tie))) - 1;
      tie &= tie - 1;
      const float v = h1_chain<kH>(
          h1s + (lane / 4 + 8 * ((bit >> 1) & 1)) * S::kH1Stride,
          c * S::kNC + 8 * (bit >> 2) + 2 * tq + (bit & 1), w2s);
#pragma unroll
      for (int n = 0; n < S::kNC / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (bit == 4 * n + i) acc[n][i] = v;
    }
    // h2 = relu(bf16(bf16(h1 @ w2) + b2)) into the lane shares of h2 . w3
#pragma unroll
    for (int n = 0; n < S::kNC / 8; ++n) {
      const int pair = (c * S::kNC + 8 * n) / 2 + tq;   // columns 2 pair, +1
      const int m = (c * S::kNC / 8 + n) % 4;
      const float2 w = w3s[pair];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 h = __bfloat1622float2(
            layer_out(acc[n][2 * r], acc[n][2 * r + 1], b2s[pair]));
        part[r][m][0] = fmaf(h.x, w.x, part[r][m][0]);
        part[r][m][1] = fmaf(h.y, w.y, part[r][m][1]);
      }
    }
  }
}

// x [n_rows, F] in items of item_rows rows (item_tiles tiles each, a
// group or whole groups of E in plan mode, 64 rows in score mode);
// worker (CTA, warpgroup) w takes items w, w + workers, ...
template <bool kPlan, int kH>
__global__ void __launch_bounds__(kTcThreads, 1)
    mlp_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ w1,
                  const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2,
                  const __nv_bfloat16* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ w3,
                  const __nv_bfloat16* __restrict__ b3,
                  float* __restrict__ scores_out,
                  int32_t* __restrict__ weights_out, long long n_rows, int F,
                  int E, int item_rows, int item_tiles) {
  using S = TcShape<kH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w2s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* w1s = w2s + S::kW2Bytes;
  __nv_bfloat16* b1s = reinterpret_cast<__nv_bfloat16*>(w1s + S::kW1Bytes);
  __nv_bfloat16* b2s = b1s + kH;
  float* w3s = reinterpret_cast<float*>(b2s + kH);
  unsigned* wn = reinterpret_cast<unsigned*>(w3s + kH);
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(w3s + kH + 4);
  float* sc =
      reinterpret_cast<float*>(h1s + kTcGroups * 4 * 16 * S::kH1Stride);

  // the weights, once a CTA
  const bool vec2 = (reinterpret_cast<uintptr_t>(w2) & 15) == 0;
  const bool vec1 = (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  for (int i = threadIdx.x; i < kH * (kH / 8); i += kTcThreads)
    put_chunk<kH>(w2s, S::kW2Box, w2, i / (kH / 8), i % (kH / 8), kH, vec2);
  for (int i = threadIdx.x; i < 16 * (kH / 8); i += kTcThreads)
    put_chunk<kH>(w1s, S::kW1Box, w1, i / (kH / 8), i % (kH / 8), F, vec1);
  for (int i = threadIdx.x; i < kH; i += kTcThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
    w3s[i] = bf(w3[i]);
  }
  if (threadIdx.x < 2) wn[threadIdx.x] = 0u;
  af::fence_proxy_async();
  __syncthreads();
  // the largest squared column norms of w1 and w2 (near_tie's scales);
  // non-negative floats order as their bits
  if (threadIdx.x < kH) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = w_at(w1s, S::kW1Box, k, threadIdx.x);
      s1 = fmaf(v, v, s1);
    }
#pragma unroll 16
    for (int k = 0; k < kH; ++k) {
      const float v = w_at(w2s, S::kW2Box, k, threadIdx.x);
      s2 = fmaf(v, v, s2);
    }
    atomicMax(&wn[0], __float_as_uint(s1));
    atomicMax(&wn[1], __float_as_uint(s2));
  }
  __syncthreads();
  const float w1n = sqrtf(__uint_as_float(wn[0])) * (1.0f + 0x1p-12f);
  const float w2n = sqrtf(__uint_as_float(wn[1])) * (1.0f + 0x1p-12f);
  const float b3v = bf(b3[0]);
  const uint64_t w1d = af::gmma_desc<128>(w1s);
  const uint64_t w2d = af::gmma_desc<128>(w2s);

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const long long n_items = (n_rows + item_rows - 1) / item_rows;
  const long long workers = static_cast<long long>(gridDim.x) * kTcGroups;
  float* my_sc = sc + wg * item_tiles * kTile;

  long long item = static_cast<long long>(blockIdx.x) * kTcGroups + wg;
  int tile = 0;
  uint32_t xa[4] = {0u, 0u, 0u, 0u};
  if (item < n_items)
    load_x(xa, x, item * item_rows, tile_rows(item, 0, n_rows, item_rows), F);
  while (item < n_items) {
    const long long item0 = item * item_rows;
    const int r0 = tile * kTile;               // this tile's first row
    const int rows_here = tile_rows(item, tile, n_rows, item_rows);

    // the next tile's x, in flight over this tile's products
    long long next_item = item;
    int next_tile = tile + 1;
    if (next_tile == item_tiles) {
      next_item += workers;
      next_tile = 0;
    }
    uint32_t xn[4] = {0u, 0u, 0u, 0u};
    if (next_item < n_items)
      load_x(xn, x, next_item * item_rows + next_tile * kTile,
             tile_rows(next_item, next_tile, n_rows, item_rows), F);

    float part[2][4][2];
    tile_parts<kH>(part, xa, w1s, w2s, w1d, w2d,
                   reinterpret_cast<const __nv_bfloat162*>(b1s),
                   reinterpret_cast<const __nv_bfloat162*>(b2s),
                   reinterpret_cast<const float2*>(w3s),
                   h1s + (threadIdx.x / 32) * 16 * S::kH1Stride,
                   reinterpret_cast<const unsigned short*>(x) +
                       (item0 + r0) * F,
                   F, rows_here, w1n, w2n);
    // layer 3: s = bf16(bf16(h2 . w3) + b3), the shares in the CUDA-core
    // route's shuffle tree (lanes 16, 8, 4, 2, 1 apart there: m 2 and 1
    // apart here, then the quad, then e)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        t[e] = (part[r][0][e] + part[r][2][e]) +
               (part[r][1][e] + part[r][3][e]);
        t[e] += __shfl_xor_sync(0xffffffffu, t[e], 2);
        t[e] += __shfl_xor_sync(0xffffffffu, t[e], 1);
      }
      const float s = bf16_round(bf16_round(t[0] + t[1]) + b3v);
      const int lr = warp * 16 + lane / 4 + 8 * r;   // row within the tile
      if (kPlan) {
        if (tq == 0 && lr < rows_here) my_sc[r0 + lr] = s;
      } else if (tq == 0 && lr < rows_here) {
        scores_out[item0 + r0 + lr] = s;
      }
    }

    if (kPlan && tile == item_tiles - 1) {
      // the quantizer over the item's groups; the loop count is uniform
      // across the warpgroup, so every warp takes part in every shuffle
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int width = agac::row_width(E);
      const int per_warp = 32 / width;
      const int groups = (r0 + rows_here) / E;   // the item's rows
      for (int g0 = 0; g0 < groups; g0 += 4 * per_warp) {
        const int g = g0 + warp * per_warp + lane / width;
        const bool valid = g < groups;
        const int gg = valid ? g : 0;
        const long long base = item0 + static_cast<long long>(gg) * E;
        agac::plan_row(my_sc + gg * E, mask + base, weights_out + base, E,
                       lane % width, width, valid);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    item = next_item;
    tile = next_tile;
#pragma unroll
    for (int i = 0; i < 4; ++i) xa[i] = xn[i];
  }
}

template <bool kPlan, int kH>
int launch_tc(const void* x, const void* mask, const void* w1, const void* b1,
              const void* w2, const void* b2, const void* w3, const void* b3,
              void* scores_out, void* weights_out, long long n_rows, int F,
              int E, int item_rows, int item_tiles, cudaStream_t stream) {
  auto kernel = mlp_tc_kernel<kPlan, kH>;
  const int smem = tc_smem_bytes<kH>(item_tiles);
  if (smem > kTcMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned allowed = 0;
  int err = af::allow_smem(kernel, kTcMaxSmem, &allowed, true);
  if (err) return err;
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  // CTAs an SM at one tile an item (every score call, plan at E <= 64),
  // asked once a device; a plan at E > 64 asks each call
  static int sms_of[32] = {};
  static int fit_of[32] = {};
  if (sms_of[dev] == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms_of[dev], cudaDevAttrMultiProcessorCount, dev));
    if (err) return err;
  }
  int fit = item_tiles == 1 ? fit_of[dev] : 0;
  if (fit == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, kTcThreads, smem));
    if (err) return err;
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (item_tiles == 1) fit_of[dev] = fit;
  }
  const long long items = (n_rows + item_rows - 1) / item_rows;
  const long long resident = static_cast<long long>(sms_of[dev]) * fit;
  const long long needed = (items + kTcGroups - 1) / kTcGroups;
  const long long ctas = needed < resident ? needed : resident;
  using bf16 = __nv_bfloat16;
  kernel<<<static_cast<unsigned>(ctas), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(b3),
      static_cast<float*>(scores_out), static_cast<int32_t*>(weights_out),
      n_rows, F, E, item_rows, item_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlan>
int dispatch_tc(const void* x, const void* mask, const void* w1,
                const void* b1, const void* w2, const void* b2,
                const void* w3, const void* b3, void* scores_out,
                void* weights_out, long long n_rows, int F, int H, int E,
                int item_rows, void* stream) {
  const int tiles = (item_rows + kTile - 1) / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64:
      return launch_tc<kPlan, 64>(x, mask, w1, b1, w2, b2, w3, b3,
                                  scores_out, weights_out, n_rows, F, E,
                                  item_rows, tiles, st);
    case 128:
      return launch_tc<kPlan, 128>(x, mask, w1, b1, w2, b2, w3, b3,
                                   scores_out, weights_out, n_rows, F, E,
                                   item_rows, tiles, st);
    case 192:
      return launch_tc<kPlan, 192>(x, mask, w1, b1, w2, b2, w3, b3,
                                   scores_out, weights_out, n_rows, F, E,
                                   item_rows, tiles, st);
    default:
      return launch_tc<kPlan, 256>(x, mask, w1, b1, w2, b2, w3, b3,
                                   scores_out, weights_out, n_rows, F, E,
                                   item_rows, tiles, st);
  }
}

}  // namespace

// features [G, E, F] bf16, mask [G, E] bool -> weights [G, E] int32
extern "C" int agac_mlp_plan(const void* x, const void* mask, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, void* out,
                             long long G, int E, int F, int H, void* stream) {
  if (plan_tc_route(E, F, H))
    return dispatch_tc<true>(x, mask, w1, b1, w2, b2, w3, b3, nullptr, out,
                             G * E, F, H, E, tc_plan_item_rows(E), stream);
  const int groups_per_block = E >= kBlockRows ? 1 : kBlockRows / E;
  return dispatch<true>(x, mask, w1, b1, w2, b2, w3, b3, nullptr, out, G * E,
                        F, H, E, groups_per_block * E, stream);
}

// 1 where agac_mlp_plan takes its tensor-core route for groups of E
// rows of F features and H hidden units, else 0.
extern "C" int agac_mlp_plan_tc_route(int E, int F, int H) {
  return plan_tc_route(E, F, H) ? 1 : 0;
}

// rows [N, F] bf16 -> scores [N] f32
extern "C" int agac_mlp_scores(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, long long N, int F,
                               int H, void* stream) {
  if (tc_route(F, H))
    return dispatch_tc<false>(x, nullptr, w1, b1, w2, b2, w3, b3, out,
                              nullptr, N, F, H, 1, kTile, stream);
  return dispatch<false>(x, nullptr, w1, b1, w2, b2, w3, b3, out, nullptr, N,
                         F, H, 1, kBlockRows, stream);
}
