// Kernels K10 and K11: the temporal model's fused score head,
// relu(x . w1 + b1) . w2 + b2 over the rows of x [N, D] bf16 (N = T S,
// the attended representation), without the [N, H] hidden ever reaching
// memory.
//
// K10 (agac_score_head_fwd) replaces the JAX package's
// ops/pallas_head.py::_fwd_kernel (:72, launched by _fwd :156 -> :160):
// scores [N] f32.  K11 (agac_score_head_bwd) replaces _bwd_kernel (:90,
// launched by _bwd :186 -> :198), the custom VJP's backward (_head_diff
// :244-258): it recomputes the hidden and gives dx [N, D] bf16 and the
// weight gradients dw1 [D, H], db1 [H], dw2 [H], db2 f32.
//
// Arithmetic (the reference kernels' own, pallas_head.py:21-29, :72-128):
// - h = relu(bf16(bf16(x . w1) + b1)): bf16 operands, f32 sums rounded to
//   bf16, the bf16 bias added with one more rounding; scores =
//   bf16(bf16(h . w2) + b2) as f32;
// - backward, from the f32 cotangent ds of the scores: dw2 = h^T .
//   bf16(ds) and db2 = sum ds, f32; dh = bf16(h > 0 ? ds w2 : 0) (the
//   product in f32); db1 = sum dh and dw1 = x^T . dh, f32; dx =
//   bf16(dh . w1^T).
// Both kernels have two routes, chosen here by D and H alone (tc_route):
// the CUDA-core route runs the products on mma.sync m16n8k16 with bf16
// operands and f32 accumulators (flash_common.cuh); the h . w2 dot and
// the sums of dw2 and db1 run in f32 FMA on the accumulator layout, in a
// fixed order.  The tensor-core route (D <= 128, H <= 256: both of the
// main path's shapes; score_head_fwd_tc_kernel and
// score_head_bwd_tc_kernel below) runs the same chains of k16 steps on
// wgmma, whose k16 step sums as mma.sync's does, and folds h . w2 and
// forms dh in the same per-lane order, so its scores and dx are the
// CUDA-core route's bit for bit.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): K10 moves 2 N D + 4 N
// bytes (x in, scores out) and does 2 N D H (+ 2 N H) flops; K11 moves
// 4 N D + 4 N bytes (x and ds in, dx out) and does 6 N D H flops (h
// again, dw1, dx).  At N = 524,288, D = 32, H = 128 (the train command's
// defaults) that is 35.7 MB and 69 MB, bound by bytes at 10.6 and 20.7
// us (K10's 4.4 GFLOP take 4.4 us); at N = 262,144, D = 128, H = 256 K10
// is bound by bytes (68 MB, 20.3 us) with its 17.3 GFLOP close behind
// (17.5 us at the peak, which m64n64k16 products with both operands in
// shared memory reach only if shared memory feeds them at its full 128
// bytes a clock), and K11 by operations (51.5 GFLOP, 52 us).
//
// Design.  The TPU kernels walk a sequential grid of row blocks with the
// padded weights and (backward) the weight-gradient accumulators resident
// in VMEM.  Here rows go in tiles of 64 (4 warps of 16 rows), the hidden
// layer in chunks of kHN = 64 units and D in chunks of at most 128
// columns (kDPad = 16, 32, 64 or 128; wider heads loop over 128-column
// chunks), so any D and H run; x and w1 chunks stage through shared
// memory with the flash kernels' tile loader.
// - K10's CUDA-core route (every width off the tensor-core route): one
//   CTA a row tile; for each hidden chunk, the [64, kHN] h tile is built
//   in registers and folded into the running h . w2 of its rows.  Its
//   tensor-core route (below score_head_fwd_tc_kernel): a persistent CTA
//   an SM holding w1, b1 and w2 once in shared memory, a producer warp
//   streaming x by TMA into a ring of stages, four consumer warpgroups
//   each running h by wgmma with the next chunk's product under this
//   chunk's epilogue.
// - K11's CUDA-core route (every width off the tensor-core route): a
//   persistent grid (as many CTAs as the card holds at once, at
//   most 4 an SM), CTA c owning a contiguous run of row tiles, w1 whole
//   in shared memory when D is 65-128 and it fits in 96 KB (else one
//   chunk at a time).
//   Pass 1, per (D chunk, hidden chunk) block of dw1: for each of its
//   row tiles, rebuild the h chunk, form dh in shared
//   memory, and add x^T . dh into the block's accumulators in registers
//   (dw2 and db1 beside them); write the block into CTA c's f32 partial.
//   Pass 2, per row tile and D chunk: rebuild every h chunk and sum dh .
//   w1^T into the dx tile, written once.  A second kernel then sums the
//   per-CTA partials in CTA order.  No atomics, so two runs are bit for
//   bit identical; the partials take (D H + 2 H + 1) floats per CTA
//   (35 MB at D = 128, H = 256 on 132 SMs, against 537 MB for one per row
//   tile at 2 CTAs an SM).
#include <algorithm>

#include "flash_common.cuh"

namespace {

using namespace agac_flash;   // kBlock = 64 rows, kThreads = 128, fragments

constexpr int kHN = 64;                // hidden units per chunk
constexpr int kHStride = kHN + 8;      // bf16 per smem row of w1, dh chunks
constexpr int kHTiles = kHN / 8;       // n-tiles of a hidden chunk
// K11 keeps all of w1 in shared memory up to this size
constexpr int kW1ResidentBytes = 96 * 1024;
// K11's persistent grid: at most this many CTAs a multiprocessor
constexpr int kMaxCtasPerSm = 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The A fragment of X^T (rows [m0, m0 + 16) of X^T, contraction rows
// [16 kk, 16 kk + 16) of X) from a tile X stored [k][m].
__device__ __forceinline__ void a_frag_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* tile,
                                         int stride, int m0, int kk) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p =
      tile + (kk * 16 + 2 * (lane % 4)) * stride + m0 + lane / 4;
  a[0] = pack_raw(p[0], p[stride]);
  a[1] = pack_raw(p[8], p[stride + 8]);
  a[2] = pack_raw(p[8 * stride], p[9 * stride]);
  a[3] = pack_raw(p[8 * stride + 8], p[9 * stride + 8]);
}

// Rows [c0, c0 + kDPad) and columns [j0, j0 + kHN) of w1 [D, H] into a
// [kDPad][kHStride] tile, zero past D and H.
template <int kDPad>
__device__ __forceinline__ void load_w1(__nv_bfloat16* w1s,
                                        const __nv_bfloat16* __restrict__ w1,
                                        int D, int H, int c0, int j0) {
  for (int i = threadIdx.x; i < kDPad * kHN; i += kThreads) {
    const int dd = i / kHN;
    const int jj = i - dd * kHN;
    const int d = c0 + dd;
    const int j = j0 + jj;
    w1s[dd * kHStride + jj] = (d < D && j < H)
                                  ? w1[static_cast<long long>(d) * H + j]
                                  : __float2bfloat16_rn(0.0f);
  }
}

// The hidden units padded to whole chunks, and the row stride of w1 held
// whole in shared memory.
__host__ __device__ inline int w1_stride(int H) {
  return (H + kHN - 1) / kHN * kHN + 8;
}

// Does K11 hold all of w1 in shared memory?  Only for one 128-column
// chunk of D: on the H100 that took K11 at D = 128, H = 256 from 1.38 to
// 1.04 ms, where a w1 chunk reloaded per row tile is 16 KB, while at
// D = 32, H = 128 (4 KB a reload) the streamed form ran 5% faster.
template <int kDPad, bool kChunked>
__host__ __device__ inline bool w1_resident(int H) {
  return kDPad == kMaxDPad && !kChunked &&
         2 * kDPad * w1_stride(H) <= kW1ResidentBytes;
}

// w1 [D, H] whole into a [kDPad][w1_stride(H)] tile, zero past D and H.
template <int kDPad>
__device__ __forceinline__ void load_w1_whole(
    __nv_bfloat16* w1s, const __nv_bfloat16* __restrict__ w1, int D, int H) {
  const int ws = w1_stride(H);
  for (int i = threadIdx.x; i < kDPad * ws; i += kThreads) {
    const int d = i / ws;
    const int j = i - d * ws;
    w1s[i] = (d < D && j < H) ? w1[static_cast<long long>(d) * H + j]
                              : __float2bfloat16_rn(0.0f);
  }
}

// acc = x[row0 : row0 + 64] . w1[:, j0 : j0 + kHN], the sum over D in
// ascending 128-column chunks (one unless kChunked).  Leaves the last
// chunk of x in xs and (unless w1 is resident: all of it already in w1s,
// row stride ws) the last chunk of w1 in w1s; without kChunked x is
// loaded only when load_x (it stays in xs across the hidden chunks of a
// row tile).
template <int kDPad, bool kChunked>
__device__ __forceinline__ void hidden_chunk(
    float (&acc)[kHTiles][4], __nv_bfloat16* xs, __nv_bfloat16* w1s,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    int row0, int N, int D, int H, int j0, bool load_x, bool resident,
    int ws) {
  constexpr int kXStride = kDPad + 8;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int nt = 0; nt < kHTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const __nv_bfloat16* wt = resident ? w1s + j0 : w1s;
  const int wst = resident ? ws : kHStride;
  for (int c = 0; c < (kChunked ? D : 1); c += kDPad) {
    __syncthreads();   // every warp is done with the previous tiles
    if (kChunked || load_x)
      load_tile<kDPad, kXStride, false>(xs, x, row0, N, 1, D, 0, 1.f, c);
    if (!resident) load_w1<kDPad>(w1s, w1, D, H, c, j0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDPad / 16; ++kk) {
      uint32_t xa[4];
      a_frag(xa, xs, kXStride, warp * 16, kk);
#pragma unroll
      for (int nt = 0; nt < kHTiles; ++nt)
        mma_kn(acc[nt], xa, wt, wst, nt * 8, kk);
    }
  }
}

// h = relu(bf16(bf16(acc) + b1)) of accumulator element i of n-tile nt.
__device__ __forceinline__ float hidden(float acc,
                                        const __nv_bfloat16* __restrict__ b1,
                                        int j) {
  return fmaxf(bf16_round(bf16_round(acc) + bf(b1[j])), 0.f);
}

template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) score_head_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, float* __restrict__ out, int N,
    int D, int H) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBlock * (kDPad + 8)];
  __shared__ __align__(16) __nv_bfloat16 w1s[kDPad * kHStride];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int row0 = blockIdx.x * kBlock;

  // each lane's share of h . w2 for its two rows, units in ascending
  // order: n-tiles in order, chunk after chunk
  float part[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < H; j0 += kHN) {
    float acc[kHTiles][4];
    hidden_chunk<kDPad, kChunked>(acc, xs, w1s, x, w1, row0, N, D, H, j0,
                                  j0 == 0, false, kHStride);
#pragma unroll
    for (int nt = 0; nt < kHTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + nt * 8 + 2 * tq + (i & 1);
        if (j < H)
          part[i >> 1] = fmaf(hidden(acc[nt][i], b1, j), bf(w2[j]),
                              part[i >> 1]);
      }
    }
  }
  const float b2v = bf(b2[0]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float p = part[r];
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    const int row = row0 + warp * 16 + g + 8 * r;
    if (tq == 0 && row < N) out[row] = bf16_round(bf16_round(p) + b2v);
  }
}

// Shared memory of K11: x chunk [64][kDPad + 8], dh [64][kHStride] bf16;
// f32 ds of the row tile and the cross-warp sums of dw2 and db1; then w1,
// whole [kDPad][w1_stride(H)] or one chunk [kDPad][kHStride], bf16.
template <int kDPad, bool kChunked>
__host__ __device__ inline int bwd_smem_bytes(int H) {
  const int w1_elems = w1_resident<kDPad, kChunked>(H)
                           ? kDPad * w1_stride(H)
                           : kDPad * kHStride;
  return 2 * (kBlock * (kDPad + 8) + kBlock * kHStride) +
         4 * (kBlock + 2 * kWarps * kHN + kWarps) + 2 * w1_elems;
}

// Per-CTA partial layout: dw1 [D, H], db1 [H], dw2 [H], db2 [1].
__host__ __device__ inline long long partial_size(int D, int H) {
  return static_cast<long long>(D) * H + 2LL * H + 1;
}

template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) score_head_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ ds,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partials, int N, int D, int H, int tiles_per_cta) {
  constexpr int kXStride = kDPad + 8;
  constexpr int kMTiles = kDPad / 16;                     // of dw1's D rows
  constexpr int kDw1Tiles = kMTiles * kHTiles / kWarps;   // per warp
  constexpr int kDxTiles = kDPad / 8;                     // of dx's columns
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dhs = xs + kBlock * kXStride;
  float* dss = reinterpret_cast<float*>(dhs + kBlock * kHStride);
  float* red = dss + kBlock;                 // [2][kWarps][kHN]
  float* red2 = red + 2 * kWarps * kHN;      // [kWarps]
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(red2 + kWarps);
  const bool resident = w1_resident<kDPad, kChunked>(H);
  const int ws = w1_stride(H);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int n_tiles = (N + kBlock - 1) / kBlock;
  const int tile0 = blockIdx.x * tiles_per_cta;
  const int tile1 = min(n_tiles, tile0 + tiles_per_cta);
  float* part = partials + blockIdx.x * partial_size(D, H);
  float* part_db1 = part + static_cast<long long>(D) * H;
  float* part_dw2 = part_db1 + H;
  const int last_c = kChunked ? (D - 1) / kDPad * kDPad : 0;

  if (resident) load_w1_whole<kDPad>(w1s, w1, D, H);   // synced below

  // db2 = sum of ds over this CTA's rows: a fixed stride, then a fixed
  // tree
  {
    float s = 0.f;
    const int r0 = tile0 * kBlock;
    const int r1 = min(N, tile1 * kBlock);
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) s += ds[r];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red2[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red2[w];
      part[partial_size(D, H) - 1] = t;
    }
  }

  // The h chunk of a row tile -> dh in shared memory (and, when asked,
  // this lane's shares of dw2 and db1).
  auto make_dh = [&](const float (&acc)[kHTiles][4], int row0, int j0,
                     float (*dw2p)[2], float (*db1p)[2]) {
#pragma unroll
    for (int nt = 0; nt < kHTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = warp * 16 + g + 8 * (i >> 1);
        const int jl = nt * 8 + 2 * tq + (i & 1);
        const int j = j0 + jl;
        float dh = 0.f;
        if (j < H) {
          const float h = hidden(acc[nt][i], b1, j);
          const float d = dss[rl];
          dh = h > 0.f ? bf16_round(d * bf(w2[j])) : 0.f;
          if (dw2p) {
            dw2p[nt][i & 1] = fmaf(h, bf16_round(d), dw2p[nt][i & 1]);
            db1p[nt][i & 1] += dh;
          }
        }
        dhs[rl * kHStride + jl] = __float2bfloat16_rn(dh);
      }
    }
  };

  auto load_ds = [&](int row0) {
    for (int i = threadIdx.x; i < kBlock; i += kThreads)
      dss[i] = row0 + i < N ? ds[row0 + i] : 0.f;
  };

  // pass 1: dw1, dw2, db1, block by block of dw1
  for (int dc = 0; dc < (kChunked ? D : 1); dc += kDPad) {
    for (int j0 = 0; j0 < H; j0 += kHN) {
      float dw1[kDw1Tiles][4];
      float dw2p[kHTiles][2], db1p[kHTiles][2];
#pragma unroll
      for (int t = 0; t < kDw1Tiles; ++t)
        dw1[t][0] = dw1[t][1] = dw1[t][2] = dw1[t][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < kHTiles; ++nt)
        dw2p[nt][0] = dw2p[nt][1] = db1p[nt][0] = db1p[nt][1] = 0.f;
      for (int tile = tile0; tile < tile1; ++tile) {
        const int row0 = tile * kBlock;
        float acc[kHTiles][4];
        hidden_chunk<kDPad, kChunked>(acc, xs, w1s, x, w1, row0, N, D, H, j0,
                                      true, resident, ws);
        load_ds(row0);
        __syncthreads();
        make_dh(acc, row0, j0, dc == 0 ? dw2p : nullptr, db1p);
        if (kChunked && dc != last_c) {
          __syncthreads();
          load_tile<kDPad, kXStride, false>(xs, x, row0, N, 1, D, 0, 1.f,
                                            dc);
        }
        __syncthreads();
        // dw1 += x^T . dh over the 64 rows of the tile
#pragma unroll
        for (int t = 0; t < kDw1Tiles; ++t) {
          const int tt = warp * kDw1Tiles + t;
          const int mt = tt / kHTiles;
          const int nt = tt % kHTiles;
#pragma unroll
          for (int kk = 0; kk < kBlock / 16; ++kk) {
            uint32_t a[4];
            a_frag_t(a, xs, kXStride, mt * 16, kk);
            mma_kn(dw1[t], a, dhs, kHStride, nt * 8, kk);
          }
        }
      }
      // this CTA's block of dw1
#pragma unroll
      for (int t = 0; t < kDw1Tiles; ++t) {
        const int tt = warp * kDw1Tiles + t;
        const int mt = tt / kHTiles;
        const int nt = tt % kHTiles;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = dc + mt * 16 + g + 8 * (i >> 1);
          const int j = j0 + nt * 8 + 2 * tq + (i & 1);
          if (d < D && j < H)
            part[static_cast<long long>(d) * H + j] = dw1[t][i];
        }
      }
      if (dc == 0) {
        // dw2 and db1 of the chunk: the eight lanes of a column pair in
        // a fixed tree, then the warps in order
#pragma unroll
        for (int nt = 0; nt < kHTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a = dw2p[nt][e];
            float b = db1p[nt][e];
            for (int off = 4; off < 32; off <<= 1) {
              a += __shfl_xor_sync(0xffffffffu, a, off);
              b += __shfl_xor_sync(0xffffffffu, b, off);
            }
            if (g == 0) {
              red[warp * kHN + nt * 8 + 2 * tq + e] = a;
              red[(kWarps + warp) * kHN + nt * 8 + 2 * tq + e] = b;
            }
          }
        }
        __syncthreads();
        for (int jl = threadIdx.x; jl < kHN; jl += kThreads) {
          if (j0 + jl >= H) continue;
          float a = 0.f, b = 0.f;
          for (int w = 0; w < kWarps; ++w) {
            a += red[w * kHN + jl];
            b += red[(kWarps + w) * kHN + jl];
          }
          part_dw2[j0 + jl] = a;
          part_db1[j0 + jl] = b;
        }
      }
    }
  }

  // pass 2: dx = dh . w1^T, row tile by row tile
  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * kBlock;
    for (int dc = 0; dc < (kChunked ? D : 1); dc += kDPad) {
      float dxa[kDxTiles][4];
#pragma unroll
      for (int nt = 0; nt < kDxTiles; ++nt)
        dxa[nt][0] = dxa[nt][1] = dxa[nt][2] = dxa[nt][3] = 0.f;
      for (int j0 = 0; j0 < H; j0 += kHN) {
        float acc[kHTiles][4];
        hidden_chunk<kDPad, kChunked>(acc, xs, w1s, x, w1, row0, N, D, H, j0,
                                      j0 == 0 && dc == 0, resident, ws);
        if (j0 == 0 && dc == 0) load_ds(row0);
        __syncthreads();
        make_dh(acc, row0, j0, nullptr, nullptr);
        if (kChunked && dc != last_c) {
          __syncthreads();
          load_w1<kDPad>(w1s, w1, D, H, dc, j0);
        }
        __syncthreads();
        const __nv_bfloat16* wt = resident ? w1s + j0 : w1s;
        const int wst = resident ? ws : kHStride;
#pragma unroll
        for (int kk = 0; kk < kHN / 16; ++kk) {
          uint32_t a[4];
          a_frag(a, dhs, kHStride, warp * 16, kk);
#pragma unroll
          for (int nt = 0; nt < kDxTiles; ++nt)
            mma_nk(dxa[nt], a, wt, wst, nt * 8, kk);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + warp * 16 + g + 8 * r;
        if (row >= N) continue;
        __nv_bfloat16* out = dx + static_cast<long long>(row) * D;
#pragma unroll
        for (int nt = 0; nt < kDxTiles; ++nt) {
          const int d = dc + nt * 8 + 2 * tq;
          if (d < D)
            *reinterpret_cast<uint32_t*>(out + d) =
                pack_bf16(dxa[nt][2 * r], dxa[nt][2 * r + 1]);
        }
      }
    }
  }
}

// out[e] = sum over the CTAs' partials in CTA order.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, long long n,
                                    int ctas) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += partials[c * n + e];
  out[e] = s;
}

// ---------------------------------------------------------------------------
// The tensor-core route of both kernels: D <= 128 (the wrapper's D, a
// multiple of 8) and H <= 256, which holds both of the main path's shapes.
// Every other width keeps score_head_fwd_kernel and score_head_bwd_kernel
// above.  The route is chosen here by D and H alone (tc_route; the
// wrapper asks the library, agac_score_head_tc_route, and keeps no copy).
//
// K11 on the tensor cores:
//
// - Persistent CTAs of one warpgroup, as many as the card holds at once
//   (two an SM at both main-path shapes), CTA c taking row tiles c, c +
//   grid, ...  Each copies w1 once into shared memory, zero past D (to
//   kDPad) and past H (to whole 64-unit chunks), in boxes of 64 hidden
//   units x kDPad rows of d, 128 bytes a row, each row's 16-byte chunks
//   placed as a 128-byte-swizzled TMA box would place them.  That one
//   copy is the MN-major B of h = x . w1 (K = d, N = the chunk's 64
//   units) and the K-major B of dx = dh . w1^T (K = the chunk's units,
//   N = d).  b1 (bf16 pairs) and w2 (f32 pairs) go there too.
// - x tiles come by TMA (a map over [N, D], zero past N and D) into a
//   ring of kTcStages stages, one thread issuing; each lane reads ds of
//   its two rows a tile ahead.
// - Per row tile the hidden layer is computed once, chunk by chunk: h =
//   wgmma m64n64k16 over D in ascending k16 steps from a zeroed
//   accumulator (the parent's hidden_chunk chain); the epilogue gives h,
//   the gate and dh = bf16(h > 0 ? ds w2 : 0); dh is packed into A
//   fragments (pack_acc's layout) and dx += dh . w1^T runs as wgmma RS
//   over the chunk's four k16 steps, dx's accumulator carried across the
//   chunks in ascending order (the parent's pass-2 chain).  The probe
//   tests/test_torch_cuda.py::test_score_head_wgmma_forms_sum_as_mma_sync
//   holds both forms to mma.sync m16n8k16 bit for bit, so dx and the gates
//   keep the parent's values.
// - The weight gradients come from the same dh: dh goes to shared memory
//   in the swizzled MN-major layout, and dw1^T += dh^T . x is wgmma with
//   both operands MN-major over the tile's 64 rows (any order: the
//   weight gradients have no bit contract, only
//   score_head_weight_grad_limits); dw2 and db1 add up in each lane's
//   registers in a fixed order, db2 likewise.
// - Registers: dw1^T of a hidden chunk takes kDPad / 2 f32 a thread, its
//   dw2 and db1 shares 32.  A sweep over the CTA's tiles holds the weight
//   gradients of kSweepChunks chunks (2 for kDPad <= 32, else 1); the
//   first sweep also gives dx (and so computes every chunk's h), each
//   later one recomputes the h of its own chunks only.  At D = 32, H =
//   128 that is one sweep (6 N D H flops); at D = 128, H = 256 four (7.5
//   N D H flops, x read four times).
// - No float atomics: each CTA writes one f32 partial (dw1 [D, H], db1,
//   dw2, db2), which sum_partials_kernel adds in CTA order, so two runs
//   agree bit for bit.
constexpr int kTcStages = 2;       // x tiles in flight a CTA
constexpr int kTcMaxSmem = 227 * 1024;   // the H100's per-CTA limit
constexpr int kTcMaxH = 256;       // the route's widest hidden layer
constexpr int kDhBytes = kBlock * 128;   // a dh chunk: 64 rows x 64 units

__host__ __device__ inline bool tc_route(int D, int H) {
  return D <= kMaxDPad && H <= kTcMaxH;
}

// a box of w1 in shared memory: 64 units x kDPad rows of d, 128 bytes a
// row
template <int kDPad>
constexpr int kW1BoxBytes = kDPad * 128;

template <int kDPad>
struct TcBwd {
  using L = SwizzledTile<kDPad>;   // an x tile as TMA writes it
  static constexpr int kSweepChunks = kDPad <= 32 ? 2 : 1;
  static constexpr int kW1Box = kW1BoxBytes<kDPad>;
  static constexpr int kDTiles = kDPad / 8;     // n-tiles of dx, dw1^T
  static constexpr int kDxN = kDPad < 64 ? kDPad : 64;   // dx's groups
};

__host__ __device__ inline int hidden_chunks(int H) {
  return (H + kHN - 1) / kHN;
}

// x stages, dh chunks, w1's boxes, b1 and w2, the cross-warp sums, the
// barriers, and 1 KB to align the swizzled tiles.
template <int kDPad>
__host__ __device__ inline int bwd_tc_smem_bytes(int H) {
  using S = TcBwd<kDPad>;
  const int chunks = hidden_chunks(H);
  return 1024 + kTcStages * S::L::kBytes + S::kSweepChunks * kDhBytes +
         chunks * S::kW1Box + chunks * kHN * (2 + 4) +
         4 * (2 * kWarps * kHN + kWarps) + 8 * kTcStages;
}

// relu(bf16(bf16(a) + b)) of a column pair, packed (bf16x2 instructions:
// the add rounds the exact sum of two bf16 numbers once, where hidden()
// rounds it to f32 first, which is innocuous at 24 >= 2 * 8 + 2 bits, so
// both give the same bf16: mlp.cu's layer_out)
__device__ __forceinline__ uint32_t hidden_pair(float a0, float a1,
                                                __nv_bfloat162 bias) {
  const __nv_bfloat162 v = __hmax2(
      __hadd2(__floats2bfloat162_rn(a0, a1), bias), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_bf(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// w1 [D, H] into chunks of 64 units x kDPad rows (128 bytes a row, the
// 16-byte chunk j of row d at j ^ (d % 8)), zero past D and H; b1 as bf16
// pairs and w2 as f32 pairs, zero past H; by the first kCta threads of
// the CTA, each with kBatch loads in flight before its stores.
template <int kDPad, int kCta = kThreads>
__device__ __forceinline__ void copy_weights(
    uint8_t* w1s, __nv_bfloat162* b1s, float2* w2s,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, int D, int H, int chunks) {
  constexpr int kBatch = 8;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(w1);
  const bool vec = H % 8 == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  const int per_row = chunks * 8;   // 16-byte chunks a row of d
  const int n = kDPad * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kCta) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kCta;
      const int d = i / per_row;
      const int j = i - d * per_row;   // columns [8 j, 8 j + 8)
      v[b] = make_uint4(0, 0, 0, 0);
      if (i < n && d < D && 8 * j < H) {
        const long long at = static_cast<long long>(d) * H + 8 * j;
        if (vec) {
          v[b] = *reinterpret_cast<const uint4*>(src + at);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t lo = 8 * j + 2 * e < H ? src[at + 2 * e] : 0u;
            const uint32_t hi =
                8 * j + 2 * e + 1 < H ? src[at + 2 * e + 1] : 0u;
            w[e] = lo | (hi << 16);
          }
          v[b] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kCta;
      const int d = i / per_row;
      const int j = i - d * per_row;
      if (i < n)
        *reinterpret_cast<uint4*>(w1s + (j / 8) * kW1BoxBytes<kDPad> +
                                  d * 128 + (((j % 8) ^ (d % 8)) << 4)) = v[b];
    }
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int p = threadIdx.x; p < chunks * kHN / 2; p += kCta) {
    const int j = 2 * p;
    b1s[p] = __halves2bfloat162(j < H ? b1[j] : zero,
                                j + 1 < H ? b1[j + 1] : zero);
    w2s[p] = make_float2(j < H ? bf(w2[j]) : 0.f,
                         j + 1 < H ? bf(w2[j + 1]) : 0.f);
  }
}

template <int kDPad>
__global__ void __launch_bounds__(kThreads, 2) score_head_bwd_tc_kernel(
    const __grid_constant__ CUtensorMap x_map, const float* __restrict__ ds,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partials, int N, int D, int H) {
  using S = TcBwd<kDPad>;
  using L = typename S::L;
  constexpr int kSC = S::kSweepChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* dhs = xs + kTcStages * L::kBytes;
  uint8_t* w1s = dhs + kSC * kDhBytes;
  const int chunks = hidden_chunks(H);
  __nv_bfloat162* b1s =
      reinterpret_cast<__nv_bfloat162*>(w1s + chunks * S::kW1Box);
  float2* w2s = reinterpret_cast<float2*>(b1s + chunks * kHN / 2);
  float* red = reinterpret_cast<float*>(w2s + chunks * kHN / 2);
  float* red2 = red + 2 * kWarps * kHN;
  uint64_t* full = reinterpret_cast<uint64_t*>(red2 + kWarps);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int lr = warp * 16 + g;   // this lane's rows lr and lr + 8
  const int n_tiles = (N + kBlock - 1) / kBlock;
  const int my_tiles =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int sweeps = (chunks + kSC - 1) / kSC;
  const int items = sweeps * my_tiles;
  auto row_of = [&](int item) {
    return (blockIdx.x + (item % my_tiles) * gridDim.x) * kBlock;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  copy_weights<kDPad>(w1s, b1s, w2s, w1, b1, w2, D, H, chunks);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kTcStages && i < items; ++i)
      tma_tile<kDPad>(xs + i * L::kBytes, &x_map, 0, row_of(i), full + i);

  const uint64_t w1d = gmma_desc<128>(w1s);
  float* part = partials + blockIdx.x * partial_size(D, H);
  float db2 = 0.f;
  // ds of this lane's two rows, read a tile ahead
  auto load_ds = [&](int item, float (&v)[2]) {
    const int row = row_of(item) + lr;
    v[0] = row < N ? ds[row] : 0.f;
    v[1] = row + 8 < N ? ds[row + 8] : 0.f;
  };
  float ds_next[2];
  load_ds(0, ds_next);
  int item = 0;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const int c_lo = sweep * kSC;                 // weight gradients of
    const int c_hi = min(chunks, c_lo + kSC);     // chunks [c_lo, c_hi)
    const int c_end = sweep == 0 ? chunks : c_hi;
    float dw1[kSC][S::kDTiles][4];
    float dw2p[kSC][8][2], db1p[kSC][8][2];
#pragma unroll
    for (int q = 0; q < kSC; ++q) {
#pragma unroll
      for (int t = 0; t < S::kDTiles; ++t)
        dw1[q][t][0] = dw1[q][t][1] = dw1[q][t][2] = dw1[q][t][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        dw2p[q][nt][0] = dw2p[q][nt][1] = db1p[q][nt][0] =
            db1p[q][nt][1] = 0.f;
    }
    for (int t = 0; t < my_tiles; ++t, ++item) {
      const int stage = item % kTcStages;
      const int row0 = row_of(item);
      const float ds_r[2] = {ds_next[0], ds_next[1]};
      if (item + 1 < items) load_ds(item + 1, ds_next);
      if (sweep == 0 && tq == 0) db2 += ds_r[0] + ds_r[1];
      float dxa[S::kDTiles][4];
#pragma unroll
      for (int nt = 0; nt < S::kDTiles; ++nt)
        dxa[nt][0] = dxa[nt][1] = dxa[nt][2] = dxa[nt][3] = 0.f;
      mbar_wait(full + stage, (item / kTcStages) & 1);
      const uint64_t xd = gmma_desc<L::kSwz>(xs + stage * L::kBytes);

      for (int c = sweep == 0 ? 0 : c_lo; c < c_end; ++c) {
        // h chunk = x . w1[:, 64 c : 64 c + 64], k16 steps over D in order
        float h[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
        fence_acc(h);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDPad / 16; ++kk)
          wgmma_ss<64, false, true, 0>(
              h, xd + (L::k_step(kk) >> 4),
              w1d + ((c * S::kW1Box + kk * 16 * 128) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(h);

        // the epilogue: h, its gate, dh; this sweep's dw2 and db1 shares
        uint32_t dhp[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int pair = c * (kHN / 2) + 4 * nt + tq;
          const __nv_bfloat162 bias = b1s[pair];
          const float2 wv = w2s[pair];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float d = ds_r[r];
            const uint32_t hv = hidden_pair(h[nt][2 * r], h[nt][2 * r + 1],
                                            bias);
            const float h0 = lo_bf(hv), h1 = hi_bf(hv);
            const float dh0 = h0 > 0.f ? bf16_round(d * wv.x) : 0.f;
            const float dh1 = h1 > 0.f ? bf16_round(d * wv.y) : 0.f;
            dhp[nt][r] = pack_bf16(dh0, dh1);
            const float db = bf16_round(d);
#pragma unroll
            for (int q = 0; q < kSC; ++q) {
              if (c == c_lo + q) {
                dw2p[q][nt][0] = fmaf(h0, db, dw2p[q][nt][0]);
                dw2p[q][nt][1] = fmaf(h1, db, dw2p[q][nt][1]);
                db1p[q][nt][0] += dh0;
                db1p[q][nt][1] += dh1;
              }
            }
          }
        }

        // dh to shared memory for dw1 (the slot's last reader, the
        // previous tile's dw1 product, has completed)
        if (c >= c_lo && c < c_hi) {
          uint8_t* slot = dhs + (c - c_lo) * kDhBytes;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = lr + 8 * r;
              *reinterpret_cast<uint32_t*>(
                  slot + row * 128 + ((nt ^ (row % 8)) << 4) + 4 * tq) =
                  dhp[nt][r];
            }
        }

        if (sweep == 0) {
          // dx += dh . w1^T over the chunk's four k16 steps, in order
          fence_acc(dxa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t a[4] = {dhp[2 * kk][0], dhp[2 * kk][1],
                                   dhp[2 * kk + 1][0], dhp[2 * kk + 1][1]};
            wgmma_rs_groups<S::kDxN, kDPad / S::kDxN, 64 * 128, false>(
                dxa, a, w1d + ((c * S::kW1Box + kk * 32) >> 4));
          }
          // completed by the next chunk's wait, or the one below
          wgmma_commit();
        }
      }

      if (sweep == 0) {
        wgmma_wait<0>();
        fence_acc(dxa);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + lr + 8 * r;
          if (row >= N) continue;
          __nv_bfloat16* out = dx + static_cast<long long>(row) * D;
#pragma unroll
          for (int nt = 0; nt < S::kDTiles; ++nt) {
            const int d = nt * 8 + 2 * tq;
            if (d < D)
              *reinterpret_cast<uint32_t*>(out + d) =
                  pack_bf16(dxa[nt][2 * r], dxa[nt][2 * r + 1]);
          }
        }
      }

      // dw1^T += dh^T . x over the tile's 64 rows
      fence_proxy_async();
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kSC; ++q) fence_acc(dw1[q]);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kSC; ++q) {
        if (c_lo + q < c_hi) {
          const uint64_t dd = gmma_desc<128>(dhs + q * kDhBytes);
#pragma unroll
          for (int kk = 0; kk < kBlock / 16; ++kk)
            wgmma_ss_groups<L::kBoxCols, L::kBoxes, true, true,
                            L::kBoxBytes>(
                dw1[q], dd + ((kk * 16 * 128) >> 4),
                xd + ((kk * 16 * L::kSwz) >> 4));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < kSC; ++q) fence_acc(dw1[q]);
      __syncthreads();   // the stage and the dh chunks are read
      if (threadIdx.x == 0 && item + kTcStages < items)
        tma_tile<kDPad>(xs + stage * L::kBytes, &x_map, 0,
                        row_of(item + kTcStages), full + stage);
    }

    // this sweep's chunks into the CTA's partial: dw1 from the
    // accumulators; dw2 and db1 over the eight lanes of a column pair in
    // a fixed tree, then the warps in order
    float* part_db1 = part + static_cast<long long>(D) * H;
    float* part_dw2 = part_db1 + H;
#pragma unroll
    for (int q = 0; q < kSC; ++q) {
      const int c = c_lo + q;
      if (c >= c_hi) continue;
#pragma unroll
      for (int nt = 0; nt < S::kDTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = c * kHN + lr + 8 * (i >> 1);
          const int d = nt * 8 + 2 * tq + (i & 1);
          if (j < H && d < D)
            part[static_cast<long long>(d) * H + j] = dw1[q][nt][i];
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = dw2p[q][nt][e];
          float b = db1p[q][nt][e];
          for (int off = 4; off < 32; off <<= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, off);
            b += __shfl_xor_sync(0xffffffffu, b, off);
          }
          if (g == 0) {
            red[warp * kHN + nt * 8 + 2 * tq + e] = a;
            red[(kWarps + warp) * kHN + nt * 8 + 2 * tq + e] = b;
          }
        }
      __syncthreads();
      for (int jl = threadIdx.x; jl < kHN; jl += kThreads) {
        if (c * kHN + jl >= H) continue;
        float a = 0.f, b = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          a += red[w * kHN + jl];
          b += red[(kWarps + w) * kHN + jl];
        }
        part_dw2[c * kHN + jl] = a;
        part_db1[c * kHN + jl] = b;
      }
      __syncthreads();
    }
  }
  // db2: this CTA's rows, each counted by its quad's first lane
  for (int off = 16; off > 0; off >>= 1)
    db2 += __shfl_xor_sync(0xffffffffu, db2, off);
  if (lane == 0) red2[warp] = db2;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red2[w];
    part[partial_size(D, H) - 1] = t;
  }
}

// ---------------------------------------------------------------------------
// K10 on the tensor cores (tc_route's widths):
//
// - Persistent CTAs, one an SM, of kConsumers = 4 warpgroups and one
//   producer warp, CTA c taking row tiles c, c + grid, ..., its consumer
//   warpgroup k every fourth of them from the k-th.  The consumers copy
//   w1, b1 and w2 once into shared memory with K11's copy_weights (w1 in
//   its 128-byte-swizzled boxes of 64 units, the MN-major B of h =
//   x . w1), one copy for the CTA.  Four consumers, not two, because a
//   warpgroup's chain of k16 products runs serially on the tensor cores:
//   on the H100 two took K10 at D = 128, H = 256 to 0.0605 ms, three to
//   0.0550 and four to 0.0517 (kernels/chip_checks.py head); at D = 32
//   two CTAs of two an SM ran as fast as one of four.
// - The producer warp streams the CTA's x tiles by TMA (a map over
//   [N, D], zero past N and D) into a ring of kStages stages, each with a
//   full mbarrier (the copy landed) and an empty one (the consuming
//   warpgroup's four warps have seen the last product that reads it
//   complete), so up to kStages tiles (128 KB) are in flight a CTA while
//   the consumers compute.
// - A consumer runs its (tile, hidden chunk) items in order through two
//   accumulators: item i + 1's h = wgmma m64n64k16 over D in ascending
//   k16 steps from a zeroed accumulator (the CUDA-core route's
//   hidden_chunk chain, which
//   tests/test_torch_cuda.py::test_score_head_wgmma_forms_sum_as_mma_sync
//   holds to mma.sync bit for bit) is issued before item i's epilogue,
//   so the tensor cores run under it.  An accumulator is written only
//   before its product's issue and read only after its wait, and every
//   path through the loop issues and waits alike: ptxas serialises every
//   wgmma of a kernel (its note C7518) once a branch decides how many
//   products are in flight.
// - The epilogue folds h . w2 into the same two f32 shares a lane as the
//   CUDA-core route, in the same order (fold_chunk), with b1 and w2 read
//   from shared memory; then the same shuffles and roundings, so the
//   scores are the CUDA-core route's bit for bit.
// - One launch a call, no partials, no atomics.
template <int kDPad>
struct TcFwd {
  using L = SwizzledTile<kDPad>;   // an x tile as TMA writes it
  static constexpr int kKSteps = kDPad / 16;   // k16 steps of h over D
  static constexpr int kConsumers = 4;         // warpgroups a CTA
  static constexpr int kCtaThreads = kConsumers * kThreads + 32;
  // the x ring, 128 KB beside w1's 64 KB at most: a power of two of
  // stages, 8 at kDPad = 128
  static constexpr int kStages = 128 * 1024 / L::kBytes;
};

// x stages, w1's boxes, b1 and w2, and the full and empty barriers.
template <int kDPad>
__host__ __device__ inline int fwd_tc_smem_bytes(int H) {
  using S = TcFwd<kDPad>;
  const int chunks = hidden_chunks(H);
  return S::kStages * S::L::kBytes + chunks * kW1BoxBytes<kDPad> +
         chunks * kHN * (2 + 4) + 16 * S::kStages;
}

// part[r] += h . w2 over the units [64 c, 64 c + 64) of hidden chunk c
// for this lane's rows lr + 8 r, n-tiles in ascending order, the lower
// column of a pair first: the CUDA-core route's order.  With kTail (the
// chunk holds units past H) those units are skipped, as there (a
// zero-padded unit would add +0, but NaN where x holds an infinity).
template <bool kTail>
__device__ __forceinline__ void fold_units(float (&part)[2],
                                           const float (&h)[8][4],
                                           const __nv_bfloat162* b1s,
                                           const float2* w2s, int c, int H) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int pair = c * (kHN / 2) + 4 * nt + tq;
    const __nv_bfloat162 bias = b1s[pair];
    const float2 wv = w2s[pair];
    const int j = 2 * pair;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t v = hidden_pair(h[nt][2 * r], h[nt][2 * r + 1], bias);
      if (!kTail || j < H) part[r] = fmaf(lo_bf(v), wv.x, part[r]);
      if (!kTail || j + 1 < H) part[r] = fmaf(hi_bf(v), wv.y, part[r]);
    }
  }
}

__device__ __forceinline__ void fold_chunk(float (&part)[2],
                                           const float (&h)[8][4],
                                           const __nv_bfloat162* b1s,
                                           const float2* w2s, int c, int H) {
  if ((c + 1) * kHN <= H)
    fold_units<false>(part, h, b1s, w2s, c, H);
  else
    fold_units<true>(part, h, b1s, w2s, c, H);
}

template <int kDPad>
__global__ void __launch_bounds__(TcFwd<kDPad>::kCtaThreads, 1)
    score_head_fwd_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ b1,
                             const __nv_bfloat16* __restrict__ w2,
                             const __nv_bfloat16* __restrict__ b2,
                             float* __restrict__ out, int N, int D, int H) {
  using S = TcFwd<kDPad>;
  using L = typename S::L;
  constexpr int kStages = S::kStages;
  constexpr int kC = S::kConsumers;
  // the tiles must start on 1024 bytes, the span of a 128-byte swizzle's
  // atom: the dynamic shared memory of a kernel with no static shared
  // memory does (as in flash_attention.cu), and a launch where it did not
  // would trap here.  Declared __shared__, so b1 and w2 are read by
  // shared-memory loads.
  extern __shared__ __align__(1024) uint8_t fwd_smem[];
  if (smem_u32(fwd_smem) % 1024) __trap();
  uint8_t* xs = fwd_smem;
  uint8_t* w1s = xs + kStages * L::kBytes;
  const int chunks = hidden_chunks(H);
  __nv_bfloat162* b1s =
      reinterpret_cast<__nv_bfloat162*>(w1s + chunks * kW1BoxBytes<kDPad>);
  float2* w2s = reinterpret_cast<float2*>(b1s + chunks * kHN / 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(w2s + chunks * kHN / 2);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (N + kBlock - 1) / kBlock;
  const int my_tiles =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto row_of = [&](int t) {
    return (blockIdx.x + t * gridDim.x) * kBlock;
  };

  const bool producer = warp == kC * kWarps;
  if (producer) {
    // the first tiles' loads run under the weights' copy
    if (lane == 0) {
      for (int i = 0; i < kStages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, kWarps);
      }
      mbar_init_fence();
      for (int t = 0; t < kStages && t < my_tiles; ++t)
        tma_tile<kDPad>(xs + t * L::kBytes, &x_map, 0, row_of(t), full + t);
    }
  } else {
    copy_weights<kDPad, kC * kThreads>(w1s, b1s, w2s, w1, b1, w2, D, H,
                                       chunks);
    fence_proxy_async();
  }
  __syncthreads();
  if (producer) {
    // each later tile into the stage of the tile kStages before it, once
    // that tile's warpgroup has released it
    if (lane == 0)
      for (int t = kStages; t < my_tiles; ++t) {
        const int stage = t % kStages;
        mbar_wait(empty + stage, (t / kStages - 1) & 1);
        tma_tile<kDPad>(xs + stage * L::kBytes, &x_map, 0, row_of(t),
                        full + stage);
      }
    return;
  }

  // An item: local tile t (this warpgroup's are wg, wg + kC, ...) and
  // hidden chunk c, in order.
  struct Item {
    int t, c;
  };
  const int wg = warp / kWarps;
  auto next = [&](Item it) {
    return it.c + 1 == chunks ? Item{it.t + kC, 0} : Item{it.t, it.c + 1};
  };
  const int tq = lane % 4;
  const int lr = warp % kWarps * 16 + lane / 4;   // rows lr, lr + 8
  const uint64_t w1d = gmma_desc<128>(w1s);
  const uint64_t x0d = gmma_desc<L::kSwz>(xs);    // stage 0
  const uint64_t spare = gmma_desc<L::kSwz>(w1s);
  const float b2v = bf(b2[0]);
  float part[2] = {0.f, 0.f};

  // h of item it = x tile . w1[:, 64 c : 64 c + 64], issued, not awaited.
  // Past the CTA's last tile a product of w1's first box by itself, never
  // read (so the loop below issues and waits alike on every path, and no
  // product runs serialised).
  auto issue = [&](float (&h)[8][4], Item it) {
    const bool real = it.t < my_tiles;
    const int stage = it.t % kStages;
    if (real && it.c == 0) mbar_wait(full + stage, (it.t / kStages) & 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
    fence_acc(h);
    wgmma_fence();
    const uint64_t xd = real ? x0d + stage * (L::kBytes >> 4) : spare;
    const int c = real ? it.c : 0;
#pragma unroll
    for (int kk = 0; kk < S::kKSteps; ++kk)
      wgmma_ss<64, false, true, 0>(
          h, xd + (L::k_step(kk) >> 4),
          w1d + ((c * kW1BoxBytes<kDPad> + kk * 16 * 128) >> 4));
    wgmma_commit();
  };

  // item it's epilogue, once its product has completed
  auto finish = [&](float (&h)[8][4], Item it) {
    fence_acc(h);
    const int c = it.c;
    const bool last = c == chunks - 1;
    // no product reads the tile's stage any more: hand it back
    if (last && lane == 0) mbar_arrive(empty + it.t % kStages);
    fold_chunk(part, h, b1s, w2s, c, H);
    if (last) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p = part[r];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        const int row = row_of(it.t) + lr + 8 * r;
        if (tq == 0 && row < N) out[row] = bf16_round(bf16_round(p) + b2v);
        part[r] = 0.f;
      }
    }
  };

  // one product in flight across each epilogue: the next item's (or a
  // spare one) runs while this item folds
  float ha[8][4], hb[8][4];
  Item at{wg, 0};     // the next item to fold
  Item ahead = at;    // the next item to issue
  issue(ha, ahead);
  ahead = next(ahead);
  while (at.t < my_tiles) {
    issue(hb, ahead);
    ahead = next(ahead);
    wgmma_wait<1>();
    finish(ha, at);
    at = next(at);
    issue(ha, ahead);
    ahead = next(ahead);
    wgmma_wait<1>();
    if (at.t < my_tiles) {
      finish(hb, at);
      at = next(at);
    }
  }
  wgmma_wait<0>();
}

// A persistent grid: as many CTAs of `kernel` (`bytes` of shared memory
// each) as fit on the card at once, fewer when N rows make fewer tiles.
// A negative value is a CUDA error.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int bytes, unsigned* allowed,
                    int N) {
  int err = allow_smem(kernel, kTcMaxSmem, allowed, true);
  if (err) return -err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = std::max(1, (N + kBlock - 1) / kBlock);
  return std::min(n_tiles, sms * per_sm);
}

template <int kDPad>
int bwd_tc_grid(int N, int H) {
  static unsigned allowed = 0;
  return persistent_grid(score_head_bwd_tc_kernel<kDPad>, kThreads,
                         bwd_tc_smem_bytes<kDPad>(H), &allowed, N);
}

template <int kDPad>
int launch_fwd_tc(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, int N, int D,
                  int H, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int kCtaThreads = TcFwd<kDPad>::kCtaThreads;
  static unsigned allowed = 0;
  const int bytes = fwd_tc_smem_bytes<kDPad>(H);
  const int grid = persistent_grid(score_head_fwd_tc_kernel<kDPad>,
                                   kCtaThreads, bytes, &allowed, N);
  if (grid < 0) return -grid;
  CUtensorMap x_map;
  const int err = encode_head_tiles<kDPad>(&x_map, x, N, 1, D);
  if (err) return err;
  score_head_fwd_tc_kernel<kDPad><<<grid, kCtaThreads, bytes, stream>>>(
      x_map, static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<float*>(out), N, D, H);
  return static_cast<int>(cudaGetLastError());
}

template <int kDPad>
int launch_bwd_tc(const void* x, const void* ds, const void* w1,
                  const void* b1, const void* w2, void* dx, void* partials,
                  void* sums, int N, int D, int H, int ctas,
                  cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int grid = bwd_tc_grid<kDPad>(N, H);
  if (grid < 0) return -grid;
  if (grid != ctas) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map;
  int err = encode_head_tiles<kDPad>(&x_map, x, N, 1, D);
  if (err) return err;
  score_head_bwd_tc_kernel<kDPad>
      <<<ctas, kThreads, bwd_tc_smem_bytes<kDPad>(H), stream>>>(
          x_map, static_cast<const float*>(ds), static_cast<const bf16*>(w1),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
          static_cast<bf16*>(dx), static_cast<float*>(partials), N, D, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = partial_size(D, H);
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream>>>(static_cast<const float*>(partials),
                                  static_cast<float*>(sums), n, ctas);
  return static_cast<int>(cudaGetLastError());
}

// K11's grid: as many CTAs as fit on the card at once (occupancy x
// multiprocessors, at most kMaxCtasPerSm each), fewer when there are
// fewer row tiles, each CTA a contiguous run of tiles_per_cta.  A
// negative value is a CUDA error.
template <int kDPad, bool kChunked>
int bwd_grid(int N, int H, int* tiles_per_cta) {
  const int bytes = bwd_smem_bytes<kDPad, kChunked>(H);
  auto kernel = score_head_bwd_kernel<kDPad, kChunked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n_tiles = std::max(1, (N + kBlock - 1) / kBlock);
  const int ctas =
      std::min(n_tiles, sms * std::min(std::max(per_sm, 1), kMaxCtasPerSm));
  *tiles_per_cta = (n_tiles + ctas - 1) / ctas;
  return (n_tiles + *tiles_per_cta - 1) / *tiles_per_cta;
}

template <int kDPad, bool kChunked = false>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int N, int D, int H,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int blocks = (N + kBlock - 1) / kBlock;
  score_head_fwd_kernel<kDPad, kChunked><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<float*>(out), N, D, H);
  return static_cast<int>(cudaGetLastError());
}

template <int kDPad, bool kChunked = false>
int launch_bwd(const void* x, const void* ds, const void* w1, const void* b1,
               const void* w2, void* dx, void* partials, void* sums, int N,
               int D, int H, int ctas, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int per = 0;
  const int grid = bwd_grid<kDPad, kChunked>(N, H, &per);
  if (grid < 0) return -grid;
  if (grid != ctas) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = bwd_smem_bytes<kDPad, kChunked>(H);
  score_head_bwd_kernel<kDPad, kChunked><<<ctas, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ds),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(dx),
      static_cast<float*>(partials), N, D, H, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = partial_size(D, H);
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream>>>(static_cast<const float*>(partials),
                                  static_cast<float*>(sums), n, ctas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (ops/cuda_head.py) checks: x contiguous bf16 [N, D] with D a
// multiple of 8 (it pads other widths), 16-byte aligned; w1 [D, H], b1
// [H], w2 [H] (its [H, 1] column), b2 [1] contiguous bf16; out f32 [N].
extern "C" int agac_score_head_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int N, int D,
                                   int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(D, H)) {
    if (D <= 16)
      return launch_fwd_tc<16>(x, w1, b1, w2, b2, out, N, D, H, st);
    if (D <= 32)
      return launch_fwd_tc<32>(x, w1, b1, w2, b2, out, N, D, H, st);
    if (D <= 64)
      return launch_fwd_tc<64>(x, w1, b1, w2, b2, out, N, D, H, st);
    return launch_fwd_tc<128>(x, w1, b1, w2, b2, out, N, D, H, st);
  }
  if (D <= 16) return launch_fwd<16>(x, w1, b1, w2, b2, out, N, D, H, st);
  if (D <= 32) return launch_fwd<32>(x, w1, b1, w2, b2, out, N, D, H, st);
  if (D <= 64) return launch_fwd<64>(x, w1, b1, w2, b2, out, N, D, H, st);
  if (D <= kMaxDPad)
    return launch_fwd<128>(x, w1, b1, w2, b2, out, N, D, H, st);
  return launch_fwd<kMaxDPad, true>(x, w1, b1, w2, b2, out, N, D, H, st);
}

// The number of CTAs (so of per-CTA partials) agac_score_head_bwd runs
// for N rows of width D (a multiple of 8) and H hidden units; negative:
// a CUDA error.
extern "C" int agac_score_head_bwd_ctas(int N, int D, int H) {
  if (tc_route(D, H)) {
    if (D <= 16) return bwd_tc_grid<16>(N, H);
    if (D <= 32) return bwd_tc_grid<32>(N, H);
    if (D <= 64) return bwd_tc_grid<64>(N, H);
    return bwd_tc_grid<128>(N, H);
  }
  int per = 0;
  if (D <= 16) return bwd_grid<16, false>(N, H, &per);
  if (D <= 32) return bwd_grid<32, false>(N, H, &per);
  if (D <= 64) return bwd_grid<64, false>(N, H, &per);
  if (D <= kMaxDPad) return bwd_grid<128, false>(N, H, &per);
  return bwd_grid<kMaxDPad, true>(N, H, &per);
}

// ds f32 [N]; dx bf16 [N, D]; partials f32 [ctas, D H + 2 H + 1], ctas as
// agac_score_head_bwd_ctas gives it; sums f32 [D H + 2 H + 1] = dw1
// [D, H], db1 [H], dw2 [H], db2.
extern "C" int agac_score_head_bwd(const void* x, const void* ds,
                                   const void* w1, const void* b1,
                                   const void* w2, void* dx, void* partials,
                                   void* sums, int N, int D, int H, int ctas,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(D, H)) {
    if (D <= 16)
      return launch_bwd_tc<16>(x, ds, w1, b1, w2, dx, partials, sums, N, D,
                               H, ctas, st);
    if (D <= 32)
      return launch_bwd_tc<32>(x, ds, w1, b1, w2, dx, partials, sums, N, D,
                               H, ctas, st);
    if (D <= 64)
      return launch_bwd_tc<64>(x, ds, w1, b1, w2, dx, partials, sums, N, D,
                               H, ctas, st);
    return launch_bwd_tc<128>(x, ds, w1, b1, w2, dx, partials, sums, N, D, H,
                              ctas, st);
  }
  if (D <= 16)
    return launch_bwd<16>(x, ds, w1, b1, w2, dx, partials, sums, N, D, H,
                          ctas, st);
  if (D <= 32)
    return launch_bwd<32>(x, ds, w1, b1, w2, dx, partials, sums, N, D, H,
                          ctas, st);
  if (D <= 64)
    return launch_bwd<64>(x, ds, w1, b1, w2, dx, partials, sums, N, D, H,
                          ctas, st);
  if (D <= kMaxDPad)
    return launch_bwd<128>(x, ds, w1, b1, w2, dx, partials, sums, N, D, H,
                           ctas, st);
  return launch_bwd<kMaxDPad, true>(x, ds, w1, b1, w2, dx, partials, sums, N,
                                    D, H, ctas, st);
}

// 1 where agac_score_head_fwd and agac_score_head_bwd take their
// tensor-core route for rows of width D (a multiple of 8) and H hidden
// units, else 0.
extern "C" int agac_score_head_tc_route(int D, int H) {
  return tc_route(D, H) ? 1 : 0;
}
