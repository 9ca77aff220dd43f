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
// Products run on mma.sync m16n8k16 with bf16 operands and f32
// accumulators (flash_common.cuh); the h . w2 dot and the sums of dw2 and
// db1 run in f32 FMA on the accumulator layout, in a fixed order.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): K10 moves 2 N D + 4 N
// bytes (x in, scores out) and does 2 N D H (+ 2 N H) flops; K11 moves
// 4 N D + 4 N bytes (x and ds in, dx out) and does 6 N D H flops (h
// again, dw1, dx).  At N = 524,288, D = 32, H = 128 (the train command's
// defaults) that is 35.7 MB and 69 MB, bound by bytes at 10.6 and 20.7
// us; at N = 262,144, D = 128, H = 256 K10 is bound by bytes (68 MB,
// 20.3 us) and K11 by operations (51.5 GFLOP, 52 us).
//
// Design.  The TPU kernels walk a sequential grid of row blocks with the
// padded weights and (backward) the weight-gradient accumulators resident
// in VMEM.  Here rows go in tiles of 64 (4 warps of 16 rows), the hidden
// layer in chunks of kHN = 64 units and D in chunks of at most 128
// columns (kDPad = 16, 32, 64 or 128; wider heads loop over 128-column
// chunks), so any D and H run; x and w1 chunks stage through shared
// memory with the flash kernels' tile loader.
// - K10: one CTA a row tile; for each hidden chunk, the [64, kHN] h tile
//   is built in registers and folded into the running h . w2 of its rows.
// - K11: a persistent grid (as many CTAs as the card holds at once, at
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
//   tile at 2 CTAs an SM).  (No cp.async, TMA or wgmma: that is a faster
//   kernel's work.)
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
