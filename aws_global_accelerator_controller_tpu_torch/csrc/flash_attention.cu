// Kernels K6a and K6b: causal flash-attention forward, q, k, v [T, S, D]
// bf16 -> o [T, S, D] bf16, the S axis being independent heads (the
// temporal model's endpoint streams).
//
// K6a replaces the JAX package's ops/pallas_attention.py::_kernel (:287),
// launched by _flash (:359, pallas_call at :379): the forward alone, what
// inference runs.  K6b replaces _stats_kernel (:301) with normalize=True,
// launched by _flash_stats_padded (:816, pallas_call at :845) from the
// flash VJP's forward (_flash_fwd_padded :800): the same forward, which
// also writes the softmax stats the backward rebuilds p from, m (the row
// max) and l (the row sum), f32, one value per (head, row) in [S, T]
// layout (a 64-row block of one head is one contiguous run), and divides
// o by max(l, 1).  Every live row attends its key 0, so l >= 1 and K6b's
// o is K6a's bit for bit.  Padded rows are never written.
//
// Same arithmetic (the contract of _prescale :346 and _attend_step :197):
// q pre-scaled by D^-0.5 with one rounding to bf16; s = q'.k^T from bf16
// operands with f32 sums; masked scores -1e30 (causal by global
// position, keys past T); per K block m_new = max(m, rowmax s),
// p = exp(s - m_new) in f32, l = l * exp(m - m_new) + sum(p),
// acc = acc * exp(m - m_new) + bf16(p).v with f32 sums; o = acc / l
// rounded to bf16.  p is rounded against the running max, so the K block
// (64 keys here) is part of the result at the last-ulp level, and so is
// l; the plain versions take it as block_k.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16).  Causal work is
// 4 D flops for each of the T (T + 1) / 2 live (query, key) pairs of a
// head, against 8 T S D bytes of q, k, v and o (K6b adds 8 T S bytes of
// m and l):
// - T = 64, S = 1024, D = 32 (the eval command's defaults): 16.8 MB,
//   0.27 GFLOP, bound by bytes at 5.0 us; 8 flops a byte.
// - T = 2048, S = 128, D = 128: 268 MB, 137 GFLOP, bound by operations
//   at 0.139 ms; 512 flops a byte, above the card's ridge (~295).
// - T = 64, S = 8192, D = 32 (the train command's defaults, K6b): 138 MB,
//   bound by bytes at 41 us.
// - T = 1024, S = 64, D = 160: 84 MB, 21.5 GFLOP, bound by bytes at
//   25 us.
//
// Design.  The TPU kernel pads D to 128 lanes and T to (8, 128) tiles,
// transposes [T, S, D] to head-major twice around the call, and walks a
// grid of (head, q block, k block) with the running (m, l, acc) in VMEM
// scratch between grid steps.  Here, for D <= 256 (flash_fwd_tma_kernel):
// - Tiles by TMA.  q, k and v are read in place from the strided
//   [T, S, D] layout through 3-D tensor maps (D, S, T), encoded per call
//   on the host and passed by value: a 64-row tile of one head is one to
//   four boxes of 64 rows x 128 bytes (64 columns; one box of 32 or 64
//   bytes for D <= 16 or 32), swizzled as wgmma reads them, zero past T
//   and past D.  Widths run in classes of 16, 32, 64, 128, 160 and 256
//   columns.
// - A CTA is one consumer warpgroup (64 query rows) and one producer
//   warp.  The producer keeps the registers it launched with: a
//   setmaxnreg.dec there frees registers only for a setmaxnreg.inc in
//   the same CTA to take (a CTA's registers are allocated at launch, so
//   occupancy does not change), the .aligned form wants every warp of
//   the warpgroup, of which the producer is the only one, and an .inc
//   for the consumers hung on the card.  The producer's one lane
//   loads q once a tile and keeps a ring of two k/v stages in flight
//   under mbarriers (k and v full apart, one empty a stage), running
//   ahead into the next tile while the consumers finish this one.
// - The consumers round q to q' in place (fence.proxy.async and a
//   warpgroup barrier before any wgmma reads it), then per K block:
//   s = q'.k^T by wgmma m64n64k16 from shared memory (k K-major), one
//   wait, the online softmax in registers, and acc += bf16(p).v by wgmma
//   with p in registers (the s accumulators repacked by pack_acc) and v
//   MN-major (transposed) in shared memory, one instruction a box of
//   64 (32, 16) output columns, one wait.  A head up to 256 is one
//   full-width tile: s is formed once a block pair and q' rounded once a
//   tile.  The CTAs an SM (four at D <= 32, three at 64, two at 128,
//   one above) overlap one another's softmax and products; issuing the
//   next block's s before
//   this block's softmax made ptxas serialize every wgmma (C7515:
//   accumulators written between a product's issue and its wait) and
//   was slower.
// - The walk: a persistent grid of as many CTAs as fit on the card, each
//   taking tiles (head, q block) blockIdx.x, + gridDim.x, ... in the
//   order longest q block first, skipping K blocks wholly in a tile's
//   future.  It beat a CTA a tile at the last three shapes above (a
//   CTA a tile is ahead where 32 heads of T = 2048 leave the static
//   stride unbalanced).
// - Epilogue: o = acc / l by the exact fast division of flash_common.cuh
//   (div_reciprocal once a row, div_by on |acc| with the sign restored;
//   RN is symmetric, so this is RN(acc / l)), a warp with an operand out
//   of its exact range by `/`.
// - Bits.  A warpgroup product's accumulator is the mma.sync m16n8
//   layout repeated over n-tiles, and every output sees the k16 steps it
//   saw under mma.sync in the same order (s over D ascending, acc over
//   each block's four key steps), the row max and sum reduce over n-tiles
//   ascending then across lanes by xor 1, 2, and l and the alpha rescale
//   keep their order: since wgmma sums a k16 step as mma.sync does
//   (tests/test_torch_cuda.py::test_wgmma_sums_as_mma_sync), o, m and l
//   are value for value those of the mma.sync kernel this one replaced.
// - Registers (nvcc -Xptxas -v, sm_90a): 96 at D <= 32, 128 at 64, 168
//   at 128, 200 at 160, 231 at 256, no spills.
// D > 256 keeps that kernel (flash_fwd_chunked_kernel), dispatched by
// width alone: four warps own one (head, 64-row q block), stage k and v
// through shared memory with plain 16-byte loads, multiply by mma.sync
// m16n8k16, and run the head in 128-column output chunks (a grid
// dimension), each rebuilding s over every chunk of D, q' restaged with
// each K block.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// ---------------------------------------------------------------------------
// D <= 256: TMA-fed wgmma in a warp-specialised CTA.

constexpr int kConsumers = 128;               // one warpgroup
constexpr int kTmaThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;                    // k/v ring

// CTAs an SM the registers are bounded for: up to 102 a thread at
// D <= 32, 136 at 64, 204 at 128, 255 above (acc alone is D / 2 of them)
__host__ __device__ constexpr int tma_min_ctas(int d_pad) {
  return d_pad <= 32 ? 4 : d_pad <= 64 ? 3 : d_pad <= 128 ? 2 : 1;
}

template <int kDPad>
constexpr int tma_smem_bytes() {
  // q, kStages of k and of v, then the barriers
  return (1 + 2 * kStages) * SwizzledTile<kDPad>::kBytes +
         (2 + 3 * kStages) * 8;
}

// K blocks a tile of q block qb folds: up to its diagonal when causal
__device__ __forceinline__ int live_k_blocks(int qb, int n_kb, int causal) {
  return causal ? qb + 1 : n_kb;
}

// q' = bf16(q * scale) in place over a whole tile (every 16-byte chunk;
// zeros stay zeros), by the consumer warpgroup
template <int kBytes>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float scale) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kBytes / 16; i += kConsumers) {
    uint4* p = reinterpret_cast<uint4*>(tile) + i;
    uint4 val = *p;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    *p = val;
  }
}

// kStats: K6b (write m and l, divide by max(l, 1)); else K6a.
template <int kDPad, bool kStats>
__global__ void __launch_bounds__(kTmaThreads, tma_min_ctas(kDPad))
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ m_out,
                         float* __restrict__ l_out, int T, int S, int D,
                         float scale, int causal) {
  using L = SwizzledTile<kDPad>;
  constexpr int kKTiles = kBlock / 8;         // n-tiles of s over keys
  constexpr int kDTiles = L::kBoxes * L::kBoxCols / 8;   // of acc over D
  constexpr int kPvGroups = L::kBoxes;
  // the tiles must start on 1024 bytes, the span of a 128-byte swizzle's
  // atom: the dynamic shared memory of a kernel with no static shared
  // memory does, and a launch where it did not would trap here
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) % 1024) __trap();
  uint8_t* qs = smem_raw;
  uint8_t* ks = qs + L::kBytes;
  uint8_t* vs = ks + kStages * L::kBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers / 32);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(kv_empty + i, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_kb = (T + kBlock - 1) / kBlock;
  const int n_tiles = S * n_kb;

  if (threadIdx.x >= kConsumers) {
    // the producer: one lane issues every copy
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      uint32_t tiles = 0;
      for (int tile = blockIdx.x; tile < n_tiles;
           tile += gridDim.x, ++tiles) {
        const int qb = n_kb - 1 - tile / S;   // longest rows first
        const int s = tile % S;
        mbar_wait(q_empty, (tiles & 1) ^ 1);
        tma_tile<kDPad>(qs, &q_map, s, qb * kBlock, q_full);
        const int walk = live_k_blocks(qb, n_kb, causal);
        for (int kb = 0; kb < walk; ++kb) {
          const int k0 = kb * kBlock;
          mbar_wait(kv_empty + stage, phase ^ 1);
          tma_tile<kDPad>(ks + stage * L::kBytes, &k_map, s, k0,
                          k_full + stage);
          tma_tile<kDPad>(vs + stage * L::kBytes, &v_map, s, k0,
                          v_full + stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                      // row within the 8-row half
  const int tq = lane % 4;                     // column pair within a tile
  int stage = 0;
  uint32_t phase = 0;
  uint32_t tiles = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++tiles) {
    const int qb = n_kb - 1 - tile / S;
    const int s = tile % S;
    const int q0 = qb * kBlock;
    const int row0 = q0 + warp * 16 + g;       // this lane's two rows:
    const int row1 = row0 + 8;                 // row0 and row0 + 8

    mbar_wait(q_full, tiles & 1);
    scale_tile<L::kBytes>(qs, scale);
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const uint64_t q_desc = gmma_desc<L::kSwz>(qs);

    float row_m[2] = {kNegInf, kNegInf};
    float row_l[2] = {0.f, 0.f};
    float acc[kDTiles][4];
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    const int walk = live_k_blocks(qb, n_kb, causal);
    for (int kb = 0; kb < walk; ++kb) {
      const int k0 = kb * kBlock;

      // s = q' . k^T: 64 rows x 64 keys, k16 steps over D ascending (all
      // kDPad / 16 of them: a step past D adds zeros, and a run-time
      // bound would fence every step apart)
      float sc[kKTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      mbar_wait(k_full + stage, phase);
      const uint64_t k_desc = gmma_desc<L::kSwz>(ks + stage * L::kBytes);
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDPad / 16; ++kk)
        wgmma_ss64<0>(sc, q_desc + (L::k_step(kk) >> 4),
                      k_desc + (L::k_step(kk) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (kb == walk - 1) {   // q' is read for the last time: release it
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }

      // mask (only a block on the diagonal or past T has masked keys),
      // then the online softmax of _attend_step._fold
      if ((causal && kb == qb) || k0 + kBlock > T) {
#pragma unroll
        for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + nt * 8 + 2 * tq + (i & 1);
            const int row = (i < 2) ? row0 : row1;
            if (key >= T || (causal && key > row)) sc[nt][i] = kNegInf;
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
      }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(row_m[r], mx[r]);
        alpha[r] = expf(row_m[r] - m_new);
        row_m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[nt][i] = expf(sc[nt][i] - row_m[i >> 1]);
          rsum[i >> 1] += sc[nt][i];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
        row_l[r] = row_l[r] * alpha[r] + rsum[r];
      }
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }

      // acc += bf16(p) . v: the s accumulators of key tiles 2kk and
      // 2kk+1 are the A fragment of k-step kk; v's rows are the keys
      uint32_t pa[kBlock / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        pack_acc(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
      mbar_wait(v_full + stage, phase);
      const uint64_t v_desc = gmma_desc<L::kSwz>(vs + stage * L::kBytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        wgmma_rs_groups<L::kBoxCols, kPvGroups, L::kBoxBytes>(
            acc, pa[kk], v_desc + ((kk * 16 * L::kSwz) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // o = acc / l: every live row attended key 0, so l >= 1 (K6b divides
    // by max(l, 1), as _stats_kernel does, which is the same number)
    float den[2], rcp[2];
    bool fast = true;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] = kStats ? fmaxf(row_l[r], 1.f) : row_l[r];
      rcp[r] = div_reciprocal(den[r]);
      if ((r ? row1 : row0) < T) {
        fast &= den[r] >= 1.f && den[r] <= 0x1p24f;
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt)
          fast &= div_in_range(fabsf(acc[nt][2 * r])) &&
                  div_in_range(fabsf(acc[nt][2 * r + 1]));
      }
    }
    fast = __all_sync(0xffffffffu, fast);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row >= T) continue;
      if (kStats && tq == 0) {
        m_out[static_cast<long long>(s) * T + row] = row_m[r];
        l_out[static_cast<long long>(s) * T + row] = row_l[r];
      }
      __nv_bfloat16* orow = o + (static_cast<long long>(row) * S + s) * D;
      if (fast) {
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt) {
          const int d = nt * 8 + 2 * tq;
          const float a0 = acc[nt][2 * r], a1 = acc[nt][2 * r + 1];
          if (d < D)
            *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(
                copysignf(div_by(fabsf(a0), den[r], rcp[r]), a0),
                copysignf(div_by(fabsf(a1), den[r], rcp[r]), a1));
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt) {
          const int d = nt * 8 + 2 * tq;
          if (d < D)
            *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(
                acc[nt][2 * r] / den[r], acc[nt][2 * r + 1] / den[r]);
        }
      }
    }
  }
}

template <int kDPad, bool kStats>
int launch_tma(const void* q, const void* k, const void* v, void* o, void* m,
               void* l, int T, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_fwd_tma_kernel<kDPad, kStats>;
  constexpr int kSmem = tma_smem_bytes<kDPad>();
  static unsigned allowed = 0;
  static int ctas_per_sm[32] = {};
  int err = allow_smem(kernel, kSmem, &allowed, true);
  if (err) return err;
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (ctas_per_sm[dev] == 0) {
    int sms = 0, fit = 0;
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, kernel, kTmaThreads, kSmem));
    if (err) return err;
    ctas_per_sm[dev] = sms * (fit > 0 ? fit : 1);
  }
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = encode_head_tiles<kDPad>(maps + i, srcs[i], T, S, D);
    if (err) return err;
  }
  const long long n_tiles =
      static_cast<long long>(S) * ((T + kBlock - 1) / kBlock);
  const int grid = static_cast<int>(
      n_tiles < ctas_per_sm[dev] ? n_tiles : ctas_per_sm[dev]);
  kernel<<<grid, kTmaThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(m), static_cast<float*>(l), T, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// D > 256: the mma.sync kernel in 128-column output chunks.

// kStats as above; blockIdx.z picks the output columns
// [128 z, 128 z + 128); the scores contract over every chunk.
template <bool kStats>
__global__ void __launch_bounds__(kThreads) flash_fwd_chunked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int T, int S,
    int D, float scale, int causal) {
  constexpr int kDPad = kMaxDPad;
  constexpr int kStride = kDPad + 8;    // bf16 per smem row (bank skew)
  constexpr int kSteps = kDPad / 16;    // k-steps of q.k^T over D
  constexpr int kDTiles = kDPad / 8;    // n-tiles of p.v over D
  constexpr int kKTiles = kBlock / 8;   // n-tiles of q.k^T over keys
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock * kStride];

  const int s = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                      // row within the 8-row half
  const int tq = lane % 4;                     // column pair within a tile
  const int row0 = q0 + warp * 16 + g;         // this lane's two rows:
  const int row1 = row0 + 8;                   // row0 and row0 + 8
  const int oc = blockIdx.z * kDPad;           // output columns

  uint32_t qa[4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kb = (T + kBlock - 1) / kBlock;
  const int last_kb = causal ? qb : n_kb - 1;
  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * kBlock;

    // s = q' . k^T: 16 rows x 64 keys per warp; q' chunk in vs, k chunk
    // in ks (q' restaged with each K block, chunk by chunk); then v's
    // output chunk in vs
    float sc[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    for (int c = 0; c < D; c += kDPad) {
      __syncthreads();
      load_tile<kDPad, kStride, true>(vs, q, q0, T, S, D, s, scale, c);
      load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, c);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        a_frag(qa, vs, kStride, warp * 16, kk);
#pragma unroll
        for (int nt = 0; nt < kKTiles; ++nt)
          mma_nk(sc[nt], qa, ks, kStride, nt * 8, kk);
      }
    }
    __syncthreads();
    load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f, oc);
    __syncthreads();

    // mask, then the online softmax of _attend_step._fold
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * tq + (i & 1);
        const int row = (i < 2) ? row0 : row1;
        if (key >= T || (causal && key > row)) sc[nt][i] = kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = expf(sc[nt][i] - m[i >> 1]);
        sum[i >> 1] += sc[nt][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // acc += bf16(p) . v: the s accumulators of key tiles 2kk and 2kk+1
    // are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t pa[4];
      pack_acc(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt)
        mma_kn(acc[nt], pa, vs, kStride, nt * 8, kk);
    }
  }

  // o = acc / l (K6b: / max(l, 1), the same number)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= T) continue;
    const float den = kStats ? fmaxf(l[r], 1.f) : l[r];
    // the four lanes of a row hold one m, l; output chunk 0 writes them
    if (kStats && tq == 0 && oc == 0) {
      m_out[static_cast<long long>(s) * T + row] = m[r];
      l_out[static_cast<long long>(s) * T + row] = l[r];
    }
    __nv_bfloat16* orow = o + (static_cast<long long>(row) * S + s) * D;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      const int d = oc + nt * 8 + 2 * tq;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            pack_bf16(acc[nt][2 * r] / den, acc[nt][2 * r + 1] / den);
    }
  }
}

template <bool kStats>
int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   void* m, void* l, int T, int S, int D, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid(S, (T + kBlock - 1) / kBlock, d_chunks(D));
  flash_fwd_chunked_kernel<kStats><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(m), static_cast<float*>(l), T, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int dispatch(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int T, int S, int D, float scale, int causal,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_tma<16, kStats>(q, k, v, o, m, l, T, S, D, scale, causal,
                                  st);
  if (D <= 32)
    return launch_tma<32, kStats>(q, k, v, o, m, l, T, S, D, scale, causal,
                                  st);
  if (D <= 64)
    return launch_tma<64, kStats>(q, k, v, o, m, l, T, S, D, scale, causal,
                                  st);
  if (D <= 128)
    return launch_tma<128, kStats>(q, k, v, o, m, l, T, S, D, scale, causal,
                                   st);
  if (D <= 160)
    return launch_tma<160, kStats>(q, k, v, o, m, l, T, S, D, scale, causal,
                                   st);
  if (D <= kWideDPad)
    return launch_tma<kWideDPad, kStats>(q, k, v, o, m, l, T, S, D, scale,
                                         causal, st);
  return launch_chunked<kStats>(q, k, v, o, m, l, T, S, D, scale, causal, st);
}

}  // namespace

// The wrapper (ops/cuda_attention.py) checks: q, k, v, o contiguous bf16
// [T, S, D] on one device, 16-byte aligned, D a multiple of 8 (it pads
// other widths; scale is the true width's); m and l contiguous f32 [S, T].
extern "C" int agac_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int T, int S,
                                    int D, float scale, int causal,
                                    void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, T, S, D, scale,
                         causal, stream);
}

extern "C" int agac_flash_attention_stats(const void* q, const void* k,
                                          const void* v, void* o, void* m,
                                          void* l, int T, int S, int D,
                                          float scale, int causal,
                                          void* stream) {
  return dispatch<true>(q, k, v, o, m, l, T, S, D, scale, causal, stream);
}
