// Kernel K6b-ring: one block pair of ring attention, the flash forward
// with merge-ready softmax stats.  q [H, Tq, D] f32, k, v [H, Tk, D] bf16
// (head-major) -> o [H, Tq, D] f32 UNNORMALISED, m [H, Tq] f32 (the row
// max) and l [H, Tq] f32 (the row sum): the normalised output would be
// o / l, and two results over disjoint key sets merge exactly with the
// flash recurrence (parallel/ring_attention.py::_merge_block_stats).
//
// It replaces the JAX package's ops/pallas_attention.py::_stats_kernel
// (:301, pallas_call at :845) with normalize=False, reached through
// flash_attention_stats (:1081) and _flash_stats (:1074) from the ring's
// per-block attend (parallel/ring_attention.py:201-226), which hands it
// the f32 copy of the resident q block (qf, :205) and the K/V block it
// holds in the model's dtype.  K6b (flash_attention.cu) is the same
// TPU kernel's normalize=True flavour.
//
// Arithmetic (the reference's _prescale :346 keeps q f32, _attend_step
// :197): q' = q * D^-0.5 in f32, one rounding, NOT rounded to bf16;
// s = q'.k^T, f32 q' times bf16 k with f32 sums (the TPU's dot_general of
// an f32 and a bf16 operand, :216-220); masked scores -1e30 (keys past
// Tk; with causal, key index > query index, the relative mask of the
// ring's diagonal block); per K block m_new = max(m, rowmax s),
// p = exp(s - m_new) in f32, l = l * exp(m - m_new) + sum(p),
// acc = acc * exp(m - m_new) + bf16(p).v with f32 sums (p rounded to v's
// dtype, :233-235); o = acc, not divided by l.  Tq and Tk may differ (the
// zigzag ring's half blocks).  p is rounded against the running max, so
// the K block (64 keys) is part of the result at the last-ulp level; the
// plain version takes it as block_k.
//
// The score product.  Rounding q' to bf16 would make it another function
// (a relative error of 2^-9 in every score).  Here q' is split exactly
// into three bf16 terms, hi = bf16(q'), mid = bf16(q' - hi),
// lo = bf16(q' - hi - mid), whose sum is q' (8 + 8 + 8 significant bits
// cover f32's 24; every difference is exact in f32; split_q in
// flash_common.cuh), and s accumulates, k16 step by k16 step over D, lo,
// mid and hi times k^T on the tensor cores (bf16 operands, f32
// accumulators).  Each product of a bf16 term and a bf16 k is exact in
// f32, so s is the f32 product up to the order of its f32 sums, the same
// freedom an f32 matmul has.  The alternative, f32 FMA on the CUDA cores,
// is the same function at a fifth of the rate (67 TFLOP/s f32 against 989
// bf16 over three passes).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16).  Bytes: q and o
// f32 (8 Tq D a head), k and v bf16 (4 Tk D), m and l (8 Tq).
// Operations: 2 D for each live (query, key) pair in each of the four
// bf16 tensor-core products, three for the exact f32 q'.k^T and one for
// p.v (q'.k^T as f32 FMA on the CUDA cores, 67 TFLOP/s, would take 4.9x
// its three bf16 products).
// - H = 4096, Tq = Tk = 128, D = 32 (a ring block of `train --sharded
//   --window 256` on a data 2 x seq 2 mesh at the train defaults, 128
//   groups x 32 endpoints a rank): 205 MB, bound by bytes at 61 us
//   (not causal 4.3 GFLOP a product, 17 us of operations).
// - H = 128, Tq = Tk = 2048, D = 128, causal: 0.40 GB (121 us), 68.7
//   GFLOP a product, bound by operations at 0.28 ms.
// - H = 256, Tq = Tk = 128, D = 160, causal: 63 MB, bound by bytes at
//   19 us.
//
// Design, for D <= 256 (flash_ring_tma_kernel, K6a's and K6b's shape in
// flash_attention.cu with q' as three terms):
// - A CTA is one consumer warpgroup (64 query rows) and one producer
//   warp, whose one lane keeps the tiles in flight by TMA under
//   mbarriers: q once a tile, and a ring of two k/v stages (k and v full
//   apart, one empty a stage), running ahead into the next tile while the
//   consumers finish this one.  k and v come through head-major 3-D
//   tensor maps (D, Tk, H) in SwizzledTile boxes, zero past Tk and D.
// - q.  The producer loads the f32 q tile by TMA (a map (D, Tq, H), one
//   unswizzled box of kDPad columns, zero past Tq and D) into the space
//   of the three q' tiles, which it fits in two thirds of; each consumer
//   reads its 8-column groups into registers, the warpgroup meets at a
//   barrier, and each writes its groups' hi, mid and lo into the three
//   swizzled tiles (store_q_split), then fence.proxy.async and a
//   warpgroup barrier before any wgmma reads them.  Chosen over loads by
//   the consumers because the copy then runs during the previous tile's
//   last block and epilogue (at the ring block a tile has one or two K
//   blocks, so a load at the top of each tile would stall the warpgroup
//   once a block), and over the producer warp splitting q itself because
//   one warp would do the split's 8 instructions a value for the whole
//   tile (at D = 160, some 2.5 thousand a lane, more than the consumers'
//   work on a two-block tile); the split costs the consumers kDPad / 2
//   values a thread once a tile, and no shared memory beyond the q' tiles.
// - s = q'.k^T: for each k16 step kk over D ascending, three wgmma
//   m64n64k16 with both operands in shared memory (k K-major), lo, mid,
//   hi, into one accumulator, one commit and one wait a K block: the
//   order in which the mma.sync kernel this one replaced summed them.
// - The online softmax in registers (masks only on the diagonal block or
//   the ragged last one), then acc += bf16(p).v by wgmma with p in
//   registers (the s accumulators repacked by pack_acc) and v MN-major in
//   shared memory, one instruction a box of 64 (32, 16) columns.  A head
//   up to 256 is one full-width tile: s is formed once a block pair.
// - The walk: a persistent grid of as many CTAs as fit on the card, each
//   taking tiles (head, q block) blockIdx.x, + gridDim.x, ... longest q
//   block first, folding K blocks [0, causal ? min(n_kb, qb + 1) : n_kb).
//   At the ring block that is 8192 tiles of one or two K blocks.
// - Epilogue: o = acc as it stands, 16 bytes a lane (lanes tq and tq ^ 1
//   trade a pair, so that an even lane holds four columns of its first
//   row and an odd one four of its second); m and l once a row; padded
//   rows never written.
// - Shared memory (three q' tiles and two k/v stages, 7 SwizzledTiles,
//   plus 64 bytes of barriers): 14 KB at D <= 16, 28 KB at 32, 56 KB at
//   64, 112 KB at 128 (two CTAs an SM just fit the SM's 228 KB), 168 KB
//   at 160, 224 KB at 256 (of 227 KB a block).  CTAs an SM: four at
//   D <= 32 (registers), three at 64, two at 128, one above
//   (ring_min_ctas; the grid takes what the runtime's occupancy grants,
//   which on the H100 is just that: kernels/chip_checks.py sass).
//   Registers there (nvcc -Xptxas -v, sm_90a): 95, 96, 128, 167, 244
//   and 255 at D = 16, 32, 64, 128, 160, 256, no spills.
// - Bits.  A warpgroup product's accumulator is the mma.sync m16n8 layout
//   repeated over n-tiles; every score sees its k16 steps and terms in
//   the order the mma.sync kernel used (kk ascending, lo, mid, hi), every
//   output column its key steps in order, and the reductions keep theirs
//   (n-tiles ascending, then lanes by xor 1, 2).  wgmma sums a k16 step of
//   these terms as mma.sync does, subnormal lo . k included (tests/
//   test_torch_cuda.py::test_wgmma_sums_split_terms_as_mma_sync, passed
//   on the H100), so o, m and l are value for value the mma.sync
//   kernel's (kernels/chip_checks.py ab: digests equal at 89 points).
// D > 256 keeps that kernel (flash_ring_chunked_kernel), dispatched by
// width alone: four warps own one (head, 64-row q block), stage q' (split)
// and k through shared memory with plain 16-byte loads, multiply by
// mma.sync m16n8k16, and run the head in 128-column output chunks (a grid
// dimension), each rebuilding s over every chunk of D.
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
__host__ __device__ constexpr int ring_min_ctas(int d_pad) {
  return d_pad <= 32 ? 4 : d_pad <= 64 ? 3 : d_pad <= 128 ? 2 : 1;
}

template <int kDPad>
constexpr int ring_smem_bytes() {
  // q' hi, mid, lo (the f32 q tile staged over them), kStages of k and of
  // v, then the barriers
  return (3 + 2 * kStages) * SwizzledTile<kDPad>::kBytes +
         (2 + 3 * kStages) * 8;
}

// K blocks a tile of q block qb folds: up to its diagonal when causal
__device__ __forceinline__ int ring_walk(int qb, int n_kb, int causal) {
  return causal ? min(n_kb, qb + 1) : n_kb;
}

// The f32 q tile TMA staged at `tiles` ([kBlock][kDPad], row-major), times
// scale, split into hi, mid, lo over the same space: each consumer reads
// its 8-column groups first, then, after the warpgroup's barrier, writes
// them (store_q_split).
template <int kDPad>
__device__ __forceinline__ void split_staged_q(uint8_t* tiles, float scale) {
  constexpr int kRowGroups = kDPad / 8;
  constexpr int kGroups = kBlock * kRowGroups / kConsumers;   // a thread's
  static_assert(kBlock * kRowGroups % kConsumers == 0, "groups");
  float x[kGroups][8];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const float4* src = reinterpret_cast<const float4*>(tiles) +
                        2 * (threadIdx.x + i * kConsumers);
    const float4 a = src[0], b = src[1];
    const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = e[j];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int at = threadIdx.x + i * kConsumers;
    store_q_split<kDPad>(tiles, at / kRowGroups, at % kRowGroups, x[i],
                         scale);
  }
}

template <int kDPad>
__global__ void __launch_bounds__(kTmaThreads, ring_min_ctas(kDPad))
    flash_ring_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int Tq, int Tk, int H,
                          int D, float scale, int causal) {
  using L = SwizzledTile<kDPad>;
  constexpr int kKTiles = kBlock / 8;         // n-tiles of s over keys
  constexpr int kDTiles = L::kBoxes * L::kBoxCols / 8;   // of acc over D
  constexpr int kPvGroups = L::kBoxes;
  constexpr int kQBytes = kBlock * kDPad * 4;   // the staged f32 q tile
  static_assert(kQBytes <= 3 * L::kBytes, "q staging");
  // the tiles must start on 1024 bytes, the span of a 128-byte swizzle's
  // atom: the dynamic shared memory of a kernel with no static shared
  // memory does, and a launch where it did not would trap here
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (smem_u32(smem_raw) % 1024) __trap();
  uint8_t* qs = smem_raw;                     // hi, mid, lo
  uint8_t* ks = qs + 3 * L::kBytes;
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

  const int n_qb = (Tq + kBlock - 1) / kBlock;
  const int n_kb = (Tk + kBlock - 1) / kBlock;
  const int n_tiles = H * n_qb;

  if (threadIdx.x >= kConsumers) {
    // the producer: one lane issues every copy
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      uint32_t tiles = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int qb = n_qb - 1 - tile / H;   // longest rows first
        const int h = tile % H;
        const int walk = ring_walk(qb, n_kb, causal);
        if (walk == 0) continue;              // Tk = 0: nothing to read
        mbar_wait(q_empty, (tiles++ & 1) ^ 1);
        mbar_expect_tx(q_full, kQBytes);
        tma_load_3d(qs, &q_map, 0, qb * kBlock, h, q_full);
        for (int kb = 0; kb < walk; ++kb) {
          const int k0 = kb * kBlock;
          mbar_wait(kv_empty + stage, phase ^ 1);
          tma_tile_head_major<kDPad>(ks + stage * L::kBytes, &k_map, k0, h,
                                     k_full + stage);
          tma_tile_head_major<kDPad>(vs + stage * L::kBytes, &v_map, k0, h,
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
  const uint64_t hi_desc = gmma_desc<L::kSwz>(qs);
  const uint64_t mid_desc = gmma_desc<L::kSwz>(qs + L::kBytes);
  const uint64_t lo_desc = gmma_desc<L::kSwz>(qs + 2 * L::kBytes);
  int stage = 0;
  uint32_t phase = 0;
  uint32_t tiles = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int qb = n_qb - 1 - tile / H;
    const int h = tile % H;
    const int q0 = qb * kBlock;
    const int row0 = q0 + warp * 16 + g;       // this lane's two rows:
    const int row1 = row0 + 8;                 // row0 and row0 + 8
    const int walk = ring_walk(qb, n_kb, causal);

    if (walk > 0) {
      mbar_wait(q_full, tiles++ & 1);
      split_staged_q<kDPad>(qs, scale);
      fence_proxy_async();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }

    float row_m[2] = {kNegInf, kNegInf};
    float row_l[2] = {0.f, 0.f};
    float acc[kDTiles][4];
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int kb = 0; kb < walk; ++kb) {
      const int k0 = kb * kBlock;

      // s = q' . k^T: 64 rows x 64 keys; for each k16 step over D
      // ascending (all kDPad / 16 of them: a step past D adds zeros, and a
      // run-time bound would fence every step apart), lo, mid, hi
      float sc[kKTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      mbar_wait(k_full + stage, phase);
      const uint64_t k_desc = gmma_desc<L::kSwz>(ks + stage * L::kBytes);
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDPad / 16; ++kk) {
        const uint64_t step = L::k_step(kk) >> 4;
        wgmma_ss64<0>(sc, lo_desc + step, k_desc + step);
        wgmma_ss64<0>(sc, mid_desc + step, k_desc + step);
        wgmma_ss64<0>(sc, hi_desc + step, k_desc + step);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (kb == walk - 1) {   // q' is read for the last time: release it
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }

      // mask (only a block on the diagonal or past Tk has masked keys),
      // then the online softmax of _attend_step._fold
      if ((causal && kb == qb) || k0 + kBlock > Tk) {
#pragma unroll
        for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + nt * 8 + 2 * tq + (i & 1);
            const int row = (i < 2) ? row0 : row1;
            if (key >= Tk || (causal && key > row)) sc[nt][i] = kNegInf;
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

    // o = acc unnormalised, m and l as they stand; the four lanes of a
    // row hold one m, l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (tq == 0 && row < Tq) {
        m_out[static_cast<long long>(h) * Tq + row] = row_m[r];
        l_out[static_cast<long long>(h) * Tq + row] = row_l[r];
      }
    }
    // lanes tq and tq ^ 1 trade: an even lane sends its second row's pair
    // and keeps columns [8 nt + 2 tq, + 4) of its first, an odd lane the
    // reverse, [8 nt + 2 (tq - 1), + 4) of its second
    const bool odd = tq & 1;
    const int my_row = odd ? row1 : row0;
    float* orow = o + (static_cast<long long>(h) * Tq + my_row) * D;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      const float give0 = odd ? acc[nt][0] : acc[nt][2];
      const float give1 = odd ? acc[nt][1] : acc[nt][3];
      const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
      const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
      const int d = nt * 8 + 2 * (tq & ~1);
      if (my_row < Tq && d < D)
        *reinterpret_cast<float4*>(orow + d) =
            odd ? make_float4(got0, got1, acc[nt][2], acc[nt][3])
                : make_float4(acc[nt][0], acc[nt][1], got0, got1);
    }
  }
}

// CTAs of the kernel that fit on an SM of the current device (the
// launch's grid is that times the SMs), asked of the runtime once a
// device after the shared memory is allowed.
template <int kDPad>
int ring_ctas_per_sm(int* ctas, int* sms) {
  auto kernel = flash_ring_tma_kernel<kDPad>;
  constexpr int kSmem = ring_smem_bytes<kDPad>();
  static unsigned allowed = 0;
  static int fit_on[32] = {}, sms_on[32] = {};
  int err = allow_smem(kernel, kSmem, &allowed, true);
  if (err) return err;
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (fit_on[dev] == 0) {
    int n = 0, fit = 0;
    err = static_cast<int>(
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev));
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, kernel, kTmaThreads, kSmem));
    if (err) return err;
    sms_on[dev] = n;
    fit_on[dev] = fit > 0 ? fit : 1;
  }
  *ctas = fit_on[dev];
  *sms = sms_on[dev];
  return 0;
}

template <int kDPad>
int launch_tma(const void* q, const void* k, const void* v, void* o, void* m,
               void* l, int Tq, int Tk, int H, int D, float scale,
               int causal, cudaStream_t stream) {
  int ctas = 0, sms = 0;
  int err = ring_ctas_per_sm<kDPad>(&ctas, &sms);
  if (err) return err;
  // Tk = 0 folds no K block: k and v are never read, and have no map
  CUtensorMap maps[3] = {};
  err = encode_head_major_f32_rows<kDPad>(maps, q, Tq, H, D);
  if (!err && Tk > 0)
    err = encode_head_major_tiles<kDPad>(maps + 1, k, Tk, H, D);
  if (!err && Tk > 0)
    err = encode_head_major_tiles<kDPad>(maps + 2, v, Tk, H, D);
  if (err) return err;
  const long long n_tiles =
      static_cast<long long>(H) * ((Tq + kBlock - 1) / kBlock);
  const long long fit = static_cast<long long>(ctas) * sms;
  const int grid = static_cast<int>(n_tiles < fit ? n_tiles : fit);
  flash_ring_tma_kernel<kDPad>
      <<<grid, kTmaThreads, ring_smem_bytes<kDPad>(), stream>>>(
          maps[0], maps[1], maps[2], static_cast<float*>(o),
          static_cast<float*>(m), static_cast<float*>(l), Tq, Tk, H, D,
          scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// D > 256: the mma.sync kernel in 128-column output chunks.

// Columns [c0, c0 + kDPad) of rows [t0, t0 + kBlock) of one head's f32 q
// [Tq, D], split by split_q into three bf16 tiles hi, mid, lo (row stride
// kStride); zero past Tq and past D.  D and c0 are multiples of 8.
template <int kDPad, int kStride>
__device__ __forceinline__ void load_q_split(__nv_bfloat16* hi,
                                             __nv_bfloat16* mid,
                                             __nv_bfloat16* lo,
                                             const float* __restrict__ q,
                                             int t0, int Tq, int D,
                                             float scale, int c0) {
  constexpr int kChunks = kDPad / 4;    // 16-byte chunks of f32 per row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < Tq && c0 + c < D)
      val = *reinterpret_cast<const float4*>(
          q + static_cast<long long>(t0 + r) * D + c0 + c);
    const float x[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const SplitTerms t = split_q(x[j], scale);
      const int at = r * kStride + c + j;
      hi[at] = t.hi;
      mid[at] = t.mid;
      lo[at] = t.lo;
    }
  }
}

// s += (hi + mid + lo) . k^T over the k-steps of one staged chunk: 16
// rows x 64 keys per warp, the smallest term first.
template <int kDPad, int kStride>
__device__ __forceinline__ void split_scores(float (&sc)[kBlock / 8][4],
                                             const __nv_bfloat16* qs,
                                             const __nv_bfloat16* ks,
                                             int warp) {
  constexpr int kTile = kBlock * kStride;
#pragma unroll
  for (int kk = 0; kk < kDPad / 16; ++kk) {
#pragma unroll
    for (int term = 2; term >= 0; --term) {
      uint32_t qa[4];
      a_frag(qa, qs + term * kTile, kStride, warp * 16, kk);
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt)
        mma_nk(sc[nt], qa, ks, kStride, nt * 8, kk);
    }
  }
}

constexpr int chunked_smem_bytes() {
  return 5 * kBlock * (kMaxDPad + 8) * 2;   // q' hi, mid, lo, k, v
}

// blockIdx.z picks the output columns [128 z, 128 z + 128); the scores
// contract over every chunk.
__global__ void __launch_bounds__(kThreads) flash_ring_chunked_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Tq, int Tk,
    int D, float scale, int causal) {
  constexpr int kDPad = kMaxDPad;
  constexpr int kStride = kDPad + 8;    // bf16 per smem row (bank skew)
  constexpr int kTile = kBlock * kStride;
  constexpr int kDTiles = kDPad / 8;    // n-tiles of p.v over D
  constexpr int kKTiles = kBlock / 8;   // n-tiles of q.k^T over keys
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 tiles
  __nv_bfloat16* ks = qs + 3 * kTile;
  __nv_bfloat16* vs = qs + 4 * kTile;

  const int h = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                      // row within the 8-row half
  const int tq = lane % 4;                     // column pair within a tile
  const int row0 = q0 + warp * 16 + g;         // this lane's two rows:
  const int row1 = row0 + 8;                   // row0 and row0 + 8
  const int oc = blockIdx.z * kDPad;           // output columns
  const float* qh = q + static_cast<long long>(h) * Tq * D;
  const __nv_bfloat16* kh = k + static_cast<long long>(h) * Tk * D;
  const __nv_bfloat16* vh = v + static_cast<long long>(h) * Tk * D;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kb = (Tk + kBlock - 1) / kBlock;
  const int last_kb = causal ? min(n_kb - 1, qb) : n_kb - 1;
  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * kBlock;

    // q' and k restaged chunk by chunk for each K block, then v's output
    // chunk
    float sc[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    for (int c = 0; c < D; c += kDPad) {
      __syncthreads();
      load_q_split<kDPad, kStride>(qs, qs + kTile, qs + 2 * kTile, qh, q0,
                                   Tq, D, scale, c);
      load_tile<kDPad, kStride, false>(ks, kh, k0, Tk, 1, D, 0, 1.f, c);
      __syncthreads();
      split_scores<kDPad, kStride>(sc, qs, ks, warp);
    }
    __syncthreads();
    load_tile<kDPad, kStride, false>(vs, vh, k0, Tk, 1, D, 0, 1.f, oc);
    __syncthreads();

    // mask, then the online softmax of _attend_step._fold
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * tq + (i & 1);
        const int row = (i < 2) ? row0 : row1;
        if (key >= Tk || (causal && key > row)) sc[nt][i] = kNegInf;
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

  // o = acc unnormalised, m and l as they stand
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    const long long at = static_cast<long long>(h) * Tq + row;
    // the four lanes of a row hold one m, l; output chunk 0 writes them
    if (tq == 0 && oc == 0) {
      m_out[at] = m[r];
      l_out[at] = l[r];
    }
    float* orow = o + at * D;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      const int d = oc + nt * 8 + 2 * tq;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   void* m, void* l, int Tq, int Tk, int H, int D,
                   float scale, int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  constexpr int bytes = chunked_smem_bytes();
  const int err = allow_smem(flash_ring_chunked_kernel, bytes, &allowed);
  if (err) return err;
  const dim3 grid(H, (Tq + kBlock - 1) / kBlock, d_chunks(D));
  flash_ring_chunked_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), Tq, Tk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (ops/cuda_attention.py) checks: q contiguous f32 [H, Tq, D],
// k and v contiguous bf16 [H, Tk, D], o contiguous f32 [H, Tq, D], m and l
// contiguous f32 [H, Tq], all on one device and 16-byte aligned, D a
// multiple of 8 (it pads other widths; scale is the true width's), H and
// Tq at least 1.  Those are what the tensor maps need: a 16-byte aligned
// base and strides of a multiple of 16 bytes.
extern "C" int agac_flash_attention_ring(const void* q, const void* k,
                                         const void* v, void* o, void* m,
                                         void* l, int Tq, int Tk, int H,
                                         int D, float scale, int causal,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_tma<16>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= 32)
    return launch_tma<32>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= 64)
    return launch_tma<64>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= 128)
    return launch_tma<128>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal,
                           st);
  if (D <= 160)
    return launch_tma<160>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal,
                           st);
  if (D <= kWideDPad)
    return launch_tma<kWideDPad>(q, k, v, o, m, l, Tq, Tk, H, D, scale,
                                 causal, st);
  return launch_chunked(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
}

// CTAs an SM and SMs of the current device that a launch of width D takes
// (ctas_sms[0], ctas_sms[1]); 0 and 0 past 256 (the chunked kernel, a CTA
// a tile).  Returns a CUDA error code.
extern "C" int agac_flash_attention_ring_ctas(int D, int* ctas_sms) {
  ctas_sms[0] = ctas_sms[1] = 0;
  if (D <= 16) return ring_ctas_per_sm<16>(ctas_sms, ctas_sms + 1);
  if (D <= 32) return ring_ctas_per_sm<32>(ctas_sms, ctas_sms + 1);
  if (D <= 64) return ring_ctas_per_sm<64>(ctas_sms, ctas_sms + 1);
  if (D <= 128) return ring_ctas_per_sm<128>(ctas_sms, ctas_sms + 1);
  if (D <= 160) return ring_ctas_per_sm<160>(ctas_sms, ctas_sms + 1);
  if (D <= kWideDPad)
    return ring_ctas_per_sm<kWideDPad>(ctas_sms, ctas_sms + 1);
  return 0;
}