// Kernel K9: the fused one-sweep causal flash-attention backward on the
// strided [T, S, D] bf16 layout, the S axis being independent heads.
//
// K9 replaces the JAX package's ops/pallas_attention.py::_dqkv_kernel
// (:585, pallas_call at :936), which _flash_bwd_padded (:885) launches
// when _fused_bwd_eligible (:551) holds: a head's f32 dq within 2 MiB at
// the reference's padded length, and at most 32 heads a call (the
// wrapper, ops/cuda_attention.py, routes by its own copy of that gate).
// The arithmetic is K7's and K8's (flash_attention_bwd.cu): q' =
// bf16(q * D^-0.5); s = q'.k^T, f32 sums, masked scores -1e30; p =
// exp(s - m) / max(l, 1); dp = do.v^T; ds = p * (dp - dvec); dv =
// bf16(sum_i bf16(p_ij)^T.do_i), dk = bf16(sum_i bf16(ds_ij)^T.q'_i), dq
// = bf16(D^-0.5 * sum_j bf16(ds_ij).k_j); expf and the division IEEE.
// What makes it K9: ONE recompute of the score tile s_ij and of dp_ij
// per live (K block j, q block i) pair feeds dv_j, dk_j AND dq_i, where
// K7 and K8 each recompute both.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16).  Per live (query,
// key) pair, five products of 2 D flops (s, dp, dv, dk, dq; K7 + K8 run
// seven); T (T + 1) / 2 live pairs a head.  Bytes: q, k, v, do, m, l,
// dvec read and dq, dk, dv written once, 14 T S D + 12 T S.
// - T = 64, S = 32, D = 32 (a chunk of the train command's defaults):
//   0.94 MB, bound by bytes at 0.28 us: launch-bound.
// - T = 2048, S = 32, D = 128: 85.9 GFLOP, bound by operations at
//   0.087 ms.
//
// Design.  The TPU kernel walks a sequential grid per head (K block j
// outer, q block i inner) with the head's whole f32 dq accumulator in
// VMEM.  Here that walk is cut into tiles that run side by side:
//
// - Tiles.  One CTA of four warps takes one tile (head s, K block j, and
//   the 128-column output chunk c when D > 128): S x chunks x n_blocks
//   tiles, 1024 at T = 2048, S = 32, D = 128.  The warps hold dk_j and
//   dv_j of their 16 keys in registers (K8's layout: transposed tiles
//   s^T = k.q'^T and dp^T = v.do^T, each q block walked in two halves of
//   32 rows) and visit the live q blocks i in ascending order (i >= j
//   when causal).  A visit recomputes s^T and dp^T once, forms p and ds,
//   adds bf16(p)^T.do_i and bf16(ds)^T.q'_i into dv_j and dk_j, puts
//   bf16(ds) into a shared [q row][key] tile, and then takes its turn in
//   dq_i's chain.
// - The dq chain, in K7's order.  dq_i sums over j in ascending order,
//   each pair's four k-steps of bf16(ds).k_j in order (K7 keeps that sum
//   in registers; every product here is in K7's and K8's fragment
//   layouts and k-step order, so dq, dk and dv equal K7's and K8's bit
//   for bit).  Its f32 accumulator lives in a workspace the wrapper
//   allocates, one slot per (head, chunk, q block).  Visit j of block i
//   waits until the block's counter reads j (one thread spins, the CTA
//   synchronises), loads the accumulator into the mma C operand (zero at
//   j = 0: no memset of the accumulators), runs its four k-steps, stores
//   it and publishes j + 1.  Block i's last visit (j = i when causal,
//   n_blocks - 1 when not) scales by D^-0.5, rounds and writes dq_i once.
//   A sum of per-K-block partials would round differently and lose the
//   equality with K7, so the chain is kept and only moved between CTAs.
// - Memory order.  The writer stores the accumulator, fences
//   (__threadfence), synchronises the CTA and releases the counter
//   (st.release.gpu); the reader acquires it (ld.acquire.gpu), then
//   synchronises, and loads the accumulator past L1 (ld.global.cg): L1 is
//   not coherent across SMs, and an SM may hold the lines of an earlier
//   visit to the same block.
// - Forward progress.  Blocks start in no order, so a CTA takes its tile
//   from a ticket (atomicAdd at its start), never from blockIdx.  Tickets
//   go K block major: every (head, chunk) tile of K block 0, then of
//   block 1, and so on.  A tile waits only on the tile of K block j - 1 of
//   its head and chunk, which holds a lower ticket; that ticket was taken
//   by a CTA already running, which waits only on lower tickets still, so
//   no schedule deadlocks.  The order also starts the longest tiles first
//   (K block j visits n_blocks - j q blocks when causal).  A wait that
//   lasts kWaitLimitNs traps, so a broken chain fails the launch rather
//   than hanging the card.  With one K block there is no chain: the
//   tile is blockIdx, and neither counter nor ticket is touched.
// - Workspace.  Accumulators first, each warp's fragment stored in
//   fragment order ([warp][n-tile][lane] float4), so every load and store
//   is a contiguous 16-byte vector a lane; then one counter a slot and
//   the ticket, which the launch zeroes (one memset) when n_blocks > 1.
//   The wrapper allocates the workspace per call, so calls on two
//   streams never share counters, and the memset and the kernel both
//   capture into a CUDA graph.
// - Copies.  k_j and v_j are staged once a tile, and the next q block's
//   q, do and stats with cp.async into the second of two buffers while
//   the current block computes; q is scaled to q' in place once it lands.
//   A head wider than 128 runs in column chunks as K7 and K8 do: s^T and
//   dp^T contract over every chunk in ascending order, then q', do and k
//   are restaged at the output chunk; that path stages its tiles
//   synchronously in one buffer (only its stats come by cp.async).
// - Occupancy (shared memory per CTA; the SM has 228 KB, 1 KB of it
//   reserved per CTA): D = 128, six 64 x 136 bf16 tiles (k, v, two q',
//   two do), the 64 x 72 ds tile and two sets of stats, 115,200 bytes:
//   two CTAs an SM, 264 on the card.  D = 64: 66,048 (three an SM);
//   D = 32: 41,472 (five); D = 16: 29,184 (seven); D > 128: four tiles,
//   79,616 (two).  Registers: dk and dv take 2 x 16 x 4 f32 a thread at
//   D = 128 beside the s^T and dp^T halves (32), under the 255 a thread
//   that two CTAs of 128 threads leave.
// - mma.sync m16n8k16 throughout: wgmma would sum each product's f32
//   terms in another order and lose the equality with K7 and K8, which
//   stay on mma.sync; moving all three to wgmma, and staging with TMA,
//   is the next redesign.
// Padded rows are zero-filled in shared memory, masked explicitly (a
// padded q row reads m = 0, l = 0 -> max(l, 1) = 1, dvec = 0) and never
// written.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// Row stride of the bf16 ds tile [q row][key] (bank skew as the tiles').
constexpr int kDsStride = kBlock + 8;
// A dq chain that does not advance for this long is broken: trap.
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

// Buffers of q', do and the stats: two (prefetch) unless chunked.
template <bool kChunked>
constexpr int kStagesOf = kChunked ? 1 : 2;

// k and v, the q' and do buffers, the ds tile, and the stats (m, l, dvec
// of one q block) of each buffer.
template <int kDPad, bool kChunked>
constexpr int tile_bytes() {
  return (2 + 2 * kStagesOf<kChunked>) * kBlock * (kDPad + 8) * 2 +
         kBlock * kDsStride * 2 + kStagesOf<kChunked> * 3 * kBlock * 4;
}

// Floats of one (head, chunk) pair's dq accumulators: the padded length
// x the columns.
template <int kDPad>
long long dq_floats(int T) {
  return static_cast<long long>((T + kBlock - 1) / kBlock) * kBlock * kDPad;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until *counter == value (one thread).
__device__ void wait_for(const int* counter, int value) {
  const unsigned long long t0 = global_ns();
  while (load_acquire(counter) != value) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
    __nanosleep(64);
  }
}

// cp.async rows [t0, t0 + kBlock), columns [0, kDPad) of head s from
// [T, S, D] into a [kBlock, kDPad] tile (row stride kStride), zero past T
// and past D (D a multiple of 8).
template <int kDPad, int kStride>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int t0,
                                          int T, int S, int D, int s) {
  constexpr int kChunks = kDPad / 8;    // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = t0 + r < T && c < D;
    cp_async16(tile + r * kStride + c,
               ok ? src + (static_cast<long long>(t0 + r) * S + s) * D + c
                  : src,
               ok);
  }
}

// q' = bf16(q * scale) in place, over the chunks copy_tile gave this
// thread (after its own copies have landed): load_tile's rounding.
template <int kDPad, int kStride>
__device__ __forceinline__ void scale_tile(__nv_bfloat16* tile,
                                           float scale) {
  constexpr int kChunks = kDPad / 8;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + (i / kChunks) * kStride +
                                        (i % kChunks) * 8);
    uint4 val = *p;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    *p = val;
  }
}

// cp.async m, l and dvec of rows [q0, q0 + kBlock) of head s into
// stats[0, kBlock), [kBlock, 2 kBlock) and [2 kBlock, 3 kBlock), zero
// past T.
__device__ __forceinline__ void copy_stats(float* stats, const float* m,
                                           const float* l, const float* dvec,
                                           int q0, int T, int s) {
  for (int i = threadIdx.x; i < 3 * kBlock; i += kThreads) {
    const int which = i / kBlock;
    const int r = i % kBlock;
    const float* src = which == 0 ? m : which == 1 ? l : dvec;
    const bool ok = q0 + r < T;
    cp_async4(stats + i,
              ok ? src + static_cast<long long>(s) * T + q0 + r : src, ok);
  }
}

// kChunked: D > 128, so kDPad = 128 and the tile's chunk picks the output
// columns; s^T and dp^T contract over every chunk.  ws: the dq
// accumulators, S x chunks x n_blocks slots of kBlock x kDPad floats;
// counters: a counter a slot, then the ticket (zero before the launch
// when n_blocks > 1).
template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dqkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* ws, int* counters, int T,
    int S, int D, float scale, int causal) {
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;    // k-steps of s^T, dp^T over D
  constexpr int kDTiles = kDPad / 8;    // n-tiles of dq, dk, dv over D
  constexpr int kHalf = kBlock / 2;     // q rows per pass
  constexpr int kQTiles = kHalf / 8;    // n-tiles of s^T, dp^T per pass
  constexpr int kTile = kBlock * kStride;
  constexpr int kStages = kStagesOf<kChunked>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qbuf = vs + kTile;               // kStages tiles
  __nv_bfloat16* dobuf = qbuf + kStages * kTile;  // kStages tiles
  __nv_bfloat16* dss = dobuf + kStages * kTile;
  float* statbuf = reinterpret_cast<float*>(dss + kBlock * kDsStride);
  __shared__ int ticket;

  const int n_blocks = (T + kBlock - 1) / kBlock;
  const int n_chunks = kChunked ? d_chunks(D) : 1;
  const int per_block = S * n_chunks;        // tiles of one K block
  const bool chained = n_blocks > 1;
  if (threadIdx.x == 0)
    ticket = chained ? atomicAdd(counters + per_block * n_blocks, 1)
                     : static_cast<int>(blockIdx.x);
  __syncthreads();
  // the tile of the ticket, K blocks major
  const int t = ticket;
  const int kb = t / per_block;
  const int s = t % per_block / n_chunks;
  const int chunk = t % n_chunks;
  const int oc = chunk * kDPad;                // output columns
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int key0 = k0 + warp * 16 + g;         // this lane's two keys
  const int key1 = key0 + 8;
  const int first_qb = causal ? kb : 0;

  // q, do (unchunked) and the stats of q block qb into buffer b
  auto stage = [&](int qb, int b) {
    if constexpr (!kChunked) {
      copy_tile<kDPad, kStride>(qbuf + b * kTile, q, qb * kBlock, T, S, D, s);
      copy_tile<kDPad, kStride>(dobuf + b * kTile, dout, qb * kBlock, T, S, D,
                                s);
    }
    copy_stats(statbuf + b * 3 * kBlock, m, l, dvec, qb * kBlock, T, s);
    cp_async_commit();
  };
  if constexpr (!kChunked) {
    copy_tile<kDPad, kStride>(ks, k, k0, T, S, D, s);
    copy_tile<kDPad, kStride>(vs, v, k0, T, S, D, s);
    stage(first_qb, 0);                        // one group with k and v
  }

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  for (int qb = first_qb; qb < n_blocks; ++qb) {
    const int q0 = qb * kBlock;
    const int b = kChunked ? 0 : (qb - first_qb) & 1;
    __nv_bfloat16* qs = qbuf + b * kTile;
    __nv_bfloat16* dos = dobuf + b * kTile;
    const float* ms = statbuf + b * 3 * kBlock;
    const float* ls = ms + kBlock;
    const float* dvs = ls + kBlock;
    __syncthreads();   // every warp is done with the ds tile and buffer b^1
    if constexpr (kChunked) {
      stage(qb, 0);
      cp_async_wait<0>();
    } else {
      if (qb + 1 < n_blocks) {
        stage(qb + 1, b ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      scale_tile<kDPad, kStride>(qs, scale);
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < kBlock; h += kHalf) {
      // s^T = k.q'^T and dp^T = v.do^T: 16 keys x 32 q rows per warp
      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
      for (int c = 0; c < (kChunked ? D : 1); c += kDPad) {
        if constexpr (kChunked) {   // all four tiles of chunk c
          __syncthreads();
          load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, c);
          load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f, c);
          load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, c);
          load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f,
                                           c);
          __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t ka[4], va[4];
          a_frag(ka, ks, kStride, warp * 16, kk);
          a_frag(va, vs, kStride, warp * 16, kk);
#pragma unroll
          for (int nt = 0; nt < kQTiles; ++nt) {
            mma_nk(st[nt], ka, qs, kStride, h + nt * 8, kk);
            mma_nk(dpt[nt], va, dos, kStride, h + nt * 8, kk);
          }
        }
      }

      // p^T = exp(s^T - m) / max(l, 1), kept in st; ds^T in dpt, and
      // bf16(ds) into the [q row][key] tile for dq
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = h + nt * 8 + 2 * tq + (i & 1);   // q row in block
          const int row = q0 + c;
          const int key = (i < 2) ? key0 : key1;
          const bool masked =
              key >= T || row >= T || (causal && row < key);
          const float p = expf((masked ? kNegInf : st[nt][i]) - ms[c]) /
                          fmaxf(ls[c], 1.f);
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - dvs[c]);
          dss[c * kDsStride + key - k0] = __float2bfloat16_rn(dpt[nt][i]);
        }
      }

      if constexpr (kChunked) {   // q', do and k of the output chunk
        __syncthreads();
        load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, oc);
        load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, oc);
        load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, oc);
        __syncthreads();
      }

      // dv += bf16(p^T).do and dk += bf16(ds^T).q': do and q' are the
      // B operands stored [q row][d]
#pragma unroll
      for (int kk = 0; kk < kHalf / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        pack_acc(pa, st[2 * kk], st[2 * kk + 1]);
        pack_acc(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
        const int kq = h / 16 + kk;
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt) {
          mma_kn(dva[nt], pa, dos, kStride, nt * 8, kq);
          mma_kn(dka[nt], dsa, qs, kStride, nt * 8, kq);
        }
      }
    }
    __syncthreads();   // the ds tile is whole

    // dq_i's turn: visit kb of its chain.  Each warp its 16 q rows, k the
    // B operand stored [key][d]; the accumulator in fragment order.
    uint32_t dsa[kBlock / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      a_frag(dsa[kk], dss, kDsStride, warp * 16, kk);
    const long long slot =
        (static_cast<long long>(s) * n_chunks + chunk) * n_blocks + qb;
    float4* frag = reinterpret_cast<float4*>(ws + slot * kBlock * kDPad) +
                   warp * kDTiles * 32 + lane;
    const int last_kb = causal ? qb : n_blocks - 1;
    float acc[kDTiles][4];
    if (kb > 0) {   // after visit kb - 1 of this block, from its sum
      if (threadIdx.x == 0) wait_for(counters + slot, kb);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        const float4 a = __ldcg(frag + nt * 32);
        acc[nt][0] = a.x;
        acc[nt][1] = a.y;
        acc[nt][2] = a.z;
        acc[nt][3] = a.w;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        mma_kn(acc[nt], dsa[kk], ks, kStride, nt * 8, kk);
    if (kb < last_kb) {   // hand the sum to visit kb + 1
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt)
        __stcg(frag + nt * 32,
               make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]));
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) store_release(counters + slot, kb + 1);
    } else {   // the last visit: dq = bf16(D^-0.5 * the f32 sum), once
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= T) continue;
        __nv_bfloat16* out = dq + (static_cast<long long>(row) * S + s) * D;
#pragma unroll
        for (int nt = 0; nt < kDTiles; ++nt) {
          const int d = oc + nt * 8 + 2 * tq;
          if (d < D)
            *reinterpret_cast<uint32_t*>(out + d) = pack_bf16(
                acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= T) continue;
    const long long off = (static_cast<long long>(key) * S + s) * D;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      const int d = oc + nt * 8 + 2 * tq;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dk + off + d) =
            pack_bf16(dka[nt][2 * r], dka[nt][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + d) =
            pack_bf16(dva[nt][2 * r], dva[nt][2 * r + 1]);
      }
    }
  }
}

template <bool kChunked = false>
int tiles(int T, int S, int D) {
  return (T + kBlock - 1) / kBlock * S * (kChunked ? d_chunks(D) : 1);
}

template <int kDPad, bool kChunked = false>
long long workspace_floats(int T, int S, int D) {
  return dq_floats<kDPad>(T) * S * (kChunked ? d_chunks(D) : 1);
}

// The whole workspace in 4-byte words: the accumulators, then a counter a
// slot (one slot a tile) and the ticket.
template <int kDPad, bool kChunked = false>
long long workspace_words(int T, int S, int D) {
  return workspace_floats<kDPad, kChunked>(T, S, D) +
         tiles<kChunked>(T, S, D) + 1;
}

template <int kDPad, bool kChunked = false>
int launch_dqkv(const void* q, const void* k, const void* v,
                const void* dout, const void* m, const void* l,
                const void* dvec, void* dq, void* dk, void* dv, void* ws,
                int T, int S, int D, float scale, int causal,
                cudaStream_t stream) {
  static unsigned allowed = 0;
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = tile_bytes<kDPad, kChunked>();
  const auto kernel = flash_bwd_dqkv_kernel<kDPad, kChunked>;
  // max shared: room for two CTAs an SM at D = 128
  const int err = allow_smem(kernel, bytes, &allowed, true);
  if (err != 0) return err;
  const int n_tiles = tiles<kChunked>(T, S, D);
  int* counters = reinterpret_cast<int*>(
      static_cast<float*>(ws) + workspace_floats<kDPad, kChunked>(T, S, D));
  if (T > kBlock) {   // counters and ticket: a chain to order
    const cudaError_t set =
        cudaMemsetAsync(counters, 0, (n_tiles + 1) * sizeof(int), stream);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  kernel<<<n_tiles, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(ws), counters, T,
      S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The workspace agac_flash_bwd_dqkv needs at these sizes, in 4-byte
// words (workspace_words).
extern "C" long long agac_flash_bwd_dqkv_workspace(int T, int S, int D) {
  if (D <= 16) return workspace_words<16>(T, S, D);
  if (D <= 32) return workspace_words<32>(T, S, D);
  if (D <= 64) return workspace_words<64>(T, S, D);
  if (D <= kMaxDPad) return workspace_words<128>(T, S, D);
  return workspace_words<kMaxDPad, true>(T, S, D);
}

// The wrapper (ops/cuda_attention.py) checks: q, k, v, do and the outputs
// contiguous bf16 [T, S, D] on one device, 16-byte aligned, D a multiple
// of 8 (it pads other widths; scale is the true width's); m, l and dvec
// contiguous f32 [S, T]; ws at least agac_flash_bwd_dqkv_workspace
// words, 16-byte aligned.
extern "C" int agac_flash_bwd_dqkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* m, const void* l,
                                   const void* dvec, void* dq, void* dk,
                                   void* dv, void* ws, int T, int S, int D,
                                   float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_dqkv<16>(q, k, v, dout, m, l, dvec, dq, dk, dv, ws, T, S,
                           D, scale, causal, st);
  if (D <= 32)
    return launch_dqkv<32>(q, k, v, dout, m, l, dvec, dq, dk, dv, ws, T, S,
                           D, scale, causal, st);
  if (D <= 64)
    return launch_dqkv<64>(q, k, v, dout, m, l, dvec, dq, dk, dv, ws, T, S,
                           D, scale, causal, st);
  if (D <= kMaxDPad)
    return launch_dqkv<128>(q, k, v, dout, m, l, dvec, dq, dk, dv, ws, T, S,
                            D, scale, causal, st);
  return launch_dqkv<kMaxDPad, true>(q, k, v, dout, m, l, dvec, dq, dk, dv,
                                     ws, T, S, D, scale, causal, st);
}
