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
//
// Design.  The TPU kernel pads D to 128 lanes and T to (8, 128) tiles,
// transposes [T, S, D] to head-major twice around the call, and walks a
// grid of (head, q block, k block) with the running (m, l, acc) in VMEM
// scratch between grid steps.  Here one CTA of four warps owns one
// (head, 64-row q block), reads the strided [T, S, D] layout in place
// (no transposes; D pads to 16, 32, 64 or 128 only in shared memory and
// registers, with zeros, and a wider head runs in chunks of 128 output
// columns, one CTA each, its scores contracting over every chunk,
// restaged with each K block) and loops over its own
// live K blocks, skipping those wholly in its future, so the causal
// triangle needs no block table.  The running state lives in registers:
// each warp owns 16 query rows; s and o are mma.sync m16n8k16 bf16 tiles
// with f32 accumulators, the row max and sum reduce across the four
// lanes that share a row, and the p tile is repacked from the s
// accumulator layout into the A operand of p.v without touching shared
// memory.  K and V tiles stage through shared memory with plain 16-byte
// loads (no cp.async, TMA or wgmma: that is the faster kernel's work).
// q blocks launch longest first to shorten the causal tail.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// kStats: K6b (write m and l, divide by max(l, 1)); else K6a.
// kChunked: D > 128, so kDPad = 128 and blockIdx.z picks the output
// columns [128 z, 128 z + 128); the scores contract over every chunk.
template <int kDPad, bool kStats, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int T, int S,
    int D, float scale, int causal) {
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
  const int oc = kChunked ? blockIdx.z * kDPad : 0;   // output columns

  // q' = bf16(q * scale), staged through ks into A fragments (chunked:
  // restaged with each K block, chunk by chunk)
  uint32_t qa[kChunked ? 1 : kSteps][4];
  if constexpr (!kChunked) {
    load_tile<kDPad, kStride, true>(ks, q, q0, T, S, D, s, scale);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      a_frag(qa[kk], ks, kStride, warp * 16, kk);
  }

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

    // s = q' . k^T: 16 rows x 64 keys per warp
    float sc[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (kChunked) {
      // q' chunk in vs, k chunk in ks; then v's output chunk in vs
      for (int c = 0; c < D; c += kDPad) {
        __syncthreads();
        load_tile<kDPad, kStride, true>(vs, q, q0, T, S, D, s, scale, c);
        load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, c);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          a_frag(qa[0], vs, kStride, warp * 16, kk);
#pragma unroll
          for (int nt = 0; nt < kKTiles; ++nt)
            mma_nk(sc[nt], qa[0], ks, kStride, nt * 8, kk);
        }
      }
      __syncthreads();
      load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f, oc);
      __syncthreads();
    } else {
      __syncthreads();   // every warp is done with the previous tiles
      load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f);
      load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          mma_nk(sc[nt], qa[kk], ks, kStride, nt * 8, kk);
      }
    }

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

  // o = acc / l: every live row attended key 0, so l > 0 (K6b divides
  // by max(l, 1), as _stats_kernel does, which is the same number)
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

template <int kDPad, bool kStats, bool kChunked = false>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int T, int S, int D, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid(S, (T + kBlock - 1) / kBlock, kChunked ? d_chunks(D) : 1);
  flash_fwd_kernel<kDPad, kStats, kChunked><<<grid, kThreads, 0, stream>>>(
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
    return launch<16, kStats>(q, k, v, o, m, l, T, S, D, scale, causal, st);
  if (D <= 32)
    return launch<32, kStats>(q, k, v, o, m, l, T, S, D, scale, causal, st);
  if (D <= 64)
    return launch<64, kStats>(q, k, v, o, m, l, T, S, D, scale, causal, st);
  if (D <= kMaxDPad)
    return launch<128, kStats>(q, k, v, o, m, l, T, S, D, scale, causal, st);
  return launch<kMaxDPad, kStats, true>(q, k, v, o, m, l, T, S, D, scale,
                                        causal, st);
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
