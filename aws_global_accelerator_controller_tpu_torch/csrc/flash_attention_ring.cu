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
// cover f32's 24; every difference is exact in f32), and s accumulates
// hi.k^T, mid.k^T and lo.k^T on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators).  Each product of a bf16 term and a bf16 k
// is exact in f32, so s is the f32 product up to the order of its f32
// sums, the same freedom an f32 matmul has.  The alternative, f32 FMA on
// the CUDA cores, is the same function at a fifth of the rate (67 TFLOP/s
// f32 against 989 bf16 over three passes); the split keeps the forward's
// tensor-core structure of K6b and costs two more products.
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
//
// Design.  One CTA of four warps owns one (head, 64-row q block) and
// loops over its live K blocks (causal: those not wholly in its future),
// as K6a/K6b do.  The three bf16 terms of its q' block are staged once
// into shared memory beside the K and V tiles (five 64-row tiles, up to
// 87 KB at D = 128, dynamic shared memory) and read as A fragments at
// every K block; each warp owns 16 query rows, the running m, l and the
// f32 acc live in registers, and p repacks from the score accumulators
// into the A operand of p.v without touching shared memory.  A head
// wider than 128 runs in 128-column chunks of the output (a third grid
// dimension), restaging q' and k chunk by chunk for each K block.  Tiles
// stage with plain 16-byte loads (no cp.async, TMA or wgmma: that is the
// faster kernel's work).  q blocks launch longest first to shorten the
// causal tail.  Padded rows are never written.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// Columns [c0, c0 + kDPad) of rows [t0, t0 + kBlock) of one head's f32 q
// [Tq, D], times scale, split into three bf16 tiles hi, mid, lo (row
// stride kStride) with hi + mid + lo == q * scale exactly; zero past Tq
// and past D.  D and c0 are multiples of 8.
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
      const float s = __fmul_rn(x[j], scale);
      const __nv_bfloat16 h = __float2bfloat16_rn(s);
      const float r1 = __fsub_rn(s, __bfloat162float(h));
      const __nv_bfloat16 md = __float2bfloat16_rn(r1);
      const float r2 = __fsub_rn(r1, __bfloat162float(md));
      const int at = r * kStride + c + j;
      hi[at] = h;
      mid[at] = md;
      lo[at] = __float2bfloat16_rn(r2);
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

template <int kDPad>
constexpr int smem_bytes() {
  return 5 * kBlock * (kDPad + 8) * 2;   // q' hi, mid, lo, k, v
}

// kChunked: D > 128, so kDPad = 128 and blockIdx.z picks the output
// columns [128 z, 128 z + 128); the scores contract over every chunk.
template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_ring_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Tq, int Tk,
    int D, float scale, int causal) {
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
  const int oc = kChunked ? blockIdx.z * kDPad : 0;   // output columns
  const float* qh = q + static_cast<long long>(h) * Tq * D;
  const __nv_bfloat16* kh = k + static_cast<long long>(h) * Tk * D;
  const __nv_bfloat16* vh = v + static_cast<long long>(h) * Tk * D;

  // q' split once (chunked: restaged with each K block, chunk by chunk);
  // the loop's first barrier publishes it
  if constexpr (!kChunked)
    load_q_split<kDPad, kStride>(qs, qs + kTile, qs + 2 * kTile, qh, q0,
                                 Tq, D, scale, 0);

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

    float sc[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (kChunked) {
      for (int c = 0; c < D; c += kDPad) {
        __syncthreads();
        load_q_split<kDPad, kStride>(qs, qs + kTile, qs + 2 * kTile, qh,
                                     q0, Tq, D, scale, c);
        load_tile<kDPad, kStride, false>(ks, kh, k0, Tk, 1, D, 0, 1.f, c);
        __syncthreads();
        split_scores<kDPad, kStride>(sc, qs, ks, warp);
      }
      __syncthreads();
      load_tile<kDPad, kStride, false>(vs, vh, k0, Tk, 1, D, 0, 1.f, oc);
      __syncthreads();
    } else {
      __syncthreads();   // every warp is done with the previous tiles
      load_tile<kDPad, kStride, false>(ks, kh, k0, Tk, 1, D, 0, 1.f);
      load_tile<kDPad, kStride, false>(vs, vh, k0, Tk, 1, D, 0, 1.f);
      __syncthreads();
      split_scores<kDPad, kStride>(sc, qs, ks, warp);
    }

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

template <int kDPad, bool kChunked = false>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int Tq, int Tk, int H, int D, float scale, int causal,
           cudaStream_t stream) {
  static unsigned allowed = 0;
  constexpr int bytes = smem_bytes<kDPad>();
  const int err =
      allow_smem(flash_ring_kernel<kDPad, kChunked>, bytes, &allowed);
  if (err) return err;
  const dim3 grid(H, (Tq + kBlock - 1) / kBlock, kChunked ? d_chunks(D) : 1);
  flash_ring_kernel<kDPad, kChunked><<<grid, kThreads, bytes, stream>>>(
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
// Tq at least 1.
extern "C" int agac_flash_attention_ring(const void* q, const void* k,
                                         const void* v, void* o, void* m,
                                         void* l, int Tq, int Tk, int H,
                                         int D, float scale, int causal,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch<16>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= 32)
    return launch<32>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= 64)
    return launch<64>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  if (D <= kMaxDPad)
    return launch<128>(q, k, v, o, m, l, Tq, Tk, H, D, scale, causal, st);
  return launch<kMaxDPad, true>(q, k, v, o, m, l, Tq, Tk, H, D, scale,
                                causal, st);
}
