// Kernels K7 and K8: the two-sweep causal flash-attention backward on the
// strided [T, S, D] bf16 layout, the S axis being independent heads.
//
// K7 replaces the JAX package's ops/pallas_attention.py::_dq_kernel
// (:455, pallas_call at :977) and K8 replaces _dkv_kernel (:707,
// pallas_call at :1005), both launched by _flash_bwd_padded (:885) when
// the fused one-sweep backward (_dqkv_kernel, K9) is not eligible.  Both
// rebuild the softmax from the forward's saved stats (K6b) and take
// dvec = rowsum(do * o) in f32 from the wrapper, which computes it with
// plain torch ops as the reference does outside its kernels (:905-909).
// Same arithmetic as the reference bodies:
// - q' = bf16(q * D^-0.5), the forward's own rounding, so s and p match
//   the saved stats bit for bit; s = q'.k^T from bf16 operands with f32
//   sums, masked scores -1e30 (causal by global position, keys past T);
// - p = exp(s - m) / max(l, 1) in f32; dp = do.v^T; ds = p * (dp - dvec);
// - K7: dq = bf16(sum_j bf16(ds_ij).k_j * D^-0.5), the scale applied once
//   to the f32 sum (:517-519);
// - K8: dv = bf16(sum_i bf16(p_ij)^T.do_i) and dk = bf16(sum_i
//   bf16(ds_ij)^T.q'_i), q' carrying the scale already (:711-713);
// all sums f32, blocks in ascending order.  expf and the division are
// IEEE (no fast-math flag).  Each CTA owns its output rows and writes them
// once, with no atomics: a backward is bit-for-bit reproducible.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16).  Per live (query, key)
// pair, 2 D flops for each product: K7 runs three (s, dp, dq), K8 four
// (s, dp, dv, dk); there are T (T + 1) / 2 live pairs a head.  Bytes:
// K7 reads q, k, v, do and m, l, dvec and writes dq (10 T S D + 12 T S);
// K8 reads the same and writes dk and dv (12 T S D + 12 T S).
// - T = 64, S = 8192, D = 32 (the train command's defaults): 174 MB and
//   208 MB, bound by bytes at 52 us (K7) and 62 us (K8).
// - T = 2048, S = 128, D = 128: 206 and 275 GFLOP, bound by operations at
//   0.209 ms (K7) and 0.278 ms (K8).
//
// Design.  The TPU kernels walk a grid of (head, row block, column block)
// with f32 accumulators in VMEM scratch carried across grid steps, on
// head-major copies padded to (8, 128) tiles.  Here one CTA of four warps
// owns one (head, 64-row block) of its output and loops over the blocks
// it needs, skipping those the causal mask empties, so neither kernel
// needs a block table or carries state between CTAs:
// - K7, one CTA per (head, q block), walks the live K blocks j <= i (the
//   forward's loop); each warp owns 16 query rows and keeps the dq
//   accumulator of its rows in registers;
// - K8, one CTA per (head, K block), walks the live q blocks i >= j and
//   computes the transposed tiles s^T = k.q'^T and dp^T = v.do^T; each
//   warp owns 16 keys and keeps their dk and dv accumulators in registers,
//   and walks each q block in two halves of 32 rows so that the s^T and
//   dp^T tiles of a half, 32 registers, fit beside the 128 of dk and dv at
//   D = 128.  K blocks launch longest first (block 0 has the most q blocks
//   when causal), the mirror of the forward's order.
// A head wider than 128 runs in chunks of 128 output columns, one CTA
// each (a third grid dimension): s and dp (s^T and dp^T) contract over
// every chunk in ascending order, so each chunk rebuilds the same p and
// ds bit for bit at the price of one more pass over the scores per
// chunk; the four tiles are then restaged chunk by chunk.
// The four tiles a CTA reads (q', do, k, v) stage through shared memory
// with plain 16-byte loads; every product is mma.sync m16n8k16 with its
// fragments read from those tiles, and p or ds repacks from the
// accumulator layout into the A operand of the next product.  Padded
// rows are zero-filled in shared memory and never written; in K8 a padded
// q row is masked explicitly and reads m = 0, l = 1, dvec = 0, since its
// stats were never written.  (No cp.async, TMA or wgmma: that is the
// faster kernels' work.)
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// Four bf16 tiles of kBlock rows (row stride kDPad + 8), plus (K8) m, l
// and dvec of one q block.
template <int kDPad>
constexpr int smem_bytes() {
  return 4 * kBlock * (kDPad + 8) * 2 + 3 * kBlock * 4;
}

// kChunked: D > 128, so kDPad = 128 and blockIdx.z picks the output
// columns [128 z, 128 z + 128); s and dp contract over every chunk.
template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, int T, int S, int D, float scale,
    int causal) {
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;    // k-steps over D
  constexpr int kDTiles = kDPad / 8;    // n-tiles of dq over D
  constexpr int kKTiles = kBlock / 8;   // n-tiles of s and dp over keys
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;
  __nv_bfloat16* vs = ks + kTile;

  const int s = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int row0 = q0 + warp * 16 + g;         // this lane's two rows
  const int row1 = row0 + 8;
  const int oc = kChunked ? blockIdx.z * kDPad : 0;   // output columns

  if constexpr (!kChunked) {
    load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale);
    load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f);
  }
  // the rows' stats; a padded row (never written) computes with
  // m = 0, l = 1, dvec = 0 on zero q' and do, and is never stored
  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const long long i = static_cast<long long>(s) * T + row;
    mr[r] = row < T ? m[i] : 0.f;
    lr[r] = row < T ? fmaxf(l[i], 1.f) : 1.f;
    dr[r] = row < T ? dvec[i] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kb = (T + kBlock - 1) / kBlock;
  const int last_kb = causal ? qb : n_kb - 1;
  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * kBlock;

    // s = q'.k^T and dp = do.v^T: 16 rows x 64 keys per warp, over the
    // column chunks in order (one chunk unless kChunked)
    float sc[kKTiles][4], dp[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
    for (int c = 0; c < (kChunked ? D : 1); c += kDPad) {
      __syncthreads();   // every warp is done with the previous tiles
      if constexpr (kChunked) {
        load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, c);
        load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, c);
      }
      load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, c);
      load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f, c);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qa[4], da[4];
        a_frag(qa, qs, kStride, warp * 16, kk);
        a_frag(da, dos, kStride, warp * 16, kk);
#pragma unroll
        for (int nt = 0; nt < kKTiles; ++nt) {
          mma_nk(sc[nt], qa, ks, kStride, nt * 8, kk);
          mma_nk(dp[nt], da, vs, kStride, nt * 8, kk);
        }
      }
    }
    if constexpr (kChunked) {   // k's output chunk for ds.k
      __syncthreads();
      load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, oc);
      __syncthreads();
    }

    // p = exp(s - m) / max(l, 1); ds = p * (dp - dvec), kept in sc
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * tq + (i & 1);
        const int r = i >> 1;
        const int row = r ? row1 : row0;
        const float sv =
            (key >= T || (causal && key > row)) ? kNegInf : sc[nt][i];
        const float p = expf(sv - mr[r]) / lr[r];
        sc[nt][i] = p * (dp[nt][i] - dr[r]);
      }
    }

    // dq += bf16(ds).k: k is the B operand stored [key][d]
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t dsa[4];
      pack_acc(dsa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt)
        mma_kn(acc[nt], dsa, ks, kStride, nt * 8, kk);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
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

// kChunked as in flash_bwd_dq_kernel: s^T and dp^T contract over every
// column chunk, dk and dv are the chunk blockIdx.z.
template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T,
    int S, int D, float scale, int causal) {
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;    // k-steps of s^T, dp^T over D
  constexpr int kDTiles = kDPad / 8;    // n-tiles of dk, dv over D
  constexpr int kHalf = kBlock / 2;     // q rows per pass
  constexpr int kQTiles = kHalf / 8;    // n-tiles of s^T, dp^T per pass
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qs = vs + kTile;
  __nv_bfloat16* dos = qs + kTile;
  float* ms = reinterpret_cast<float*>(dos + kTile);
  float* ls = ms + kBlock;
  float* dvs = ls + kBlock;

  const int s = blockIdx.x;
  const int kb = blockIdx.y;                   // block 0 has the most work
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int key0 = k0 + warp * 16 + g;         // this lane's two keys
  const int key1 = key0 + 8;
  const int oc = kChunked ? blockIdx.z * kDPad : 0;   // output columns

  if constexpr (!kChunked) {
    load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f);
    load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f);
  }

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  const int n_qb = (T + kBlock - 1) / kBlock;
  for (int qb = causal ? kb : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();   // every warp is done with the previous q block
    if constexpr (!kChunked) {
      load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale);
      load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f);
    }
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const int row = q0 + i;
      const long long j = static_cast<long long>(s) * T + row;
      ms[i] = row < T ? m[j] : 0.f;
      ls[i] = row < T ? fmaxf(l[j], 1.f) : 1.f;
      dvs[i] = row < T ? dvec[j] : 0.f;
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

      // p^T = exp(s^T - m) / max(l, 1), kept in st; ds^T in dpt
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = h + nt * 8 + 2 * tq + (i & 1);   // q row in block
          const int row = q0 + c;
          const int key = (i < 2) ? key0 : key1;
          const bool masked =
              key >= T || row >= T || (causal && row < key);
          const float p =
              expf((masked ? kNegInf : st[nt][i]) - ms[c]) / ls[c];
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - dvs[c]);
        }
      }

      if constexpr (kChunked) {   // q' and do of the output chunk
        __syncthreads();
        load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, oc);
        load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, oc);
        __syncthreads();
      }

      // dv += bf16(p^T).do and dk += bf16(ds^T).q': do and q' are the B
      // operands stored [q row][d]
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

template <int kDPad, bool kChunked = false>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* dvec, void* dq,
              int T, int S, int D, float scale, int causal,
              cudaStream_t stream) {
  static unsigned allowed = 0;
  constexpr int bytes = smem_bytes<kDPad>();
  const int err =
      allow_smem(flash_bwd_dq_kernel<kDPad, kChunked>, bytes, &allowed);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock, kChunked ? d_chunks(D) : 1);
  flash_bwd_dq_kernel<kDPad, kChunked><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kDPad, bool kChunked = false>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* m, const void* l,
               const void* dvec, void* dk, void* dv, int T, int S, int D,
               float scale, int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  constexpr int bytes = smem_bytes<kDPad>();
  const int err =
      allow_smem(flash_bwd_dkv_kernel<kDPad, kChunked>, bytes, &allowed);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock, kChunked ? d_chunks(D) : 1);
  flash_bwd_dkv_kernel<kDPad, kChunked><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T,
      S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (ops/cuda_attention.py) checks: q, k, v, do and the outputs
// contiguous bf16 [T, S, D] on one device, 16-byte aligned, D a multiple
// of 8 (it pads other widths; scale is the true width's); m, l and dvec
// contiguous f32 [S, T].
extern "C" int agac_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* m,
                                 const void* l, const void* dvec, void* dq,
                                 int T, int S, int D, float scale,
                                 int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_dq<16>(q, k, v, dout, m, l, dvec, dq, T, S, D, scale,
                         causal, st);
  if (D <= 32)
    return launch_dq<32>(q, k, v, dout, m, l, dvec, dq, T, S, D, scale,
                         causal, st);
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, m, l, dvec, dq, T, S, D, scale,
                         causal, st);
  if (D <= kMaxDPad)
    return launch_dq<128>(q, k, v, dout, m, l, dvec, dq, T, S, D, scale,
                          causal, st);
  return launch_dq<kMaxDPad, true>(q, k, v, dout, m, l, dvec, dq, T, S, D,
                                   scale, causal, st);
}

extern "C" int agac_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* m, const void* l,
                                  const void* dvec, void* dk, void* dv,
                                  int T, int S, int D, float scale,
                                  int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_dkv<16>(q, k, v, dout, m, l, dvec, dk, dv, T, S, D, scale,
                          causal, st);
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, m, l, dvec, dk, dv, T, S, D, scale,
                          causal, st);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, m, l, dvec, dk, dv, T, S, D, scale,
                          causal, st);
  if (D <= kMaxDPad)
    return launch_dkv<128>(q, k, v, dout, m, l, dvec, dk, dv, T, S, D,
                           scale, causal, st);
  return launch_dkv<kMaxDPad, true>(q, k, v, dout, m, l, dvec, dk, dv, T, S,
                                    D, scale, causal, st);
}
