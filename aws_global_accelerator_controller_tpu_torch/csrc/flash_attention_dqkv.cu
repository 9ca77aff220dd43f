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
// Order of the sums, as the reference's: K blocks j outer, live q blocks
// i inner (i >= j when causal).  dk_j and dv_j sum over i in ascending
// order in registers; dq_i sums over j in ascending order (K7's order),
// one mma k-step of 16 keys after another, each pair's four k-steps in
// order.  Each thread owns the same elements of every dq_i for the
// whole run, so no atomics and no inter-thread reduction: two runs are
// bit for bit the same.
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
// outer, q block i inner) with a whole head's [Tp, D] f32 dq accumulator
// in VMEM.  Here one CTA of four warps owns one head (and one 128-column
// output chunk when D > 128, a second grid dimension) and loops over j
// and then the live i inside the block, which stands in for the
// sequential grid:
// - for each j, the warps hold dk_j and dv_j of their 16 keys in
//   registers (K8's layout: transposed tiles s^T = k.q'^T and dp^T =
//   v.do^T, each q block walked in two halves of 32 rows);
// - each pair's bf16(ds) goes into a shared [q row][key] tile, and after
//   a barrier each warp adds bf16(ds).k_j into the dq rows it owns
//   (K7's layout and k-step order);
// - the head's f32 dq accumulator [Tp, 128 or less] lives in an f32
//   workspace in device memory that the wrapper allocates (one slice per
//   CTA, at most 2 MiB a head under the gate, mostly served from the
//   50 MB L2; keeping it in shared memory where it fits was no faster,
//   PERF.md section 6).  Its first visit (j = 0, live for every i)
//   writes it, later ones add to it; at the end it is scaled, rounded
//   and written once.
// What bounds it: at most 32 heads a call means at most 32 CTAs (64 at
// D > 128) on 132 SMs, each walking its head's T^2 / 2 pairs alone on
// mma.sync: a quarter of the card at best, where K7 and K8 launch a CTA
// per (head, 64-row block).  Splitting a head's K blocks over a cluster
// and reducing dq in a fixed order over distributed shared memory is
// the faster kernel's work (PERF.md section 7), as are cp.async, TMA and
// wgmma.  A head wider than 128 runs in column chunks as K7 and K8 do:
// s^T and dp^T contract over every chunk in ascending order, then q',
// do and k are restaged at the output chunk.  Padded rows are
// zero-filled in shared memory, masked explicitly (a padded q row reads
// m = 0, l = 1, dvec = 0) and never written.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// Row stride of the bf16 ds tile [q row][key] (bank skew as the tiles').
constexpr int kDsStride = kBlock + 8;

// The k, v, q' and do tiles, the ds tile, and m, l, dvec of one q block.
template <int kDPad>
constexpr int tile_bytes() {
  return 4 * kBlock * (kDPad + 8) * 2 + kBlock * kDsStride * 2 +
         3 * kBlock * 4;
}

// Floats of one CTA's dq accumulator: the padded length x the columns.
template <int kDPad>
__host__ __device__ inline long long dq_floats(int T) {
  return static_cast<long long>((T + kBlock - 1) / kBlock) * kBlock * kDPad;
}

// kChunked: D > 128, so kDPad = 128 and blockIdx.y picks the output
// columns [128 y, 128 y + 128); s^T and dp^T contract over every chunk.
// ws: the dq accumulators, gridDim.x * gridDim.y slices of
// dq_floats<kDPad>(T).
template <int kDPad, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dqkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ ws, int T, int S,
    int D, float scale, int causal) {
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;    // k-steps of s^T, dp^T over D
  constexpr int kDTiles = kDPad / 8;    // n-tiles of dq, dk, dv over D
  constexpr int kHalf = kBlock / 2;     // q rows per pass
  constexpr int kQTiles = kHalf / 8;    // n-tiles of s^T, dp^T per pass
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qs = vs + kTile;
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* dss = dos + kTile;
  float* ms = reinterpret_cast<float*>(dss + kBlock * kDsStride);
  float* ls = ms + kBlock;
  float* dvs = ls + kBlock;

  const int s = blockIdx.x;
  const int oc = kChunked ? blockIdx.y * kDPad : 0;   // output columns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int n_blocks = (T + kBlock - 1) / kBlock;
  float* dqa = ws + (static_cast<long long>(blockIdx.x) * gridDim.y +
                     blockIdx.y) * dq_floats<kDPad>(T);

  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * kBlock;
    const int key0 = k0 + warp * 16 + g;       // this lane's two keys
    const int key1 = key0 + 8;
    if constexpr (!kChunked) {
      __syncthreads();   // every warp is done with the previous k_j
      load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f);
      load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f);
    }
    float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

    for (int qb = causal ? kb : 0; qb < n_blocks; ++qb) {
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
            load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale,
                                            c);
            load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s,
                                             1.f, c);
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
            const float p =
                expf((masked ? kNegInf : st[nt][i]) - ms[c]) / ls[c];
            st[nt][i] = p;
            dpt[nt][i] = p * (dpt[nt][i] - dvs[c]);
            dss[c * kDsStride + key - k0] = __float2bfloat16_rn(dpt[nt][i]);
          }
        }

        if constexpr (kChunked) {   // q', do and k of the output chunk
          __syncthreads();
          load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, oc);
          load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f,
                                           oc);
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

      // dq_i += bf16(ds).k_j: each warp its 16 q rows, k the B operand
      // stored [key][d]; the accumulator read back in the mma layout
      uint32_t dsa[kBlock / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        a_frag(dsa[kk], dss, kDsStride, warp * 16, kk);
      float* rows = dqa + static_cast<long long>(q0 + warp * 16 + g) * kDPad;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        const int col = nt * 8 + 2 * tq;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (kb > 0) {
          acc[0] = rows[col];
          acc[1] = rows[col + 1];
          acc[2] = rows[8 * kDPad + col];
          acc[3] = rows[8 * kDPad + col + 1];
        }
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk)
          mma_kn(acc, dsa[kk], ks, kStride, nt * 8, kk);
        rows[col] = acc[0];
        rows[col + 1] = acc[1];
        rows[8 * kDPad + col] = acc[2];
        rows[8 * kDPad + col + 1] = acc[3];
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

  // dq = bf16(D^-0.5 * the f32 sum), once: each thread reads back only
  // the elements it wrote
  for (int qb = 0; qb < n_blocks; ++qb) {
    const float* rows =
        dqa + static_cast<long long>(qb * kBlock + warp * 16 + g) * kDPad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qb * kBlock + warp * 16 + g + 8 * r;
      if (row >= T) continue;
      __nv_bfloat16* out = dq + (static_cast<long long>(row) * S + s) * D;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        const int col = nt * 8 + 2 * tq;
        if (oc + col < D)
          *reinterpret_cast<uint32_t*>(out + oc + col) =
              pack_bf16(rows[8 * kDPad * r + col] * scale,
                        rows[8 * kDPad * r + col + 1] * scale);
      }
    }
  }
}

template <int kDPad, bool kChunked = false>
long long workspace_floats(int T, int S, int D) {
  return dq_floats<kDPad>(T) * S * (kChunked ? d_chunks(D) : 1);
}

template <int kDPad, bool kChunked = false>
int launch_dqkv(const void* q, const void* k, const void* v,
                const void* dout, const void* m, const void* l,
                const void* dvec, void* dq, void* dk, void* dv, void* ws,
                int T, int S, int D, float scale, int causal,
                cudaStream_t stream) {
  static unsigned allowed = 0;
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = tile_bytes<kDPad>();
  const int err =
      allow_smem(flash_bwd_dqkv_kernel<kDPad, kChunked>, bytes, &allowed);
  if (err) return err;
  const dim3 grid(S, kChunked ? d_chunks(D) : 1);
  flash_bwd_dqkv_kernel<kDPad, kChunked><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(ws), T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 workspace agac_flash_bwd_dqkv needs at these sizes, in floats.
extern "C" long long agac_flash_bwd_dqkv_workspace(int T, int S, int D) {
  if (D <= 16) return workspace_floats<16>(T, S, D);
  if (D <= 32) return workspace_floats<32>(T, S, D);
  if (D <= 64) return workspace_floats<64>(T, S, D);
  if (D <= kMaxDPad) return workspace_floats<128>(T, S, D);
  return workspace_floats<kMaxDPad, true>(T, S, D);
}

// The wrapper (ops/cuda_attention.py) checks: q, k, v, do and the outputs
// contiguous bf16 [T, S, D] on one device, 16-byte aligned, D a multiple
// of 8 (it pads other widths; scale is the true width's); m, l and dvec
// contiguous f32 [S, T]; ws at least agac_flash_bwd_dqkv_workspace
// floats.
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
