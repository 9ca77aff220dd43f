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
// - T = 1024, S = 64, D = 160: 32.2 and 43.0 GFLOP, bound by operations
//   at 0.0326 ms (K7) and 0.0435 ms (K8).
//
// Design.  The TPU kernels walk a grid of (head, row block, column block)
// with f32 accumulators in VMEM scratch carried across grid steps, on
// head-major copies padded to (8, 128) tiles.  Here one CTA owns one
// (head, 64-row block) of its output and loops over the blocks it needs,
// skipping those the causal mask empties, so neither kernel needs a block
// table or carries state between CTAs:
// - K7, one CTA per (head, q block), longest rows first, walks the live K
//   blocks j <= i; each warp owns 16 query rows and keeps the dq
//   accumulator of its rows in registers.
// - K8, one CTA per (head, K block), walks the live q blocks i >= j and
//   computes the transposed tiles s^T = k.q'^T and dp^T = v.do^T; each
//   warp owns 16 keys and keeps their dk and dv accumulators in registers,
//   and walks each q block in two passes of 32 rows, whose s^T and dp^T
//   (32 registers) fit beside the 128 of dk and dv at D = 128.
// - Copies.  The tiles the CTA owns (K7: q and do; K8: k and v) are
//   staged once by cp.async, q scaled to q' in shared memory once it
//   lands (scale_own_chunks: each thread the chunks it copied).  The
//   blocks it walks (K7: k and v; K8: q, do and m, l, dvec, q' scaled once
//   a block) are double-buffered: block j + 1 is copied into the other
//   stage while block j computes, one group a block and one barrier a
//   block (which also frees the other stage).  At D <= 64 the A fragments
//   of the owned tiles stay in registers for the CTA's life.
// - Fragments by ldmatrix.x4 (flash_common.cuh): ldsm_a for every A
//   operand held in shared memory, ldsm_b_nk for the [n][k] B operands of
//   s and dp (s^T, dp^T), ldsm_b_kn (.trans) for the [k][n] B operands of
//   ds.k, p^T.do and ds^T.q', two n-tiles an instruction (mma_kn reads
//   one with four 16-bit loads).  p and ds repack from the accumulators
//   into the A operand of the next product (pack_acc).
// - Wide heads, 128 < D <= kWideDPad: a CTA of two warpgroups holds
//   full-width tiles (row stride D rounded up to 16, plus 8).  Warp (g, r)
//   computes s and dp (s^T and dp^T) for rows 16 r and keys (q rows) 32 g
//   over every k-step of D, once a block pair; bf16 ds (bf16 p^T and
//   ds^T) go to a [row][key] tile in shared memory, rounded as pack_acc
//   rounds; then warpgroup g accumulates its half of the output columns
//   (column_groups: ceil(D / 32) 16-column groups, or the rest) over the
//   64 keys (q rows) of the block in order.  Wider heads (their tiles do
//   not fit) keep the chunked kernels below, a grid dimension of
//   128-column output chunks that each rebuild s and dp.
// - Element-wise: p = exp(s - m) / max(l, 1), ds = p (dp - dvec) in f32,
//   the division the compiler's own fast path for `/` (div_by and
//   div_reciprocal in flash_common.cuh, with why it is exact), a warp's
//   whole tile by `/` where an operand leaves that path's exact range.
// - Epilogue: dq (K7) or dk and dv (K8) are rounded into the CTA's own
//   staged rows of q' (k and v), which only the warp that owns them read,
//   and stored from there as 16-byte vectors a lane.
// - Bits.  Every accumulator sees the mma.sync m16n8k16 steps it saw
//   before, in the same order: s and dp over D in ascending k-steps, dq
//   over K blocks ascending and each block's four key k-steps in order, dk
//   and dv over q blocks ascending and each block's four q-row k-steps in
//   order; the fragments hold the same values whichever instruction loads
//   them.  So dq, dk and dv are value for value what the two sweeps gave
//   before, and what K9 gives.
// - Occupancy (shared bytes a CTA at T > 64, two stages; one stage at
//   T <= 64; the SM has 228 KB, 1 KB reserved a CTA; registers and spills
//   from nvcc -Xptxas -v for sm_90a):
//   K7 kDPad 16: 18,432 bytes, 128 registers, 4 CTAs an SM;
//      32: 30,720 (20,480), 128 registers (32 bytes spilled), 4;
//      64: 55,296, 206 registers, 2; 128: 104,448, 222 registers, 2;
//      wide: 138,240 at D = 160, 211,968 at D = 256, 256 threads, 190
//      registers, 1.
//   K8 kDPad 16: 19,968, 117 registers, 4; 32: 32,256 (21,248), 128
//      registers (32 bytes spilled), 4; 64: 56,832, 236 registers, 2;
//      128: 105,984, 254 registers, 2; wide: 148,992 at D = 160, 222,720
//      at D = 256, 255 registers, 1.
//   The narrowest kernels are capped at 128 registers (four CTAs an SM,
//   min_ctas): their blocks (the train command's T = 64) are
//   latency-bound, and four CTAs beat three without the cap.
// Padded rows are zero-filled in shared memory, masked explicitly (in K8
// a padded q row reads m = 0, l = 0 -> max(l, 1) = 1, dvec = 0, since its
// stats were never written) and never stored.  mma.sync throughout, no
// atomics, no fast-math flag.
#include "flash_common.cuh"

namespace {

using namespace agac_flash;

// Row stride of the bf16 ds (K7), p^T and ds^T (K8) tiles of a wide CTA.
constexpr int kDsStride = kBlock + 8;

// Columns of a staged tile: kDPad, or (kWide) D rounded up to 16; a row
// holds them and the bank skew of 8.
template <int kDPad, bool kWide>
__host__ __device__ inline int tile_cols(int D) {
  return kWide ? (D + 15) / 16 * 16 : kDPad;
}

// Buffers of the blocks a CTA walks: two (the next block prefetched)
// where there is more than one block.
__host__ __device__ inline int stages(int T) { return T > kBlock ? 2 : 1; }

// Threads of a CTA: a warpgroup, two where kWide.
template <bool kWide>
__host__ __device__ constexpr int cta_threads() {
  return kWide ? 2 * kThreads : kThreads;
}

// CTAs an SM the register budget must leave room for: four of the
// narrowest (their blocks are latency-bound), else one.
template <int kDPad, bool kWide>
__host__ __device__ constexpr int min_ctas() {
  return !kWide && kDPad <= 32 ? 4 : 1;
}

// K7: q' and do, then k and v of each stage; kWide adds the ds tile.
template <int kDPad, bool kWide>
__host__ __device__ inline int dq_smem_bytes(int T, int D) {
  const int tile = kBlock * (tile_cols<kDPad, kWide>(D) + 8) * 2;
  return (2 + 2 * stages(T)) * tile + (kWide ? kBlock * kDsStride * 2 : 0);
}

// K8: k and v, then q' and do of each stage, (kWide) the p^T and ds^T
// tiles, and m, l, dvec of each stage.
template <int kDPad, bool kWide>
__host__ __device__ inline int dkv_smem_bytes(int T, int D) {
  const int tile = kBlock * (tile_cols<kDPad, kWide>(D) + 8) * 2;
  return (2 + 2 * stages(T)) * tile +
         (kWide ? 2 * kBlock * kDsStride * 2 : 0) +
         stages(T) * 3 * kBlock * 4;
}

// The output columns a warp accumulates: in a wide CTA, warpgroup `half`
// takes the first ceil(steps / 2) 16-column groups of the head or the
// rest (steps = its 16-column groups); else all kDPad / 16.  Returns the
// number of groups and sets the first column.
template <int kDPad, bool kWide>
__device__ __forceinline__ int column_groups(int steps, int half, int* c0) {
  const int first = (steps + 1) / 2;
  *c0 = kWide && half ? 16 * first : 0;
  return kWide ? (half ? steps - first : first) : kDPad / 16;
}

// Rows [0, kRows) and columns [0, cols) of a staged output tile (row
// stride `stride`, row t0 of the head) to [T, S, D] as 16-byte vectors,
// rows below T and columns below D only, by kThr threads numbered tid.
template <int kRows, int kThr>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const __nv_bfloat16* stage,
                                           int stride, int cols, int t0,
                                           int tid, int T, int S, int D,
                                           int s) {
  const int chunks = cols / 8;
  for (int i = tid; i < kRows * chunks; i += kThr) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    if (t0 + r < T && c < D)
      *reinterpret_cast<uint4*>(
          out + (static_cast<long long>(t0 + r) * S + s) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * stride + c);
  }
}

// A warp's accumulator fragments (n-tiles [0, 2 n16), output column c0
// + 8 nt) into rows [r0, r0 + 16) of a staged tile, times `scale` and
// rounded to bf16 (pack_bf16, as the values were stored before).
template <int kDTiles>
__device__ __forceinline__ void stage_acc(__nv_bfloat16* tile, int stride,
                                          int r0, int c0, int n16,
                                          const float (&acc)[kDTiles][4],
                                          float scale) {
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* row = tile + (r0 + lane / 4) * stride + c0 + 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt) {
    if (nt < 2 * n16) {
      *reinterpret_cast<uint32_t*>(row + nt * 8) =
          pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(row + 8 * stride + nt * 8) =
          pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
}

// K7's element-wise step over n-tiles of s (tile nt: keys key + 8 nt +
// {0, 1}, rows row0 and row1 of this lane): p = exp(s - m) / max(l, 1)
// (lr, and rr its div_reciprocal) and ds = p * (dp - dvec), ds left in sc.
template <int kTiles>
__device__ __forceinline__ void dq_grad(float (&sc)[kTiles][4],
                                        const float (&dp)[kTiles][4],
                                        int key, int row0, int row1,
                                        const float (&mr)[2],
                                        const float (&lr)[2],
                                        const float (&rr)[2],
                                        const float (&dr)[2], int T,
                                        int causal) {
  bool fast = lr[0] <= 0x1p24f && lr[1] <= 0x1p24f;   // exp(s - m) in sc
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = key + nt * 8 + (i & 1);
      const int r = i >> 1;
      const int row = r ? row1 : row0;
      const float sv = (k >= T || (causal && k > row)) ? kNegInf : sc[nt][i];
      sc[nt][i] = expf(sv - mr[r]);
      fast &= div_in_range(sc[nt][i]);
    }
  }
  if (__all_sync(0xffffffffu, fast)) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = div_by(sc[nt][i], lr[r], rr[r]);
        sc[nt][i] = p * (dp[nt][i] - dr[r]);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = sc[nt][i] / lr[r];
        sc[nt][i] = p * (dp[nt][i] - dr[r]);
      }
  }
}

// K8's over n-tiles of s^T (tile nt: q rows c + 8 nt + {0, 1} of the
// block at q0, keys key0 and key1 of this lane): p^T left in st, ds^T in
// dpt.  A padded q row is masked and reads m = 0, l = 0, dvec = 0.
template <int kTiles>
__device__ __forceinline__ void dkv_grad(float (&st)[kTiles][4],
                                         float (&dpt)[kTiles][4], int c,
                                         int q0, int key0, int key1,
                                         const float* ms, const float* ls,
                                         const float* dvs, int T,
                                         int causal) {
  bool fast = true;   // exp(s^T - m) in st
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = c + nt * 8 + (i & 1);   // q row in block
      const int row = q0 + cc;
      const int key = (i < 2) ? key0 : key1;
      const bool masked = key >= T || row >= T || (causal && row < key);
      st[nt][i] = expf((masked ? kNegInf : st[nt][i]) - ms[cc]);
      fast &= div_in_range(st[nt][i]) && ls[cc] <= 0x1p24f;
    }
  }
  if (__all_sync(0xffffffffu, fast)) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cc = c + nt * 8 + j;
        const float lm = fmaxf(ls[cc], 1.f);
        const float rm = div_reciprocal(lm);
#pragma unroll
        for (int i = j; i < 4; i += 2) {
          const float p = div_by(st[nt][i], lm, rm);
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - dvs[cc]);
        }
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = c + nt * 8 + (i & 1);
        const float p = st[nt][i] / fmaxf(ls[cc], 1.f);
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - dvs[cc]);
      }
  }
}

// K7.  kWide: 128 < D <= kWideDPad, two warpgroups (kDPad = 128, the
// most columns of dq a warp holds); else one, D <= kDPad.
template <int kDPad, bool kWide>
__global__ void __launch_bounds__(cta_threads<kWide>(),
                                  min_ctas<kDPad, kWide>())
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ dvec,
                        __nv_bfloat16* __restrict__ dq, int T, int S, int D,
                        float scale, int causal) {
  constexpr int kCta = cta_threads<kWide>();
  constexpr int kDTiles = kDPad / 8;    // n-tiles of a warp's dq, at most
  // n-tiles of s and dp a warp computes: all 64 keys, or (kWide) its
  // warpgroup's 32
  constexpr int kKeyTiles = kWide ? kBlock / 16 : kBlock / 8;
  // q' and do A fragments kept in registers for the CTA's life
  constexpr bool kKeepA = !kWide && kDPad <= 64;
  constexpr int kKept = kKeepA ? kDPad / 16 : 1;
  const int cols = tile_cols<kDPad, kWide>(D);
  const int steps = cols / 16;          // k-steps of s and dp over D
  const int stride = cols + 8;
  const int tile = kBlock * stride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + tile;
  __nv_bfloat16* kvs = dos + tile;      // stage b: k at 2 b tiles, then v
  __nv_bfloat16* dss = kvs + 2 * stages(T) * tile;   // kWide

  const int s = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rw = warp % kWarps;                // rows [16 rw, 16 rw + 16)
  const int half = warp / kWarps;              // kWide: the warpgroup
  const int key_base = kWide ? half * (kBlock / 2) : 0;   // its keys of s
  int oc;                                      // its first dq column
  const int n16 = column_groups<kDPad, kWide>(steps, half, &oc);
  const int row0 = q0 + rw * 16 + g;           // this lane's two rows
  const int row1 = row0 + 8;
  const int n_kb = (T + kBlock - 1) / kBlock;
  const int last_kb = causal ? qb : n_kb - 1;

  // q, do and K block 0: one group
  async_tile<kCta>(qs, stride, cols, q, q0, T, S, D, s);
  async_tile<kCta>(dos, stride, cols, dout, q0, T, S, D, s);
  async_tile<kCta>(kvs, stride, cols, k, 0, T, S, D, s);
  async_tile<kCta>(kvs + tile, stride, cols, v, 0, T, S, D, s);
  async_commit();

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
  const float rr[2] = {div_reciprocal(lr[0]), div_reciprocal(lr[1])};

  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  uint32_t qa[kKept][4], da[kKept][4];

  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * kBlock;
    const __nv_bfloat16* ks = kvs + 2 * (kb & 1) * tile;
    const __nv_bfloat16* vs = ks + tile;
    async_wait<0>();   // this thread's copies of K block kb (and q, do)
    if (kb == 0) scale_own_chunks<kCta>(qs, stride, cols, scale);
    // every copy landed and q' whole; every warp done with the other
    // stage and the ds tile
    __syncthreads();
    if (kb < last_kb) {   // prefetch K block kb + 1 into the other stage
      __nv_bfloat16* next = kvs + 2 * ((kb + 1) & 1) * tile;
      async_tile<kCta>(next, stride, cols, k, k0 + kBlock, T, S, D, s);
      async_tile<kCta>(next + tile, stride, cols, v, k0 + kBlock, T, S, D,
                       s);
      async_commit();
    }
    if constexpr (kKeepA) {
      if (kb == 0) {
#pragma unroll
        for (int kk = 0; kk < kKept; ++kk) {
          ldsm_a(qa[kk], qs, stride, rw * 16, kk * 16);
          ldsm_a(da[kk], dos, stride, rw * 16, kk * 16);
        }
      }
    }

    // s = q'.k^T and dp = do.v^T: 16 rows x 64 keys a warp (kWide: x 32)
    float sc[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < (kWide ? steps : kDPad / 16); ++kk) {
      uint32_t qf[4], df[4];
      if constexpr (kKeepA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qf[i] = qa[kk][i];
          df[i] = da[kk][i];
        }
      } else {
        ldsm_a(qf, qs, stride, rw * 16, kk * 16);
        ldsm_a(df, dos, stride, rw * 16, kk * 16);
      }
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, ks, stride, key_base + np * 16, kk * 16);
        mma_bf16(sc[2 * np], qf, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf, b[2], b[3]);
        ldsm_b_nk(b, vs, stride, key_base + np * 16, kk * 16);
        mma_bf16(dp[2 * np], df, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], df, b[2], b[3]);
      }
    }

    // p = exp(s - m) / max(l, 1); ds = p * (dp - dvec), kept in sc
    dq_grad(sc, dp, k0 + key_base + 2 * tq, row0, row1, mr, lr, rr, dr, T,
            causal);

    // dq += bf16(ds).k over the block's four key k-steps in order: k is
    // the B operand stored [key][d]
    if constexpr (!kWide) {
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        uint32_t dsa[4];
        pack_acc(dsa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kDTiles / 2; ++np) {
          uint32_t b[4];
          ldsm_b_kn(b, ks, stride, kk * 16, np * 16);
          mma_bf16(acc[2 * np], dsa, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], dsa, b[2], b[3]);
        }
      }
    } else {
      // bf16(ds) into the [q row][key] tile, then each warpgroup its
      // columns over all 64 keys
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        __nv_bfloat16* p =
            dss + (rw * 16 + g) * kDsStride + key_base + nt * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * kDsStride) =
            pack_bf16(sc[nt][2], sc[nt][3]);
      }
      __syncthreads();   // the ds tile is whole
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        uint32_t dsa[4];
        ldsm_a(dsa, dss, kDsStride, rw * 16, kk * 16);
#pragma unroll
        for (int np = 0; np < kDTiles / 2; ++np) {
          if (np < n16) {
            uint32_t b[4];
            ldsm_b_kn(b, ks, stride, kk * 16, oc + np * 16);
            mma_bf16(acc[2 * np], dsa, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], dsa, b[2], b[3]);
          }
        }
      }
    }
  }

  // dq = bf16(D^-0.5 * the f32 sum), staged in q''s rows and stored as
  // 16-byte vectors
  if constexpr (!kWide) {
    // a warp's rows of q' are read by no other warp
    __syncwarp();
    stage_acc(qs, stride, rw * 16, 0, kDPad / 16, acc, scale);
    __syncwarp();
    store_rows<16, 32>(dq, qs + rw * 16 * stride, stride, cols, q0 + rw * 16,
                       lane, T, S, D, s);
  } else {
    __syncthreads();   // both warpgroups are done with q'
    stage_acc(qs, stride, rw * 16, oc, n16, acc, scale);
    __syncthreads();
    store_rows<kBlock, kCta>(dq, qs, stride, cols, q0, threadIdx.x, T, S, D,
                             s);
  }
}

// K8.  kWide as in flash_bwd_dq_kernel (the warpgroups split dk's and
// dv's columns); else one warpgroup, D <= kDPad.
template <int kDPad, bool kWide>
__global__ void __launch_bounds__(cta_threads<kWide>(),
                                  min_ctas<kDPad, kWide>())
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ dvec,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int S, int D,
                         float scale, int causal) {
  constexpr int kCta = cta_threads<kWide>();
  constexpr int kDTiles = kDPad / 8;    // n-tiles of a warp's dk, dv
  constexpr int kHalf = kBlock / 2;     // q rows of s^T, dp^T a pass
  constexpr int kQTiles = kHalf / 8;
  // k and v A fragments kept in registers for the CTA's life
  constexpr bool kKeepA = !kWide && kDPad <= 64;
  constexpr int kKept = kKeepA ? kDPad / 16 : 1;
  const int cols = tile_cols<kDPad, kWide>(D);
  const int steps = cols / 16;          // k-steps of s^T and dp^T over D
  const int stride = cols + 8;
  const int tile = kBlock * stride;
  const int n_stages = stages(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + tile;
  __nv_bfloat16* qbuf = vs + tile;                 // n_stages tiles
  __nv_bfloat16* dobuf = qbuf + n_stages * tile;   // n_stages tiles
  __nv_bfloat16* pts = dobuf + n_stages * tile;    // kWide: p^T, ds^T
  __nv_bfloat16* dsts = pts + kBlock * kDsStride;
  float* statbuf = reinterpret_cast<float*>(
      kWide ? dsts + kBlock * kDsStride : pts);    // m, l, dvec a stage

  const int s = blockIdx.x;
  const int kb = blockIdx.y;                   // block 0 has the most work
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rw = warp % kWarps;                // keys [16 rw, 16 rw + 16)
  const int half = warp / kWarps;              // kWide: the warpgroup
  int oc;                                      // its first dk, dv column
  const int n16 = column_groups<kDPad, kWide>(steps, half, &oc);
  const int key0 = k0 + rw * 16 + g;           // this lane's two keys
  const int key1 = key0 + 8;
  const int n_qb = (T + kBlock - 1) / kBlock;
  const int first_qb = causal ? kb : 0;

  // q, do and the stats of q block qb into stage b: one group
  auto stage = [&](int qb, int b) {
    async_tile<kCta>(qbuf + b * tile, stride, cols, q, qb * kBlock, T, S, D,
                     s);
    async_tile<kCta>(dobuf + b * tile, stride, cols, dout, qb * kBlock, T, S,
                     D, s);
    async_stats<kCta>(statbuf + b * 3 * kBlock, m, l, dvec, qb * kBlock, T,
                      s);
    async_commit();
  };
  async_tile<kCta>(ks, stride, cols, k, k0, T, S, D, s);
  async_tile<kCta>(vs, stride, cols, v, k0, T, S, D, s);
  stage(first_qb, 0);                          // one group with k and v

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;
  uint32_t ka[kKept][4], va[kKept][4];

  for (int qb = first_qb; qb < n_qb; ++qb) {
    const int q0 = qb * kBlock;
    const int b = (qb - first_qb) & 1;
    const __nv_bfloat16* qs = qbuf + b * tile;
    const __nv_bfloat16* dos = dobuf + b * tile;
    const float* ms = statbuf + b * 3 * kBlock;
    const float* ls = ms + kBlock;
    const float* dvs = ls + kBlock;
    async_wait<0>();   // this thread's copies of q block qb
    scale_own_chunks<kCta>(qbuf + b * tile, stride, cols, scale);
    // q' of block qb whole; every warp done with the other stage and the
    // p^T, ds^T tiles
    __syncthreads();
    if (qb + 1 < n_qb) stage(qb + 1, b ^ 1);   // prefetch q block qb + 1
    if constexpr (kKeepA) {
      if (qb == first_qb) {
#pragma unroll
        for (int kk = 0; kk < kKept; ++kk) {
          ldsm_a(ka[kk], ks, stride, rw * 16, kk * 16);
          ldsm_a(va[kk], vs, stride, rw * 16, kk * 16);
        }
      }
    }

    // s^T = k.q'^T and dp^T = v.do^T, 16 keys x 32 q rows a warp and
    // pass: both halves of the q block in turn, or (kWide) its
    // warpgroup's half
#pragma unroll
    for (int pass = 0; pass < (kWide ? 1 : kBlock / kHalf); ++pass) {
      const int h0 = (kWide ? half : pass) * kHalf;   // its first q row
      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < (kWide ? steps : kDPad / 16); ++kk) {
        uint32_t kf[4], vf[4];
        if constexpr (kKeepA) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kf[i] = ka[kk][i];
            vf[i] = va[kk][i];
          }
        } else {
          ldsm_a(kf, ks, stride, rw * 16, kk * 16);
          ldsm_a(vf, vs, stride, rw * 16, kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kQTiles / 2; ++np) {
          uint32_t b[4];
          ldsm_b_nk(b, qs, stride, h0 + np * 16, kk * 16);
          mma_bf16(st[2 * np], kf, b[0], b[1]);
          mma_bf16(st[2 * np + 1], kf, b[2], b[3]);
          ldsm_b_nk(b, dos, stride, h0 + np * 16, kk * 16);
          mma_bf16(dpt[2 * np], vf, b[0], b[1]);
          mma_bf16(dpt[2 * np + 1], vf, b[2], b[3]);
        }
      }

      // p^T = exp(s^T - m) / max(l, 1), kept in st; ds^T in dpt
      dkv_grad(st, dpt, h0 + 2 * tq, q0, key0, key1, ms, ls, dvs, T, causal);

      // dv += bf16(p^T).do and dk += bf16(ds^T).q' over the pass's q-row
      // k-steps in order: do and q' are the B operands stored [q row][d]
      if constexpr (!kWide) {
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          uint32_t pa[4], dsa[4];
          pack_acc(pa, st[2 * kk], st[2 * kk + 1]);
          pack_acc(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
          const int kq = h0 / 16 + kk;
#pragma unroll
          for (int np = 0; np < kDTiles / 2; ++np) {
            uint32_t b[4];
            ldsm_b_kn(b, dos, stride, kq * 16, np * 16);
            mma_bf16(dva[2 * np], pa, b[0], b[1]);
            mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
            ldsm_b_kn(b, qs, stride, kq * 16, np * 16);
            mma_bf16(dka[2 * np], dsa, b[0], b[1]);
            mma_bf16(dka[2 * np + 1], dsa, b[2], b[3]);
          }
        }
      } else {
        // bf16(p^T) and bf16(ds^T) into [key][q row] tiles, then each
        // warpgroup its columns over all 64 q rows
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt) {
          const int off = (rw * 16 + g) * kDsStride + h0 + nt * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(pts + off) =
              pack_bf16(st[nt][0], st[nt][1]);
          *reinterpret_cast<uint32_t*>(pts + off + 8 * kDsStride) =
              pack_bf16(st[nt][2], st[nt][3]);
          *reinterpret_cast<uint32_t*>(dsts + off) =
              pack_bf16(dpt[nt][0], dpt[nt][1]);
          *reinterpret_cast<uint32_t*>(dsts + off + 8 * kDsStride) =
              pack_bf16(dpt[nt][2], dpt[nt][3]);
        }
        __syncthreads();   // the p^T and ds^T tiles are whole
#pragma unroll
        for (int kq = 0; kq < kBlock / 16; ++kq) {
          uint32_t pa[4], dsa[4];
          ldsm_a(pa, pts, kDsStride, rw * 16, kq * 16);
          ldsm_a(dsa, dsts, kDsStride, rw * 16, kq * 16);
#pragma unroll
          for (int np = 0; np < kDTiles / 2; ++np) {
            if (np < n16) {
              uint32_t b[4];
              ldsm_b_kn(b, dos, stride, kq * 16, oc + np * 16);
              mma_bf16(dva[2 * np], pa, b[0], b[1]);
              mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
              ldsm_b_kn(b, qs, stride, kq * 16, oc + np * 16);
              mma_bf16(dka[2 * np], dsa, b[0], b[1]);
              mma_bf16(dka[2 * np + 1], dsa, b[2], b[3]);
            }
          }
        }
      }
    }
  }

  // dk and dv staged in k's and v's rows, stored as 16-byte vectors
  if constexpr (!kWide) {
    // a warp's rows of k and v are read by no other warp
    __syncwarp();
    stage_acc(ks, stride, rw * 16, 0, kDPad / 16, dka, 1.f);
    stage_acc(vs, stride, rw * 16, 0, kDPad / 16, dva, 1.f);
    __syncwarp();
    store_rows<16, 32>(dk, ks + rw * 16 * stride, stride, cols, k0 + rw * 16,
                       lane, T, S, D, s);
    store_rows<16, 32>(dv, vs + rw * 16 * stride, stride, cols, k0 + rw * 16,
                       lane, T, S, D, s);
  } else {
    __syncthreads();   // both warpgroups are done with k and v
    stage_acc(ks, stride, rw * 16, oc, n16, dka, 1.f);
    stage_acc(vs, stride, rw * 16, oc, n16, dva, 1.f);
    __syncthreads();
    store_rows<kBlock, kCta>(dk, ks, stride, cols, k0, threadIdx.x, T, S, D,
                             s);
    store_rows<kBlock, kCta>(dv, vs, stride, cols, k0, threadIdx.x, T, S, D,
                             s);
  }
}

// Heads wider than kWideDPad: full-width tiles no longer fit a CTA's
// shared memory, so blockIdx.z picks 128 output columns [128 z, 128 z +
// 128) and s and dp (s^T and dp^T) contract over every 128-column chunk
// in ascending order, rebuilt per output chunk; tiles staged through
// registers (load_tile), fragments by a_frag, mma_nk and mma_kn.
constexpr int kChunkedSmem = 4 * kBlock * (kMaxDPad + 8) * 2 + 3 * kBlock * 4;

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_chunked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, int T, int S, int D, float scale,
    int causal) {
  constexpr int kDPad = kMaxDPad;
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;
  constexpr int kDTiles = kDPad / 8;
  constexpr int kKTiles = kBlock / 8;
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;
  __nv_bfloat16* vs = ks + kTile;

  const int s = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const int oc = blockIdx.z * kDPad;

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
    float sc[kKTiles][4], dp[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
    for (int c = 0; c < D; c += kDPad) {
      __syncthreads();
      load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, c);
      load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, c);
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
    __syncthreads();
    load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, oc);
    __syncthreads();
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

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_chunked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T,
    int S, int D, float scale, int causal) {
  constexpr int kDPad = kMaxDPad;
  constexpr int kStride = kDPad + 8;
  constexpr int kSteps = kDPad / 16;
  constexpr int kDTiles = kDPad / 8;
  constexpr int kHalf = kBlock / 2;
  constexpr int kQTiles = kHalf / 8;
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
  const int kb = blockIdx.y;
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int key0 = k0 + warp * 16 + g;
  const int key1 = key0 + 8;
  const int oc = blockIdx.z * kDPad;

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  const int n_qb = (T + kBlock - 1) / kBlock;
  for (int qb = causal ? kb : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
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
      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
      for (int c = 0; c < D; c += kDPad) {
        __syncthreads();
        load_tile<kDPad, kStride, false>(ks, k, k0, T, S, D, s, 1.f, c);
        load_tile<kDPad, kStride, false>(vs, v, k0, T, S, D, s, 1.f, c);
        load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, c);
        load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, c);
        __syncthreads();
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
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = h + nt * 8 + 2 * tq + (i & 1);
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
      __syncthreads();
      load_tile<kDPad, kStride, true>(qs, q, q0, T, S, D, s, scale, oc);
      load_tile<kDPad, kStride, false>(dos, dout, q0, T, S, D, s, 1.f, oc);
      __syncthreads();
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

// The launches: kDPad 16-128 one warpgroup, kWide two (D <= kWideDPad),
// else the chunked kernel.  The shared-memory attribute is set once per
// kernel and device at the most that kernel takes (two stages, and for a
// wide one D = kWideDPad), with the largest carveout.
template <int kDPad, bool kWide = false>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* dvec, void* dq,
              int T, int S, int D, float scale, int causal,
              cudaStream_t stream) {
  static unsigned allowed = 0;
  const auto kernel = flash_bwd_dq_kernel<kDPad, kWide>;
  const int err = allow_smem(
      kernel,
      dq_smem_bytes<kDPad, kWide>(2 * kBlock, kWide ? kWideDPad : kDPad),
      &allowed, true);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock);
  kernel<<<grid, cta_threads<kWide>(), dq_smem_bytes<kDPad, kWide>(T, D),
           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kDPad, bool kWide = false>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* m, const void* l,
               const void* dvec, void* dk, void* dv, int T, int S, int D,
               float scale, int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  const auto kernel = flash_bwd_dkv_kernel<kDPad, kWide>;
  const int err = allow_smem(
      kernel,
      dkv_smem_bytes<kDPad, kWide>(2 * kBlock, kWide ? kWideDPad : kDPad),
      &allowed, true);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock);
  kernel<<<grid, cta_threads<kWide>(), dkv_smem_bytes<kDPad, kWide>(T, D),
           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T,
      S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_chunked(const void* q, const void* k, const void* v,
                      const void* dout, const void* m, const void* l,
                      const void* dvec, void* dq, int T, int S, int D,
                      float scale, int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  const int err =
      allow_smem(flash_bwd_dq_chunked_kernel, kChunkedSmem, &allowed);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock, d_chunks(D));
  flash_bwd_dq_chunked_kernel<<<grid, kThreads, kChunkedSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_chunked(const void* q, const void* k, const void* v,
                       const void* dout, const void* m, const void* l,
                       const void* dvec, void* dk, void* dv, int T, int S,
                       int D, float scale, int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  const int err =
      allow_smem(flash_bwd_dkv_chunked_kernel, kChunkedSmem, &allowed);
  if (err) return err;
  const dim3 grid(S, (T + kBlock - 1) / kBlock, d_chunks(D));
  flash_bwd_dkv_chunked_kernel<<<grid, kThreads, kChunkedSmem, stream>>>(
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
  if (D <= kWideDPad)
    return launch_dq<kMaxDPad, true>(q, k, v, dout, m, l, dvec, dq, T, S, D,
                                     scale, causal, st);
  return launch_dq_chunked(q, k, v, dout, m, l, dvec, dq, T, S, D, scale,
                           causal, st);
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
  if (D <= kWideDPad)
    return launch_dkv<kMaxDPad, true>(q, k, v, dout, m, l, dvec, dk, dv, T,
                                      S, D, scale, causal, st);
  return launch_dkv_chunked(q, k, v, dout, m, l, dvec, dk, dv, T, S, D,
                            scale, causal, st);
}
