// Kernel K2: the weight quantizer, scores [G, E] f32 + mask [G, E] ->
// int32 weights [G, E].
//
// Replaces the JAX package's ops/pallas_weights.py::_kernel (:47), which
// runs plan_block on (8, 128)-padded VMEM blocks of group rows: a masked
// softmax over a group's E endpoints, the all-masked guard
// m > finfo.min / 2, the 1e-30 clamp on the denominator, x255, round half
// to even, int32, 0 where masked.
//
// Bound on the H100: a streaming pass that reads 5 bytes and writes 4 a
// cell and does about 8 f32 operations a cell, so bytes bound it:
// [16384, 16] moves 2.4 MB (0.70 us at 3.35 TB/s), [1e6, 4] 36 MB
// (10.7 us).  At the first size one launch and a DRAM round trip are most
// of the time.  The levers are the width of each access and the bytes in
// flight: no shared memory (a row is read once and no data is reused
// across threads), no TMA (a tile-shaped copy buys nothing for rows of
// 16-128 bytes that each thread reads once, and its mbarrier round trip
// adds latency to a kernel that is mostly latency), no tensor cores (no
// product anywhere).
//
// Two routes, chosen by E and by the inputs' layout alone:
//
// - The quad route, for E a multiple of 4 up to 32 with scores and out on
//   16-byte and mask on 4-byte boundaries (a view's storage offset can
//   break that: `buf[1:].view(G, E)` is contiguous and off by one cell).
//   Each lane owns 4 contiguous cells of a row: one 16-byte load of
//   scores, one 4-byte load of the 4 mask bytes, one 16-byte store of the
//   weights.  A row takes row_width(E) / 4 lanes (1 at E = 4, 4 at
//   E = 16), so at E = 4 a warp reads 512 contiguous bytes of scores in
//   one instruction.  A thread plans one quad of one row: 20 bytes in
//   flight a thread where the scalar kernel had 5, and a thread for each
//   quad of the grid, so even 16384 x 16 fills every SM.  Planning 2, 4
//   or 8 rows a thread with all their loads issued first, or walking the
//   rows in steps of a grid capped at the card's resident CTAs, with or
//   without the next row's loads in flight, was no faster at 1e6 x 4 and
//   slower at 16384 x 16, where fewer threads leave SMs idle (PERF.md).
//   The arithmetic is once a cell: the max by fmaxf, e = expf(s - m)
//   kept in a register, the sum, and rintf(e / fmaxf(sum, 1e-30f) * 255)
//   where the cell is valid and sum > 0, else 0.
// - The scalar route, for every other E or layout: plan_block.cuh's
//   plan_row, a row planned by row_width(E) lanes of one cell each (K3's
//   epilogue runs the same function).
//
// The bit contract: the quad route writes what the scalar route writes,
// value for value.  Both use accurate expf and an IEEE division (the
// build passes no fast-math flag) and no product that nvcc could contract
// into an FMA.
// - The max is exact in any order: fmaxf returns one of its operands, and
//   a NaN operand is dropped (fmaxf(NaN, x) = x; m starts at -FLT_MAX, so
//   a NaN score never becomes m), so the max of a row is the same value
//   whatever the tree.  Only the sign of a zero m could depend on the
//   order, and s - (+0) and s - (-0) are equal for every s but s = -0,
//   where they are -0 and +0, both of which expf takes to 1.
// - The sum is not: f32 addition does not associate, so the quad route
//   sums in the scalar route's tree.  The scalar route puts cell j
//   (j < E <= 32) in lane j of a row of width = row_width(E) lanes, a
//   masked cell or a cell past E as +0.0 at its place, and runs an xor
//   butterfly with offsets width/2, ..., 2, 1: level by level, cell j is
//   added to cell j + off of the partial sums (every lane of a pair gets
//   the same value, since a + b = b + a exactly).  The quad route's lane q
//   holds cells 4q .. 4q + 3 as four partial sums.  First the levels with
//   offsets of 4 cells or more, which cross lanes: a shuffle at lane
//   offset off / 4 for each of the four components, since cell 4q + c
//   xor off is cell c of lane q xor off / 4.  Then the two levels inside
//   the lane: cell j with j + 2, then with j + 1, that is
//   (c0 + c2) + (c1 + c3).  At E = 12, 20, 24 and 28 the missing quads
//   are lanes of zeros at their places in the tree, as the scalar route's
//   lanes past E are.
#include <cuda_runtime.h>

#include <cstdint>

#include "plan_block.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void plan_weights_kernel(const float* __restrict__ scores,
                                    const uint8_t* __restrict__ mask,
                                    int32_t* __restrict__ out, long long G,
                                    int E, int width) {
  const int rows_per_block = blockDim.x / width;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block +
                        threadIdx.x / width;
  const int lane = threadIdx.x % width;
  const bool valid = row < G;
  const long long base = (valid ? row : 0) * static_cast<long long>(E);
  agac::plan_row(scores + base, mask + base, out + base, E, lane, width,
                 valid);
}

// One row's quad of cells, planned by the kLanes lanes of its row (every
// lane of the warp calls this, a lane with no quad holding zeros).
template <int kLanes>
__device__ __forceinline__ int4 plan_quad(float4 s, uint32_t mask_bytes) {
  const float v[4] = {s.x, s.y, s.z, s.w};
  bool ok[4];
  float mx = -FLT_MAX;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ok[c] = (mask_bytes >> (8 * c)) & 0xffu;
    if (ok[c]) mx = fmaxf(mx, v[c]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, kLanes));
  }
  if (!(mx > -FLT_MAX * 0.5f)) mx = 0.0f;

  float e[4], t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e[c] = ok[c] ? expf(v[c] - mx) : 0.0f;
    t[c] = e[c];
  }
  // levels across lanes: cell offsets width/2 .. 4
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t[c] += __shfl_xor_sync(0xffffffffu, t[c], off, kLanes);
    }
  }
  // levels inside the lane: cell j with j + 2, then with j + 1
  const float pair0 = t[0] + t[2], pair1 = t[1] + t[3];
  const float sum = pair0 + pair1;

  const float den = fmaxf(sum, 1e-30f);
  int32_t w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c] = ok[c] && sum > 0.0f
               ? static_cast<int32_t>(rintf(e[c] / den * agac::kMaxWeight))
               : 0;
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
    plan_weights_quad_kernel(const float* __restrict__ scores,
                             const uint8_t* __restrict__ mask,
                             int32_t* __restrict__ out, long long G, int E) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / kLanes) +
      threadIdx.x / kLanes;
  const int quad = threadIdx.x % kLanes;
  const bool mine = row < G && quad * 4 < E;
  const long long at = mine ? row * E + quad * 4 : 0;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint32_t m = 0u;
  if (mine) {
    s = __ldg(reinterpret_cast<const float4*>(scores + at));
    m = __ldg(reinterpret_cast<const unsigned int*>(mask + at));
  }
  const int4 w = plan_quad<kLanes>(s, m);
  if (mine) *reinterpret_cast<int4*>(out + at) = w;
}

template <int kLanes>
void launch_quad(dim3 grid, cudaStream_t st, const float* s,
                 const uint8_t* m, int32_t* o, long long G, int E) {
  plan_weights_quad_kernel<kLanes><<<grid, kThreads, 0, st>>>(s, m, o, G, E);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int agac_plan_weights(const void* scores, const void* mask,
                                 void* out, long long G, int E,
                                 void* stream) {
  const auto* s = static_cast<const float*>(scores);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int width = agac::row_width(E);
  const bool quad = E > 0 && E % 4 == 0 && E <= 32 && aligned(s, 16) &&
                    aligned(o, 16) && aligned(m, 4);
  const int lanes = quad ? width / 4 : width;   // lanes a row
  const int rows_per_block = kThreads / lanes;
  const dim3 grid(static_cast<unsigned>((G + rows_per_block - 1) /
                                        rows_per_block));
  switch (quad ? lanes : 0) {
    case 0:
      plan_weights_kernel<<<grid, kThreads, 0, st>>>(s, m, o, G, E, width);
      break;
    case 1: launch_quad<1>(grid, st, s, m, o, G, E); break;
    case 2: launch_quad<2>(grid, st, s, m, o, G, E); break;
    case 4: launch_quad<4>(grid, st, s, m, o, G, E); break;
    default: launch_quad<8>(grid, st, s, m, o, G, E); break;
  }
  return static_cast<int>(cudaGetLastError());
}
