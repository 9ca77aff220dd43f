// Kernel K2: the weight quantizer, scores [G, E] f32 + mask [G, E] ->
// int32 weights [G, E].
//
// Replaces the JAX package's ops/pallas_weights.py::_kernel (:47), which
// runs plan_block on (8, 128)-padded VMEM blocks of group rows.  Here no
// padding: each row is planned by the smallest power-of-two group of
// lanes that covers min(E, 32) endpoints (4 lanes at E = 4, 16 at
// E = 16), so one warp plans 32 / width rows and the loads of a warp are
// contiguous.
//
// Bound on the H100: it reads 5 bytes and writes 4 per cell, so
// [16384, 16] moves 2.4 MB (0.7 us at 3.35 TB/s) and [1e6, 4] 36 MB
// (11 us): memory-bound, and at the fleet planner's sizes the launch
// dominates.  The design keeps to one pass over the row (max, sum, write
// each read from L1) and spends no shared memory.
#include <cuda_runtime.h>

#include "plan_block.cuh"

namespace {

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

}  // namespace

extern "C" int agac_plan_weights(const void* scores, const void* mask,
                                 void* out, long long G, int E,
                                 void* stream) {
  const int threads = 256;
  const int width = agac::row_width(E);
  const int rows_per_block = threads / width;
  const long long blocks = (G + rows_per_block - 1) / rows_per_block;
  plan_weights_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(out), G, E, width);
  return static_cast<int>(cudaGetLastError());
}
