// Kernel K4: the dirty-row splice, in place.
//
// Replaces the JAX package's parallel/fleet.py::_dma_row_splice kernel
// (:258-286): K rows [K, W] are copied into the resident [rows_total, W]
// grid at rows lin[k], writing the grid in place (the TPU kernel aliases
// its output to the grid, input_output_aliases={2: 0}).  One kernel
// serves the endpoint grids (W = E) and the per-group planes (W = 1).
// Duplicate destinations carry identical rows (the planner's pad rows
// repeat row 0), so the order of the writes does not matter.  The
// wrapper checks every lin against rows_total before the launch.
//
// Bound on the H100: 8 W + 4 bytes per row read and 4 W written, so
// 10,000 rows of width 4 move 360 KB (0.1 us at 3.35 TB/s): the launch
// dominates.  The TPU kernel's double-buffered DMA pipeline has no use
// here: one thread per element, neighbouring threads on neighbouring
// columns of a row, and a grid-stride loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void row_splice_kernel(int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ lin,
                                  const int32_t* __restrict__ rows,
                                  long long K, int W) {
  const long long total = K * W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long k = i / W;
    const int c = static_cast<int>(i - k * W);
    dst[static_cast<long long>(lin[k]) * W + c] = rows[i];
  }
}

}  // namespace

extern "C" int agac_row_splice(void* dst, const void* lin, const void* rows,
                               long long K, int W, void* stream) {
  const int threads = 256;
  long long blocks = (K * W + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  row_splice_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(dst), static_cast<const int32_t*>(lin),
      static_cast<const int32_t*>(rows), K, W);
  return static_cast<int>(cudaGetLastError());
}
