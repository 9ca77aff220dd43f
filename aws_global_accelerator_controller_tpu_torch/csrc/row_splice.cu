// Kernel K4: the dirty-row splice, in place, into 1 to 8 grids at once.
//
// Replaces the JAX package's parallel/fleet.py::_dma_row_splice kernel
// (:258-286): K rows [K, W] are copied into the resident [rows_total, W]
// grid at rows lin[k], writing the grid in place (the TPU kernel aliases
// its output to the grid, input_output_aliases={2: 0}).  A wave of the
// resident planner splices the same positions into six grids: four
// [S * cap, E] endpoint grids and two [S * cap] planes (W = 1).  One
// launch takes them all: a table of up to kMaxGrids (destination, rows,
// width) entries travels in the kernel's parameters (a __grid_constant__
// struct, so no copy of it reaches device memory), beside lin [K] and K.
// Rows that share a destination must be equal; the order of the writes
// then does not matter.  The kernel reads lin as given: its callers prove
// every lin in range first (the wave's positions on the host before their
// one upload, parallel/fleet.py::pack_splice; the one-grid entry
// row_splice by reading lin's range back).
//
// Bound on the H100: bytes.  A row moves 4 bytes of lin plus 4 W read and
// 4 W written a grid; a wave's six grids at E = 4 move 148 bytes a row, so
// a churn wave of 10,000 rows is 1.48 MB (0.44 us at 3.35 TB/s, under the
// cost of any launch) and the cold wave's 1,000,000 rows 148 MB (44 us).
// The levers are the width of each access and the bytes in flight:
// - a lane a row of one grid (blockIdx.y names the grid): it reads lin[k]
//   once, computes the destination with one multiply (no 64-bit
//   division), and moves the row as 16-byte vectors (int4 loads and
//   stores) when W is a multiple of 4 and both the grid and the rows start
//   on 16-byte boundaries, which the kernel checks itself, else as 4-byte
//   scalars.  At W = 4 a row is one vector, so a warp reads 512
//   contiguous bytes of rows in one instruction and stores 32 rows of 16
//   bytes each;
// - a grid-stride loop over at most 8 CTAs of 256 threads an SM, shared
//   by the grids (the card's 132 SMs hold 1056 such CTAs), so the cold
//   wave keeps every SM's threads busy with a load in flight each and a
//   churn wave of 10,000 rows still takes a lane a row.
// No shared memory: every byte is read once and written once, and nothing
// is reused across threads.  No TMA: a TMA store of a 16-byte row would
// cost a descriptor and an mbarrier round trip for one vector's worth of
// bytes, the same reason the JAX package scatters its planes instead of
// issuing a DMA a row (parallel/fleet.py:294-298 of the JAX package).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGrids = 8;
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

struct SpliceGrid {
  int32_t* dst;
  const int32_t* rows;
  long long width;
};

struct SpliceTable {
  SpliceGrid grid[kMaxGrids];
};

__global__ void __launch_bounds__(kThreads)
    row_splice_kernel(const __grid_constant__ SpliceTable table,
                      const int32_t* __restrict__ lin, long long K) {
  const SpliceGrid& g = table.grid[blockIdx.y];
  int32_t* __restrict__ dst = g.dst;
  const int32_t* __restrict__ rows = g.rows;
  const long long W = g.width;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(rows)) & 15) == 0;
  if (vec) {
    const long long W4 = W / 4;
    const int4* __restrict__ src = reinterpret_cast<const int4*>(rows);
    int4* __restrict__ out = reinterpret_cast<int4*>(dst);
    for (; k < K; k += stride) {
      const int4* s = src + k * W4;
      int4* d = out + static_cast<long long>(__ldg(lin + k)) * W4;
      for (long long c = 0; c < W4; ++c) d[c] = __ldg(s + c);
    }
  } else {
    for (; k < K; k += stride) {
      const int32_t* s = rows + k * W;
      int32_t* d = dst + static_cast<long long>(__ldg(lin + k)) * W;
      for (long long c = 0; c < W; ++c) d[c] = __ldg(s + c);
    }
  }
}

}  // namespace

// n grids (1..kMaxGrids): dsts[j] and rows[j] device pointers, widths[j]
// their row width (>= 1), all three host arrays read here into the
// kernel's parameters; lin the device pointer of K int32 row indices.
extern "C" int agac_row_splice(int n, const long long* dsts,
                               const long long* rows, const long long* widths,
                               const void* lin, long long K, void* stream) {
  if (n < 1 || n > kMaxGrids || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SpliceTable table{};
  for (int j = 0; j < n; ++j) {
    if (widths[j] < 1) return static_cast<int>(cudaErrorInvalidValue);
    table.grid[j] = {reinterpret_cast<int32_t*>(dsts[j]),
                     reinterpret_cast<const int32_t*>(rows[j]), widths[j]};
  }
  if (K == 0) return 0;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms_of[32] = {};
  if (sms_of[dev] == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms_of[dev], cudaDevAttrMultiProcessorCount, dev));
    if (err) return err;
  }
  // CTAs along x for each grid, so that the n grids together fill the
  // card's resident CTAs once, and never more than one lane a row
  long long ctas =
      (static_cast<long long>(sms_of[dev]) * kCtasPerSm + n - 1) / n;
  const long long needed = (K + kThreads - 1) / kThreads;
  if (needed < ctas) ctas = needed;
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(n));
  row_splice_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int32_t*>(lin), K);
  return static_cast<int>(cudaGetLastError());
}
