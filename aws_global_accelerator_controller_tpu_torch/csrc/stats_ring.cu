// Kernel K5: one hop of the fleet stats ring, a store into the right-hand
// neighbour's memory, and the host entry points that map that memory.
//
// Replaces the JAX package's parallel/fleet_plan.py::_make_stats_ring.
// _hop.kernel (:130, pallas_call at :141): each hop is a remote DMA of one
// (8, 128) f32 tile to the right-hand neighbour on the mesh's "data"
// axis, and n - 1 hops with an add after each make a ring all-reduce of
// the [5] fleet stats (reduce, :149-157).  The TPU moves a whole tile
// because that is its smallest layout; here a hop moves the k stats
// themselves (k = 5: 20 bytes, one 32-byte sector), not the tile.
//
// The ranks are processes.  Each allocates two receive slots of its own
// with cudaMalloc (agac_ring_alloc; not PyTorch's caching allocator, whose
// blocks would export the handle of a whole cached block), exports their
// IPC handle (agac_ring_export), and maps its right neighbour's slots once
// (agac_ring_map, cudaIpcMemLazyEnablePeerAccess).  That works between
// processes on one card and between cards with peer access, so the kernel
// checked on one card is the one that runs on several.
//
// One launch does one step of the ring (ops/cuda_ring.py drives it):
//   hop 0:       peer[slot 0] = own; acc = own
//   hop h >= 1:  peer[slot h % 2] = arrived(h - 1); acc += arrived(h - 1)
//   closing add: acc += arrived(n - 2)            (peer == nullptr)
// so a pass of n ranks is n launches: n - 1 hops and the closing add.
// The adds come in the reference's order: own tile, then the left
// neighbour's, then the one beyond.  Between hops the wrapper synchronises
// its stream (the store is then complete and visible to the peer) and
// meets the other ranks at a host barrier; the hop parity carries over
// from one pass to the next, so the first store of a pass never lands in
// the slot the closing add of the last pass still reads.  No kernel spins
// on a flag another process sets: ranks that share a card without MPS are
// time-sliced contexts, and a spinning kernel would hold the card while
// its writer waits for a turn.
//
// Bound on the H100: a hop reads k floats and the sum, writes k floats to
// the peer and the sum back: 16 k bytes, 80 bytes at k = 5, 0.02 ns at
// 3.35 TB/s.  Its time is the launch, the stream synchronise and the
// host barrier, not bytes; one block of 32 threads, one float each.
#include <cuda_runtime.h>

#include <cstring>

namespace {

__global__ void stats_ring_step_kernel(const float* __restrict__ src,
                                       float* peer, float* __restrict__ acc,
                                       int k, int accumulate) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    // the block that arrived was stored by another process's kernel:
    // read it from L2, past this SM's L1
    const float v = __ldcg(src + i);
    if (peer != nullptr) peer[i] = v;
    acc[i] = accumulate ? acc[i] + v : v;
  }
}

}  // namespace

extern "C" int agac_stats_ring_step(const void* src, void* peer, void* acc,
                                    int k, int accumulate, void* stream) {
  const int threads = 32;
  const int blocks = (k + threads - 1) / threads;
  stats_ring_step_kernel<<<blocks > 0 ? blocks : 1, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(peer),
      static_cast<float*>(acc), k, accumulate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int agac_ring_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// ``bytes`` of zeroed device memory on ``device``, owned by this library
extern "C" int agac_ring_alloc(int device, long long bytes, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err == cudaSuccess)
    err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int agac_ring_export(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

extern "C" int agac_ring_map(int device, const void* handle, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int agac_ring_close(void* mapped, void* own) {
  cudaError_t err = cudaSuccess;
  if (mapped != nullptr) err = cudaIpcCloseMemHandle(mapped);
  if (own != nullptr) {
    const cudaError_t freed = cudaFree(own);
    if (err == cudaSuccess) err = freed;
  }
  return static_cast<int>(err);
}
