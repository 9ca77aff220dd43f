// Kernel K5: the fleet stats all-reduce as one exchange a pass, a store
// from each rank into every peer's inbox and one sum in the reference's
// order, and the host entry points that map the inboxes and share the
// events that order them.
//
// Replaces the JAX package's parallel/fleet_plan.py::_make_stats_ring.
// _hop.kernel (:130, pallas_call at :141): each hop is a remote DMA of one
// (8, 128) f32 tile to the right-hand neighbour on the mesh's "data"
// axis, and n - 1 hops with an add after each make a ring all-reduce of
// the [5] fleet stats (reduce, :149-157).  A TPU's remote DMA reaches only
// a mesh neighbour, hence the ring.  Here every peer's memory is mapped,
// so a pass is one store from each rank into every peer and one sum: the
// block that would have arrived at hop d of the ring lands in slot d of
// the receiver's inbox, d = (receiver - sender) mod n, and the sum adds
// own, slot 1, ..., slot n - 1 (own, then the left neighbour's, then the
// one beyond), the reference's adds bit for bit.  A slot moves the k
// stats themselves (k = 5: 20 bytes, one 32-byte sector), not the tile.
//
// The ranks are processes.  Each allocates an inbox of 2 parities x n
// slots x 8 floats with cudaMalloc (agac_ring_alloc; not PyTorch's
// caching allocator, whose blocks would export the handle of a whole
// cached block), exports its IPC handle (agac_ring_export), and maps
// every peer's (agac_ring_map, cudaIpcMemLazyEnablePeerAccess).  It makes
// two interprocess events a parity, sent[q] and read[q]
// (agac_ring_event_create: cudaEventInterprocess, no timing), exports
// their handles and opens every peer's (agac_ring_event_open).  All of it
// works between processes on one card and between cards of one node, so
// the kernels checked on one card are the ones that run on several.
//
// Pass p on rank i, q = p mod 2, all on the caller's stream
// (ops/cuda_ring.py drives it):
//   1. agac_stats_ring_send: wait on every peer's read[q], launch the
//      send kernel (own k floats into slot (j - i) mod n, parity q, of
//      every peer j's inbox), record sent[q];
//   2. the host barrier over the group, the pass's one;
//   3. agac_stats_ring_sum: wait on every peer's sent[q], launch the sum
//      kernel (acc = own + slot 1 + ... + slot n - 1 of this rank's inbox,
//      parity q, read past L1 with __ldcg), record read[q].
// Two launches a pass whatever n, no stream synchronise, nothing staged
// through the host.
//
// Why a wait never lands on a stale record.  cudaStreamWaitEvent waits on
// the record that is newest when it is called.  At step 3 of pass p the
// barrier has passed, so every peer j has recorded sent[q] of pass p.  j
// records sent[q] next at pass p + 2, after barrier p + 1, and rank i
// reaches barrier p + 1 only after it has enqueued its pass-p waits: the
// wait is on pass p's record.  Likewise at step 1 of pass p + 2, j's
// newest read[q] is that of pass p: it was recorded before j reached
// barrier p + 1, which i has passed, and j records read[q] again only
// after barrier p + 2, which i has not reached.  So no store of pass p + 2
// lands in a slot before the pass-p sum that reads it is done, and the
// two parities keep pass p + 1's stores out of pass p's slots.  An event
// never recorded is complete: the first two passes wait on nothing.
//
// No kernel spins on memory another process writes: ranks that share a
// card without MPS are time-sliced contexts, and a spinning kernel would
// hold the card while its writer waits for a turn.  The waits are the
// streams' own (cudaStreamWaitEvent), which spin no SM.
//
// Bound on the H100: a pass reads each rank's k stats once and writes its
// sum once, 2 n k 4 bytes over the ranks, 160 bytes at n = 4, k = 5:
// 0.05 ns at 3.35 TB/s.  Its time is the launches, the barrier and the
// streams' waits, not bytes; one block of a warp or four, a float a
// thread.
#include <cuda_runtime.h>

#include <cstring>

namespace {

// the most ranks a group may have: the send kernel takes its n - 1 slot
// pointers by value
constexpr int kMaxRanks = 32;

struct Targets {
  float* at[kMaxRanks - 1];
};

// dst.at[d - 1][c] = src[c]: the slot of the rank at distance d
__global__ void stats_ring_send_kernel(const float* __restrict__ src,
                                       Targets dst, int m, int k) {
  for (int t = threadIdx.x; t < m * k; t += blockDim.x)
    dst.at[t / k][t % k] = src[t % k];
}

// acc = own + slot 1 + ... + slot count - 1, in that order
__global__ void stats_ring_sum_kernel(const float* __restrict__ own,
                                      const float* slots, int count,
                                      float* __restrict__ acc, int k,
                                      int stride) {
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float a = own[c];
    // the slots were stored by other processes' kernels: read them from
    // L2, past this SM's L1
    for (int s = 1; s < count; ++s) a += __ldcg(slots + s * stride + c);
    acc[c] = a;
  }
}

cudaError_t wait_all(const void* const* events, int n_events,
                     cudaStream_t stream) {
  for (int e = 0; e < n_events; ++e) {
    const cudaError_t err = cudaStreamWaitEvent(
        stream, static_cast<cudaEvent_t>(const_cast<void*>(events[e])), 0);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int agac_stats_ring_max_ranks() { return kMaxRanks; }

// Wait on ``waits`` (n_waits events), store src[:k] into each of the m
// slots ``dst`` points to, then record ``record`` (unless null).
extern "C" int agac_stats_ring_send(const void* src, const void* const* dst,
                                    int m, int k, const void* const* waits,
                                    int n_waits, void* record, void* stream) {
  if (m < 1 || m > kMaxRanks - 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = wait_all(waits, n_waits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Targets t{};
  for (int d = 0; d < m; ++d)
    t.at[d] = static_cast<float*>(const_cast<void*>(dst[d]));
  const int threads = m * k <= 32 ? 32 : 128;
  stats_ring_send_kernel<<<1, threads, 0, st>>>(static_cast<const float*>(src),
                                                t, m, k);
  err = cudaGetLastError();
  if (err == cudaSuccess && record != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(record), st);
  return static_cast<int>(err);
}

// Wait on ``waits``, acc[:k] = own[:k] + the slots 1 .. count - 1 from
// ``slots`` (``stride`` floats apart), then record ``record`` (unless
// null).
extern "C" int agac_stats_ring_sum(const void* own, const void* slots,
                                   int count, void* acc, int k, int stride,
                                   const void* const* waits, int n_waits,
                                   void* record, void* stream) {
  if (count < 1 || k < 1 || k > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = wait_all(waits, n_waits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_ring_sum_kernel<<<1, 32, 0, st>>>(
      static_cast<const float*>(own), static_cast<const float*>(slots), count,
      static_cast<float*>(acc), k, stride);
  err = cudaGetLastError();
  if (err == cudaSuccess && record != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(record), st);
  return static_cast<int>(err);
}

extern "C" int agac_ring_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int agac_ring_event_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcEventHandle_t));
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

extern "C" int agac_ring_unmap(void* mapped) {
  return static_cast<int>(cudaIpcCloseMemHandle(mapped));
}

extern "C" int agac_ring_free(void* own) {
  return static_cast<int>(cudaFree(own));
}

// an interprocess event on ``device`` (no timing) and its IPC handle
extern "C" int agac_ring_event_create(int device, void** event,
                                      void* handle) {
  cudaError_t err = cudaSetDevice(device);
  cudaEvent_t ev = nullptr;
  if (err == cudaSuccess)
    err = cudaEventCreateWithFlags(
        &ev, cudaEventInterprocess | cudaEventDisableTiming);
  cudaIpcEventHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetEventHandle(&h, ev);
  if (err == cudaSuccess) {
    std::memcpy(handle, &h, sizeof(h));
    *event = ev;
  } else if (ev != nullptr) {
    cudaEventDestroy(ev);
  }
  return static_cast<int>(err);
}

// another process's interprocess event, from its handle
extern "C" int agac_ring_event_open(int device, const void* handle,
                                    void** event) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcEventHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev = nullptr;
  err = cudaIpcOpenEventHandle(&ev, h);
  if (err == cudaSuccess) *event = ev;
  return static_cast<int>(err);
}

extern "C" int agac_ring_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}
