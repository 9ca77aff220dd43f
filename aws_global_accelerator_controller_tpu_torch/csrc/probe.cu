// Kernel K1: the device probe, o = 2 * x.
//
// Replaces the JAX package's capability probe
// compat/capability.py::CapabilityRegistry._tiny_kernel (:215-229),
// which doubles an (8, 128) f32 tile to prove that a kernel compiles and
// answers.  The port runs it once per device on first CUDA use
// (device.py) and refuses the device if the answer is wrong.
//
// Bound on the H100: 8 KiB moved, about 2.5 ns at 3.35 TB/s; in practice
// the launch itself (a few microseconds).  One thread per element.
#include <cuda_runtime.h>

namespace {

__global__ void probe_double_kernel(const float* __restrict__ x,
                                    float* __restrict__ o, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int agac_probe_double(const void* x, void* o, long long n,
                                 void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  probe_double_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* agac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
