// Kernel K1: the device probe, o = 2 * x; and an empty kernel that
// measures the card's launch floor.
//
// Replaces the JAX package's capability probe
// compat/capability.py::CapabilityRegistry._tiny_kernel (:215-229),
// which doubles an (8, 128) f32 tile to prove that a kernel compiles and
// answers.  The port runs it once per device on first CUDA use
// (device.py) and refuses the device if the answer is wrong.
//
// Bound on the H100: 8 KiB moved, about 2.5 ns at 3.35 TB/s, far under
// the least device time of any launch (the empty kernel below, timed by
// chip_smoke.py as launch_floor_ms), which is what the probe takes.  A CTA
// of 256 threads a 1024 floats, each thread one float4 (a 16-byte load
// and store) where the quad lies whole inside x and both pointers are
// 16-byte aligned, else its quad's floats one by one: the tail of an n
// that is not a multiple of 4, and every quad of a view off a 16-byte
// boundary.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kCtaFloats = 4 * kThreads;

__global__ void __launch_bounds__(kThreads)
    probe_double_kernel(const float* __restrict__ x, float* __restrict__ o,
                        long long n) {
  const long long at = static_cast<long long>(blockIdx.x) * kCtaFloats +
                       4 * static_cast<long long>(threadIdx.x);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (aligned && at + 4 <= n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + at));
    *reinterpret_cast<float4*>(o + at) =
        make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  } else {
    for (long long i = at; i < at + 4 && i < n; ++i) o[i] = x[i] * 2.0f;
  }
}

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int agac_probe_double(const void* x, void* o, long long n,
                                 void* stream) {
  const long long blocks = (n + kCtaFloats - 1) / kCtaFloats;
  probe_double_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

// One CTA of one warp that does nothing: its device time is the least any
// launch of this card takes.
extern "C" int agac_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* agac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
