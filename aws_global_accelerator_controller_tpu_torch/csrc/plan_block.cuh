// Masked softmax -> x255 -> round-half-to-even -> int32 for one group row.
//
// The device counterpart of plan_block in the JAX package's
// ops/pallas_weights.py (:29-44), shared by the quantizer kernel
// (plan_weights.cu) and the fused MLP kernel (mlp.cu) the way
// pallas_mlp.py shares plan_block with pallas_weights.py.
//
// Semantics kept exactly:
// - masked entries read as -FLT_MAX for the max;
// - the all-masked guard is `m > -FLT_MAX / 2` (not isfinite), so an
//   all-masked row computes with m = 0 and yields zeros, never NaN;
// - the denominator is clamped at 1e-30 and a zero denominator gives 0;
// - accurate expf and an IEEE division (the build passes no fast-math
//   flag), and rintf rounds half to even like jnp.round / torch.round.
#pragma once

#include <cfloat>
#include <cstdint>

namespace agac {

constexpr float kMaxWeight = 255.0f;

// Lanes per row: the smallest power of two >= min(E, 32).
__host__ __device__ inline int row_width(int E) {
  int w = 1;
  while (w < E && w < 32) w <<= 1;
  return w;
}

// One row of E scores planned by `width` lanes of a warp (a power of two
// <= 32; lane is this thread's index within its row group).  Every lane
// of the warp must call this the same number of times, since the
// reductions shuffle across the full warp mask; a lane with no row to
// plan passes valid = false and takes part in the shuffles only.
__device__ __forceinline__ void plan_row(const float* s, const uint8_t* m,
                                         int32_t* out, int E, int lane,
                                         int width, bool valid) {
  const float neg = -FLT_MAX;
  float mx = neg;
  if (valid) {
    for (int j = lane; j < E; j += width) {
      if (m[j]) mx = fmaxf(mx, s[j]);
    }
  }
  for (int off = width >> 1; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, width));
  }
  if (!(mx > neg * 0.5f)) mx = 0.0f;

  float sum = 0.0f;
  if (valid) {
    for (int j = lane; j < E; j += width) {
      if (m[j]) sum += expf(s[j] - mx);
    }
  }
  for (int off = width >> 1; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off, width);
  }

  if (valid) {
    for (int j = lane; j < E; j += width) {
      int32_t w = 0;
      if (m[j] && sum > 0.0f) {
        const float p = expf(s[j] - mx) / fmaxf(sum, 1e-30f);
        w = static_cast<int32_t>(rintf(p * kMaxWeight));
      }
      out[j] = w;
    }
  }
}

}  // namespace agac
