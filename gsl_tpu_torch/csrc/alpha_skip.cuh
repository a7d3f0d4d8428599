// The sigma beyond which a (pixel, splat) pair is skipped for certain, for
// the forward kernels K2 and K2s: a pair is skipped when alpha =
// min(0.999, op * exp(-sigma)) < 1/255, and op * exp(-sigma) < 1/255 holds
// wherever sigma > ln(255 op). The kernels compute this cut once per
// (tile, splat) and test sigma against it before the exponential; only a
// pair with sigma at or below the cut goes on to the exact test, whose
// arithmetic is unchanged (K3 repeats it to know which pairs were
// composited). The margin of 1e-3 lies far above the rounding of logf (1
// ulp), expf (2 ulp) and the product, so no pair the exact test would keep
// is cut. An opacity of 0 gives -inf (every pair cut, as the exact test
// skips them all), and a NaN opacity gives NaN, which cuts nothing.
#pragma once
#include <cmath>
#include <cuda_runtime.h>

#include "tile_batches.cuh"

namespace gsl {

__device__ __forceinline__ float skip_sigma(float opacity) {
  return logf(255.0f * opacity) + 1e-3f;
}

// The cuts of a batch's slots, by the threads that copied their opacities
// (issue_own): record j's value `skip` from its value `op`; a slot off the
// tile's range is cut everywhere.
template <int kBatch>
__device__ __forceinline__ void skip_sigmas(float* buf, int rs, Batch s,
                                            int op, int skip) {
  for (int j = threadIdx.x; j < kBatch; j += blockDim.x) {
    float* rec = buf + j * rs;
    rec[skip] = j >= s.lo && j < s.hi ? skip_sigma(rec[op]) : -INFINITY;
  }
}

}  // namespace gsl
