// A block's run of consecutive Gaussians and the contiguous range of their
// slots.
//
// Gaussian g owns the slots offsets[g] .. offsets[g + 1] (its tile
// rectangle's, or one dummy slot), laid out in Gaussian order, so a block
// that owns the Gaussians g0 .. g0 + count owns one slot range s0 .. s1 and
// can walk it slot by slot with all its threads, as the TPU kernel walked
// its windows of slots. K1 (expand.cu), K4 (reduce_grads.cu) and K5
// (surfel_expand.cu, over surfels) do; one thread per Gaussian looping over
// that Gaussian's slots keeps its warp as long as the warp's longest
// Gaussian (~7 iterations for ~2.6 useful ones at the bench scene). The
// block stages the run's slot offsets in shared memory, relative to s0, and
// finds the Gaussian of a slot by binary search there.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace gsl {

struct SlotRun {
  int g0;      // first Gaussian
  int count;   // Gaussians in the run
  int64_t s0;  // first slot
  int slots;   // slots of the run, s1 - s0
};

// Block b's run of up to `per_block` Gaussians from b * per_block. Stages
// s_off[i] = offsets[g0 + i] - s0 for i < count and s_off[count] = slots,
// then passes a barrier. `end` is the slot past the last Gaussian's (the
// total, dummies included), read only by the block that owns Gaussian
// n - 1. The run's slots must fit an int: at most per_block times the
// tiles of the image.
__device__ __forceinline__ SlotRun stage_run(const int64_t* offsets, int n,
                                             int per_block, int64_t end,
                                             int* s_off) {
  SlotRun r;
  r.g0 = static_cast<int>(blockIdx.x) * per_block;
  r.count = min(per_block, n - r.g0);
  // every load is issued before the first is used: one round trip
  r.s0 = offsets[r.g0];
  const int64_t s1 = r.g0 + r.count < n ? offsets[r.g0 + r.count] : end;
  for (int i = threadIdx.x; i <= r.count; i += blockDim.x) {
    const int64_t o = i < r.count ? offsets[r.g0 + i] : s1;
    s_off[i] = static_cast<int>(o - r.s0);
  }
  r.slots = static_cast<int>(s1 - r.s0);
  __syncthreads();
  return r;
}

// The run's Gaussian (0 .. count - 1) that owns local slot s
// (0 <= s < s_off[count]): the last i with s_off[i] <= s.
__device__ __forceinline__ int slot_owner(const int* s_off, int count,
                                          int s) {
  int lo = 0;
  int hi = count;  // s_off[lo] <= s < s_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace gsl
