// StopThePop: the terms of a (pixel, slot) pair and a pixel's own order of
// one window of its tile's list. Shared by the forward (K2s,
// rasterize_fwd_stp.cu) and the backward (K3s, rasterize_bwd_stp.cu), so
// both order every window identically and the backward recomputes exactly
// the forward's alpha and transmittance.
//
// A window is kWindow consecutive sorted positions, aligned in the whole
// sorted stream (position / 16), not in the tile's range. Inside a window a
// pixel composites by ascending d_p = depth - kz_x dx - kz_y dy (dx = mean_x
// - px), ties by position; an entry with a == 0 (outside the tile's range,
// sigma < 0 or alpha < 1/255) takes part in the order and adds nothing.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace stp {

constexpr int kWindow = 16;
// per slot in shared memory: mean x, y, conic a, b, c, opacity, centre
// depth, depth slope x, y
constexpr int kFields = 9;
enum Field { kMx, kMy, kCa, kCb, kCc, kOp, kDepth, kKzx, kKzy };
constexpr uint64_t kIdentity = 0xFEDCBA9876543210ull;

struct Pair {
  float a;    // alpha as composited: 0 when the pair is skipped
  float d;    // the slot's depth at this pixel
  float dx, dy;
  float e;    // exp(-sigma)
  float raw;  // opacity * e, before the 0.999 clamp
};

// `s` holds kFields arrays of `stride` slots; `j` is the slot. A slot outside
// the tile's range is stored as zeros: opacity 0 gives a == 0.
__device__ __forceinline__ Pair pair_terms(const float* s, int stride, int j,
                                           float px, float py) {
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  Pair p;
  const float ca = s[kCa * stride + j];
  const float cb = s[kCb * stride + j];
  const float cc = s[kCc * stride + j];
  p.dx = s[kMx * stride + j] - px;
  p.dy = s[kMy * stride + j] - py;
  const float sigma =
      0.5f * (ca * p.dx * p.dx + cc * p.dy * p.dy) + cb * p.dx * p.dy;
  p.e = expf(-sigma);
  p.raw = s[kOp * stride + j] * p.e;
  const float alpha = fminf(max_alpha, p.raw);
  p.a = (sigma < 0.0f || alpha < threshold) ? 0.0f : alpha;
  p.d = s[kDepth * stride + j] - s[kKzx * stride + j] * p.dx -
        s[kKzy * stride + j] * p.dy;
  return p;
}

// One field of Gaussian `g`, as pair_terms reads it.
__device__ __forceinline__ float load_field(
    int field, int g, const float* __restrict__ means2d,
    const float* __restrict__ conics, const float* __restrict__ opacities,
    const float* __restrict__ depths, const float* __restrict__ depth_grads) {
  switch (field) {
    case kMx: return means2d[2 * g + 0];
    case kMy: return means2d[2 * g + 1];
    case kCa: return conics[3 * g + 0];
    case kCb: return conics[3 * g + 1];
    case kCc: return conics[3 * g + 2];
    case kOp: return opacities[g];
    case kDepth: return depths[g];
    case kKzx: return depth_grads[2 * g + 0];
    default: return depth_grads[2 * g + 1];
  }
}

// True when the window's entries with a > 0 already stand in this pixel's
// order: their d never falls from one to the next (equal d keeps position
// order). The entries with a == 0 add nothing wherever they stand, so the
// window can then be composited in position order. Exact, and the common
// case: few entries of a window reach 1/255 at a given pixel.
__device__ __forceinline__ bool in_order(const float (&a)[kWindow],
                                         const float (&d)[kWindow]) {
  bool ordered = true;
  float last = -INFINITY;
#pragma unroll
  for (int l = 0; l < kWindow; ++l) {
    const bool live = a[l] > 0.0f;
    ordered = ordered && !(live && d[l] < last);
    last = live ? d[l] : last;
  }
  return ordered;
}

// For every entry l of the window, how many entries precede it in this
// pixel's order (ascending d, ties by position): 4 bits per entry, entry l at
// bits [4l, 4l + 4). A rank count: each of the 120 pairs is compared once,
// with static register indices only.
__device__ __forceinline__ uint64_t count_ranks(const float (&d)[kWindow]) {
  int rank[kWindow];
#pragma unroll
  for (int l = 0; l < kWindow; ++l) rank[l] = 0;
#pragma unroll
  for (int i = 1; i < kWindow; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const bool j_first = d[j] <= d[i];  // the earlier position wins a tie
      rank[i] += j_first ? 1 : 0;
      rank[j] += j_first ? 0 : 1;
    }
  }
  uint64_t packed = 0;
#pragma unroll
  for (int l = 0; l < kWindow; ++l) {
    packed |= static_cast<uint64_t>(rank[l]) << (4 * l);
  }
  return packed;
}

__device__ __forceinline__ uint64_t window_ranks(const float (&a)[kWindow],
                                                 const float (&d)[kWindow]) {
  return in_order(a, d) ? kIdentity : count_ranks(d);
}

__device__ __forceinline__ int rank_of(uint64_t ranks, int l) {
  return static_cast<int>((ranks >> (4 * l)) & 15u);
}

// The transmittance in front of every entry in the pixel's order, by the
// forward's own rule T_exc = T; T *= 1 - a. `column` is this thread's
// kWindow floats of scratch, `stride` apart; on return column[rank_of(l) *
// stride] holds T_exc of entry l. Returns T behind the window.
__device__ __forceinline__ float window_transmittance(
    const float (&a)[kWindow], uint64_t ranks, float T, float* column,
    int stride) {
#pragma unroll
  for (int l = 0; l < kWindow; ++l) column[rank_of(ranks, l) * stride] = a[l];
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    const float ar = column[r * stride];
    column[r * stride] = T;
    T *= 1.0f - ar;
  }
  return T;
}

}  // namespace stp
