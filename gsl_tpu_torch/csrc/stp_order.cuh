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

struct Pair {
  float a;    // alpha as composited: 0 when the pair is skipped
  float d;    // the slot's depth at this pixel
  float dx, dy;
  float e;    // exp(-sigma)
  float raw;  // opacity * e, before the 0.999 clamp
};

// `s` holds kFields arrays of `stride` slots; `j` is the slot. A slot outside
// the tile's range is stored as zeros: opacity 0 gives a == 0.
//
// sigma of the pair at offsets dx = mean_x - px, dy = mean_y - py.
__device__ __forceinline__ float sigma_of(const float* s, int stride, int j,
                                          float dx, float dy) {
  const float ca = s[kCa * stride + j];
  const float cb = s[kCb * stride + j];
  const float cc = s[kCc * stride + j];
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

// The pair's terms from its offsets and its sigma as sigma_of gives it: a
// caller that tests sigma first (K2s's cut) passes the value it tested.
__device__ __forceinline__ Pair pair_terms_at(const float* s, int stride,
                                              int j, float dx, float dy,
                                              float sigma) {
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  Pair p;
  p.dx = dx;
  p.dy = dy;
  p.e = expf(-sigma);
  p.raw = s[kOp * stride + j] * p.e;
  const float alpha = fminf(max_alpha, p.raw);
  p.a = (sigma < 0.0f || alpha < threshold) ? 0.0f : alpha;
  p.d = s[kDepth * stride + j] - s[kKzx * stride + j] * p.dx -
        s[kKzy * stride + j] * p.dy;
  return p;
}

__device__ __forceinline__ Pair pair_terms(const float* s, int stride, int j,
                                           float px, float py) {
  const float dx = s[kMx * stride + j] - px;
  const float dy = s[kMy * stride + j] - py;
  return pair_terms_at(s, stride, j, dx, dy, sigma_of(s, stride, j, dx, dy));
}

// One live entry (a > 0) more of a window, in position order: whether the
// live entries so far still stand in this pixel's order, i.e. no d_p falls
// below the last live entry's (equal d_p keeps position order). `last` is
// the last live entry's d_p, -inf before the first. The entries with
// a == 0 add nothing wherever they stand, so a window that stays in order
// can be composited in position order. Exact, and the common case: few
// entries of a window reach 1/255 at a given pixel.
__device__ __forceinline__ bool still_in_order(bool ordered, float d,
                                               float& last) {
  ordered = ordered && !(d < last);
  last = d;
  return ordered;
}

// The live entries of a window (bit l of `live`) in this pixel's order:
// ascending d_p, ties by position; `d(l)` is entry l's d_p. Returns their
// positions, the one of rank r in bits [4r, 4r + 4), and their count in
// n_live. Each pair of live entries is compared once from either side, so
// a window costs n_live^2 compares; the entries with a == 0 multiply T by
// exactly 1 wherever they stand, so T in front of each live entry is that
// of an order over all 16, to the bit.
template <class D>
__device__ __forceinline__ uint64_t live_order(unsigned live, D d,
                                               int& n_live) {
  uint64_t order = 0;
  n_live = 0;
  for (unsigned m = live; m != 0u; m &= m - 1u) {
    const int i = __ffs(m) - 1;
    const float di = d(i);
    int r = 0;
    for (unsigned m2 = live & ~(1u << i); m2 != 0u; m2 &= m2 - 1u) {
      const int j = __ffs(m2) - 1;
      const float dj = d(j);
      r += j < i ? (dj <= di ? 1 : 0) : (di <= dj ? 0 : 1);
    }
    order |= static_cast<uint64_t>(i) << (4 * r);
    ++n_live;
  }
  return order;
}

}  // namespace stp
