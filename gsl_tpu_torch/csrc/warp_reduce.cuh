// Deterministic sums of many values over the 32 lanes of a warp, shared by
// the backward kernels (K3s rasterize_bwd_stp.cu, K7 surfel_bwd.cu).
//
// A backward kernel ends each (slot, warp) with R per-pixel values in every
// lane (the gradient row of one slot at 32 pixels) and needs their sums over
// the lanes. R separate butterflies cost 5 shuffles each, 5R in all, and
// leave every sum in every lane. The transposed sum (recursive halving)
// costs about R: at the step across lane bit O (16, 8, ...) a lane keeps
// one part of its remaining L values, ceil(L / 2) of them, sends the other
// part to its partner lane (lane ^ O) and adds what it receives, so the
// values a lane holds halve while the lanes holding one value's partial
// double. Once one value is left, the remaining steps are butterflies. R = 9
// takes 5 + 3 + 2 + 1 + 1 = 12 shuffles, R = 19 takes 10 + 5 + 3 + 2 + 1 =
// 21, where five-step sums take 45 and 95. Value transpose_index<R>(lane)
// of the warp's sum ends in each lane, and the R lanes for which
// transpose_writer<R>(lane) holds have one value each, so they can store the
// warp's row at once. The order of the additions is fixed: the same sums in
// every run.
#pragma once
#include <cuda_runtime.h>

namespace gsl {

constexpr unsigned kFullMask = 0xffffffffu;

// Halving steps before one value is left: ceil(log2(L)).
__host__ __device__ constexpr int transpose_steps(int L) {
  return L <= 1 ? 0 : 1 + transpose_steps((L + 1) / 2);
}

// The value whose warp sum lane `lane` holds after warp_transpose_sum<L>,
// or -1 where it holds padding: at the step across bit O the lower lanes
// keep the values [0, H) and the upper lanes [H, L), H = ceil(L / 2), in
// slots 0, 1, ..., so an odd L leaves the upper lanes one slot of padding.
template <int L, int O = 16>
__host__ __device__ constexpr int transpose_index(int lane) {
  if constexpr (L <= 1 || O == 0) {
    return 0;
  } else {
    constexpr int H = (L + 1) / 2;
    const int slot = transpose_index<H, O / 2>(lane);
    if ((lane & O) == 0) return slot;
    return slot >= 0 && slot < L - H ? H + slot : -1;
  }
}

// True for one lane per value: the lanes whose bits below the halving
// steps are 0 and that hold a value, not padding.
template <int L>
__host__ __device__ constexpr bool transpose_writer(int lane) {
  return (lane & ((1 << (5 - transpose_steps(L))) - 1)) == 0 &&
         transpose_index<L>(lane) >= 0;
}

template <int L, int O, int N>
__device__ __forceinline__ float transpose_step(float (&v)[N], int lane) {
  if constexpr (L == 1) {
    float s = v[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
    return s;
  } else {
    constexpr int H = (L + 1) / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      // the upper lanes' padding slot, where L is odd, is 0
      const float hi = H + i < L ? v[H + i < L ? H + i : 0] : 0.0f;
      const float send = upper ? v[i] : hi;
      const float keep = upper ? hi : v[i];
      v[i] = keep + __shfl_xor_sync(kFullMask, send, O);
    }
    return transpose_step<H, O / 2>(v, lane);
  }
}

// v: this lane's L values, 1 <= L <= 32. Returns the sum over the warp's
// lanes of value transpose_index<L>(lane) and leaves v clobbered. Every
// lane of the warp must call it.
template <int L>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[L], int lane) {
  static_assert(L >= 1 && L <= 32, "from 1 to 32 values");
  return transpose_step<L, 16>(v, lane);
}

}  // namespace gsl
