// The arithmetic and the staging that the SH colour kernels share
// (sh_fwd.cu, sh_bwd.cu): the view direction, the factor of each SH
// coefficient in ops/sh.py::sh_to_rgb's sum, and the copies of a block's
// contiguous row span between device and shared memory.
//
// Both sources are built with -fmad=false: their plain versions
// (ops/sh.py::sh_colors_fwd_plain and sh_colors_bwd_plain) round every
// multiply and add on its own, as PyTorch's elementwise ops do, and the
// kernels compute each value with the same operations in the same order.
// Constants are written as (float)<double> because PyTorch casts a Python
// float scalar to float32 that way.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_batches.cuh"

namespace gsl {

constexpr int kShMaxDegree = 3;
constexpr int kShThreads = 128;  // threads of a block, one row each

__host__ __device__ constexpr int sh_bases(int degree) {
  return (degree + 1) * (degree + 1);
}

// The unit view direction of a row: d = mean - centre over
// max(|d|, 1e-12), as sh_to_rgb normalises it. torch.linalg.norm sums the
// squares as a chain of fused multiply-adds, x * x first.
__device__ __forceinline__ void sh_view_dir(const float* mean,
                                            const float* centre, float& x,
                                            float& y, float& z) {
  const float dx = mean[0] - centre[0];
  const float dy = mean[1] - centre[1];
  const float dz = mean[2] - centre[2];
  float norm = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
  norm = norm < 1e-12f ? 1e-12f : norm;  // torch.clamp: NaN stays
  x = dx / norm;
  y = dy / norm;
  z = dz / norm;
}

// f[k]: the factor of coefficient k in sh_to_rgb's sum for bands up to D,
// each written as sh_to_rgb writes it; the sum subtracts the terms of
// coefficients 1 and 3, so their sign is folded in (-(a) * s is -(a * s)
// exactly).
template <int D>
__device__ __forceinline__ void sh_factors(float x, float y, float z,
                                           float (&f)[sh_bases(D)]) {
  f[0] = static_cast<float>(0.28209479177387814);
  if constexpr (D >= 1) {
    const float c1 = static_cast<float>(0.4886025119029199);
    f[1] = -(c1 * y);
    f[2] = c1 * z;
    f[3] = -(c1 * x);
  }
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    f[4] = static_cast<float>(1.0925484305920792) * (x * y);
    f[5] = static_cast<float>(-1.0925484305920792) * (y * z);
    f[6] = static_cast<float>(0.31539156525252005) * (2.0f * zz - xx - yy);
    f[7] = static_cast<float>(-1.0925484305920792) * (x * z);
    f[8] = static_cast<float>(0.5462742152960396) * (xx - yy);
    if constexpr (D >= 3) {
      f[9] = static_cast<float>(-0.5900435899266435) * y * (3.0f * xx - yy);
      f[10] = static_cast<float>(2.890611442640554) * (x * y) * z;
      f[11] = static_cast<float>(-0.4570457994644658) * y *
              (4.0f * zz - xx - yy);
      f[12] = static_cast<float>(0.3731763325901154) * z *
              (2.0f * zz - 3.0f * xx - 3.0f * yy);
      f[13] = static_cast<float>(-0.4570457994644658) * x *
              (4.0f * zz - xx - yy);
      f[14] = static_cast<float>(1.445305721320277) * z * (xx - yy);
      f[15] = static_cast<float>(-0.5900435899266435) * x * (xx - 3.0f * yy);
    }
  }
}

// The coefficient sh_to_rgb adds i-th: band 1 as z, y, x.
__host__ __device__ constexpr int sh_order(int i) {
  return i == 1 ? 2 : (i == 2 ? 1 : i);
}

// count floats from src (device memory) to dst (shared memory), by the
// block's threads: 16 bytes a thread where src is 16-byte aligned (a row
// span that starts at a multiple of 4 rows of a 16-byte aligned tensor
// is), one float otherwise and for the tail.
__device__ __forceinline__ void load_span(const float* __restrict__ src,
                                          int count, float* dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = count / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kShThreads) d4[i] = s4[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < count; i += kShThreads) {
    dst[i] = src[i];
  }
}

// count floats from src (shared memory) to dst (device memory), as
// load_span reads them.
__device__ __forceinline__ void store_span(const float* src, int count,
                                           float* __restrict__ dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = count / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kShThreads) d4[i] = s4[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < count; i += kShThreads) {
    dst[i] = src[i];
  }
}

// Calls f(std::integral_constant<int, D>()) for degree D in 0..3.
template <class F>
cudaError_t for_degree(int degree, F f) {
  switch (degree) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
  }
  return cudaErrorInvalidValue;
}

// Whether the kernels take these shapes: degree 0..3 with its bases in
// 1 + n_rest coefficients, and a block's staged rows within the card's
// 227 KB of shared memory.
inline bool sh_shapes_taken(int degree, int n_rest, size_t smem) {
  return degree >= 0 && degree <= kShMaxDegree && n_rest >= 0 &&
         sh_bases(degree) <= 1 + n_rest && smem <= 227 * 1024;
}

// Lets `kernel` take `smem` dynamic shared bytes (above the default 48 KB
// only after this).
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace gsl
