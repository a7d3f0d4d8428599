// SH colours, forward: for every row, rgb = max(SH(dir) + 0.5, 0) with
// dir the unit vector from the camera centre to the row's mean, and the
// clamp's mask (bit c set where channel c's gradient passes: SH + 0.5 >= 0).
//
// Replaces gsl_tpu/ops/sh.py::sh_to_rgb and the clamp around it in
// TileRenderer.get_rgbs (plain JAX: the TPU had no Pallas kernel for it,
// and XLA fused the terms). In plain PyTorch the same function read the
// coefficients through a [N, 16, 3] concatenation of shs_dc and shs_rest
// and launched ~90 kernels, each a full pass over N rows; autograd then
// built a full-size zero gradient per band and summed them. This kernel
// reads shs_dc [N, 1, 3] and shs_rest [N, K - 1, 3] where they lie.
//
// A block owns kShThreads consecutive rows, and so one contiguous span of
// each input (12 bytes a row of means and shs_dc, 12 (K - 1) of shs_rest:
// 180 at K = 16): it stages the spans in shared memory with 16-byte loads
// (sh_terms.cuh), each thread evaluates its row from there, and the block
// writes its rgb span with 16-byte stores. A thread reading its row of
// 45 coefficients straight from device memory would touch 45 sectors a
// warp per load. Row offsets are 64-bit. The terms are summed in
// sh_to_rgb's order and rounded as PyTorch rounds them (built without
// multiply-add contraction), so the plain version's colours are this
// kernel's bit for bit.
//
// Bound on the H100: bytes. A row reads 12 (means) + 12 (shs_dc) +
// 12 (K - 1) (shs_rest; none at degree 0) bytes and writes 12 (rgb) + 1
// (mask): 217 bytes at K = 16, 1.32 GB for 6.1M rows, 0.39 ms at
// 3.35 TB/s. The ~100 flops a row are far below the card's 67 TFLOP/s.
#include <cstdint>
#include <cuda_runtime.h>

#include "sh_terms.cuh"

namespace {

using gsl::kShThreads;

// shared floats: the block's rows of shs_rest, means, shs_dc and rgb
size_t smem_bytes(int n_rest) {
  return sizeof(float) * kShThreads * (3 * static_cast<size_t>(n_rest) + 9);
}

template <int D>
__global__ void __launch_bounds__(kShThreads) sh_fwd_kernel(
    const float* __restrict__ means,   // [N, 3]
    const float* __restrict__ centre,  // [3]
    const float* __restrict__ dc,      // [N, 1, 3]
    const float* __restrict__ rest,    // [N, n_rest, 3]
    int n_rest, int64_t n,
    float* __restrict__ rgb,           // [N, 3]
    uint8_t* __restrict__ mask) {      // [N]
  extern __shared__ __align__(16) float smem[];
  const int row_floats = 3 * n_rest;
  float* s_rest = smem;
  float* s_means = s_rest + kShThreads * row_floats;
  float* s_dc = s_means + 3 * kShThreads;
  float* s_rgb = s_dc + 3 * kShThreads;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kShThreads;
  const int rows = static_cast<int>(
      n - r0 < kShThreads ? n - r0 : static_cast<int64_t>(kShThreads));
  const int t = threadIdx.x;
  gsl::load_span(means + 3 * r0, 3 * rows, s_means);
  gsl::load_span(dc + 3 * r0, 3 * rows, s_dc);
  if (D > 0) gsl::load_span(rest + row_floats * r0, row_floats * rows, s_rest);
  __syncthreads();
  if (t < rows) {
    float x, y, z;
    gsl::sh_view_dir(s_means + 3 * t, centre, x, y, z);
    float f[gsl::sh_bases(D)];
    gsl::sh_factors<D>(x, y, z, f);
    const float* coef = s_rest + row_floats * t;
    unsigned bits = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = f[0] * s_dc[3 * t + c];
#pragma unroll
      for (int i = 1; i < gsl::sh_bases(D); ++i) {
        const int k = gsl::sh_order(i);
        acc = acc + f[k] * coef[3 * (k - 1) + c];
      }
      const float v = acc + 0.5f;
      bits |= (v >= 0.0f ? 1u : 0u) << c;
      s_rgb[3 * t + c] = v < 0.0f ? 0.0f : v;  // torch.clamp: NaN stays
    }
    mask[r0 + t] = static_cast<uint8_t>(bits);
  }
  __syncthreads();
  gsl::store_span(s_rgb, 3 * rows, rgb + 3 * r0);
}

template <int D>
cudaError_t launch(const float* means, const float* centre, const float* dc,
                   const float* rest, int n_rest, int64_t n, float* rgb,
                   uint8_t* mask, size_t smem, cudaStream_t s) {
  cudaError_t err = gsl::allow_smem(sh_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>((n + kShThreads - 1) / kShThreads);
  sh_fwd_kernel<D><<<grid, kShThreads, smem, s>>>(
      means, centre, dc, rest, n_rest, n, rgb, mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_sh_fwd(const float* means, const float* centre, const float* dc,
               const float* rest, int n_rest, int degree, int64_t n,
               float* rgb, uint8_t* mask, void* stream) {
  const size_t smem = smem_bytes(n_rest);
  if (!gsl::sh_shapes_taken(degree, n_rest, smem) || n < 0 ||
      (n + kShThreads - 1) / kShThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsl::for_degree(degree, [&](auto d) {
    return launch<decltype(d)::value>(means, centre, dc, rest, n_rest, n, rgb,
                                      mask, smem, s);
  }));
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM at this degree and K.
int gsl_sh_fwd_attributes(int degree, int n_rest, int* out) {
  const size_t smem = smem_bytes(n_rest);
  if (!gsl::sh_shapes_taken(degree, n_rest, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gsl::for_degree(degree, [&](auto d) {
    auto kernel = sh_fwd_kernel<decltype(d)::value>;
    cudaError_t err = gsl::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return gsl::kernel_attributes(kernel, kShThreads, smem, out);
  }));
}

}  // extern "C"
