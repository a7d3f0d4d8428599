// SH colours, backward: the gradients of shs_dc [N, 1, 3] and shs_rest
// [N, K - 1, 3] from the gradient of sh_fwd.cu's rgb. RGB is linear in the
// coefficients, so coefficient k of channel c gets g_c f_k(dir) where the
// forward's clamp passed channel c (its mask bit: SH + 0.5 >= 0, torch.clamp's
// rule), and 0 elsewhere; the bands above the degree get 0. The means get
// no gradient: the view direction is detached, as in TileRenderer.get_rgbs.
//
// Replaces gsl_tpu/ops/sh.py::sh_to_rgb's gradient (JAX's autodiff of plain
// JAX: the TPU had no Pallas kernel for it). In plain PyTorch, autograd
// built it from the forward's graph: each band's read of the [N, 16, 3]
// concatenation gave a full-size zero tensor with one band filled, 16 of
// them summed by 15 full-size adds, then the sum split back into the two
// tensors: some 55 GB of traffic a step at 6.1M rows. Here the forward
// saves one byte a row (the mask) and the direction is recomputed from
// the means.
//
// A block owns kShThreads consecutive rows: each thread writes its row's
// 3 K gradients into shared memory, then the block writes its two
// contiguous output spans with 16-byte stores (sh_terms.cuh). The
// incoming gradient may be a view into a wider gradient (the channel
// columns of the rasterizer's rows): its rows are read at their stride.
// Row offsets are 64-bit. Each gradient is one product, the factor
// rounded as the forward (and sh_colors_bwd_plain) rounds it (built
// without multiply-add contraction), so the plain version's values are
// this kernel's bit for bit.
//
// Bound on the H100: bytes. A row reads 12 (gradient; a strided row
// touches a sector or two more) + 12 (means) + 1 (mask) bytes and writes
// 12 K: 217 bytes at K = 16, 1.32 GB for 6.1M rows, 0.39 ms at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

#include "sh_terms.cuh"

namespace {

using gsl::kShThreads;

// shared floats: the block's rows of the shs_rest gradient, means and the
// shs_dc gradient
size_t smem_bytes(int n_rest) {
  return sizeof(float) * kShThreads * (3 * static_cast<size_t>(n_rest) + 6);
}

template <int D>
__global__ void __launch_bounds__(kShThreads) sh_bwd_kernel(
    const float* __restrict__ grad,    // [N, 3], rows grad_stride apart
    int64_t grad_stride,
    const float* __restrict__ means,   // [N, 3]
    const float* __restrict__ centre,  // [3]
    const uint8_t* __restrict__ mask,  // [N]
    int n_rest, int64_t n,
    float* __restrict__ g_dc,          // [N, 1, 3]
    float* __restrict__ g_rest) {      // [N, n_rest, 3]
  extern __shared__ __align__(16) float smem[];
  const int row_floats = 3 * n_rest;
  float* s_rest = smem;
  float* s_means = s_rest + kShThreads * row_floats;
  float* s_dc = s_means + 3 * kShThreads;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kShThreads;
  const int rows = static_cast<int>(
      n - r0 < kShThreads ? n - r0 : static_cast<int64_t>(kShThreads));
  const int t = threadIdx.x;
  gsl::load_span(means + 3 * r0, 3 * rows, s_means);
  __syncthreads();
  if (t < rows) {
    const int64_t r = r0 + t;
    float x, y, z;
    gsl::sh_view_dir(s_means + 3 * t, centre, x, y, z);
    float f[gsl::sh_bases(D)];
    gsl::sh_factors<D>(x, y, z, f);
    const unsigned bits = mask[r];
    float* out = s_rest + row_floats * t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // torch.clamp's gradient: the incoming one where the clamp passed
      const float g = (bits >> c) & 1u ? grad[r * grad_stride + c] : 0.0f;
      s_dc[3 * t + c] = g * f[0];
#pragma unroll
      for (int k = 1; k < gsl::sh_bases(D); ++k) out[3 * (k - 1) + c] = g * f[k];
    }
    for (int i = 3 * (gsl::sh_bases(D) - 1); i < row_floats; ++i) out[i] = 0.0f;
  }
  __syncthreads();
  gsl::store_span(s_dc, 3 * rows, g_dc + 3 * r0);
  gsl::store_span(s_rest, row_floats * rows, g_rest + row_floats * r0);
}

template <int D>
cudaError_t launch(const float* grad, int64_t grad_stride, const float* means,
                   const float* centre, const uint8_t* mask, int n_rest,
                   int64_t n, float* g_dc, float* g_rest, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = gsl::allow_smem(sh_bwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>((n + kShThreads - 1) / kShThreads);
  sh_bwd_kernel<D><<<grid, kShThreads, smem, s>>>(
      grad, grad_stride, means, centre, mask, n_rest, n, g_dc, g_rest);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_sh_bwd(const float* grad, int64_t grad_stride, const float* means,
               const float* centre, const uint8_t* mask, int n_rest,
               int degree, int64_t n, float* g_dc, float* g_rest,
               void* stream) {
  const size_t smem = smem_bytes(n_rest);
  if (!gsl::sh_shapes_taken(degree, n_rest, smem) || n < 0 ||
      grad_stride < 3 || (n + kShThreads - 1) / kShThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsl::for_degree(degree, [&](auto d) {
    return launch<decltype(d)::value>(grad, grad_stride, means, centre, mask,
                                      n_rest, n, g_dc, g_rest, smem, s);
  }));
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM at this degree and K.
int gsl_sh_bwd_attributes(int degree, int n_rest, int* out) {
  const size_t smem = smem_bytes(n_rest);
  if (!gsl::sh_shapes_taken(degree, n_rest, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gsl::for_degree(degree, [&](auto d) {
    auto kernel = sh_bwd_kernel<decltype(d)::value>;
    cudaError_t err = gsl::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return gsl::kernel_attributes(kernel, kShThreads, smem, out);
  }));
}

}  // extern "C"
