// K2s: StopThePop forward. Front-to-back compositing of each tile's sorted
// splats where every pixel re-sorts each window of 16 sorted positions by
// its own depth, and nothing stops.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_fwd_kernel, stp branch (with
// _window_before and _stp_depths; pallas_call in _rasterize_fwd_raw). Same
// outputs: the composited channels without background, the final
// transmittance T, and i_stop, which is 2^30 (never stopped) at every pixel:
// in this mode T is not cut at 1e-4 and every slot of the tile's list is
// composited, alpha = 1 - prod(1 - a). The slots are keyed by the depth
// plane at the tile centre (K1 with stp_resort); a pixel orders each window
// by d_p = depth - kz_x dx - kz_y dy, ties by position (stp_order.cuh), and
// the windows follow each other in key order. A window is position / 16 in
// the whole sorted stream: a tile's first and last window may be shared
// with its neighbours, whose slots count as a = 0 here.
//
// What the TPU needed and this does not: the order closed into 2 x 15
// shifted masked adds of log1p(-a) per window and a window-level triangle
// matmul, exp of the sums, and the centre depth and slopes carried through
// the sort (which capped the channels at 3). Here one block of tile_size^2
// threads owns one tile, one thread one pixel. The block walks the tile's
// range in batches of one slot per thread, aligned to the windows; each
// batch's means, conics, opacities, centre depths, slopes and channel group
// are gathered by id into shared memory. Per window a thread computes the 16
// alphas and depths into registers (static indices only). If the entries
// with a > 0 already stand in the pixel's order (exact test, the common
// case) it composites them in place with w = a T; T *= 1 - a. Otherwise it
// counts every entry's rank (120 compares), lays the alphas out by rank in
// its own column of shared memory, runs the same sequential rule over the
// column and reads each entry's T_exc back by rank.
//
// With `checkpoints` the kernel also leaves T at the start of every window,
// row (position / 16 + tile) of [rows, tile_size^2]: the backward (K3s)
// starts each window from it instead of dividing T_final, which is 0 where
// a dense tile saturates.
//
// Bound on the H100: operations. Every (pixel, slot) pair costs 23: delta 2,
// sigma 9, negate and exp 2, alpha 2, two compares, d_p 4, the order test 2.
// A pair with a > 0 costs 3 + 2C more (weight, 1 - a, T, C multiply-adds).
// A (pixel, window) whose live entries are out of order costs 408 more: 120
// compares with 240 rank updates, and 48 shared-memory accesses. With no
// stop the pairs are 256 x the valid slots. The bytes are K2's plus 12 per
// Gaussian (depth, slopes), and 64 per sorted slot with checkpoints.
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels and the caller launches once per group; every launch
// orders the windows and computes T again.
#include <cstdint>
#include <cuda_runtime.h>

#include "stp_order.cuh"

namespace {

constexpr int kMaxGroup = 8;
constexpr int kNeverStopped = 1 << 30;

template <int CG>
__global__ void rasterize_fwd_stp_kernel(
    const float* __restrict__ means2d,      // [N, 2]
    const float* __restrict__ conics,       // [N, 3]
    const float* __restrict__ opacities,    // [N]
    const float* __restrict__ channels,     // [N, C]
    const float* __restrict__ depths,       // [N]
    const float* __restrict__ depth_grads,  // [N, 2]
    int n_channels, int c0,
    const int* __restrict__ gids,           // sorted by (tile, plane depth)
    const int64_t* __restrict__ bounds,     // [n_tiles + 1]
    int tiles_x, int tile_size, int height, int width,
    float* __restrict__ out,                // [H, W, C]
    float* __restrict__ t_final,            // [H, W]
    int* __restrict__ i_stop,               // [H, W]
    float* __restrict__ checkpoints) {      // [rows, bs] or null
  extern __shared__ float smem[];
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32
  float* s_geom = smem;                        // [kFields, bs]
  float* s_col = s_geom + stp::kFields * bs;   // [CG, bs]
  float* s_rank = s_col + CG * bs;             // [kWindow, bs]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  float T = 1.0f;
  float acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = 0.0f;
  float* column = s_rank + tid;

  for (int64_t base = start - start % stp::kWindow; base < end; base += bs) {
    __syncthreads();  // the previous batch has been composited
    const int64_t idx = base + tid;
    const bool in_range = idx >= start && idx < end;
    const int g = in_range ? gids[idx] : 0;
#pragma unroll
    for (int f = 0; f < stp::kFields; ++f) {
      s_geom[f * bs + tid] =
          in_range ? stp::load_field(f, g, means2d, conics, opacities, depths,
                                     depth_grads)
                   : 0.0f;
    }
    const float* col = channels + static_cast<int64_t>(g) * n_channels + c0;
#pragma unroll
    for (int c = 0; c < CG; ++c) s_col[c * bs + tid] = in_range ? col[c] : 0.0f;
    __syncthreads();

    const int64_t left = end - base;
    const int n_windows = static_cast<int>(
        left < bs ? (left + stp::kWindow - 1) / stp::kWindow
                  : bs / stp::kWindow);
    for (int w = 0; w < n_windows; ++w) {
      if (checkpoints != nullptr) {
        const int64_t row = base / stp::kWindow + w + tile;
        checkpoints[row * bs + tid] = T;
      }
      const int first = w * stp::kWindow;
      float a[stp::kWindow], d[stp::kWindow];
#pragma unroll
      for (int l = 0; l < stp::kWindow; ++l) {
        const stp::Pair p = stp::pair_terms(s_geom, bs, first + l, px, py);
        a[l] = p.a;
        d[l] = p.d;
      }
      if (stp::in_order(a, d)) {
#pragma unroll
        for (int l = 0; l < stp::kWindow; ++l) {
          if (a[l] > 0.0f) {
            const float wgt = a[l] * T;
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              acc[c] += wgt * s_col[c * bs + first + l];
            }
            T *= 1.0f - a[l];
          }
        }
      } else {
        const uint64_t ranks = stp::count_ranks(d);
        const float t_next =
            stp::window_transmittance(a, ranks, T, column, bs);
#pragma unroll
        for (int l = 0; l < stp::kWindow; ++l) {
          if (a[l] > 0.0f) {
            const float wgt = a[l] * column[stp::rank_of(ranks, l) * bs];
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              acc[c] += wgt * s_col[c * bs + first + l];
            }
          }
        }
        T = t_next;
      }
    }
  }
  if (x >= width || y >= height) return;
  const int64_t pix = static_cast<int64_t>(y) * width + x;
#pragma unroll
  for (int c = 0; c < CG; ++c) out[pix * n_channels + c0 + c] = acc[c];
  t_final[pix] = T;
  i_stop[pix] = kNeverStopped;
}

template <int CG>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   const float* depths, const float* depth_grads,
                   int n_channels, int c0, const int* gids,
                   const int64_t* bounds, int n_tiles, int tiles_x,
                   int tile_size, int height, int width, float* out,
                   float* t_final, int* i_stop, float* checkpoints,
                   cudaStream_t stream) {
  const int bs = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(stp::kFields + CG + stp::kWindow) *
                      bs * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_fwd_stp_kernel<CG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_fwd_stp_kernel<CG><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,
      c0, gids, bounds, tiles_x, tile_size, height, width, out, t_final,
      i_stop, checkpoints);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_rasterize_fwd_stp_max_group() { return kMaxGroup; }

// Composites channels [c0, c0 + cg) of `channels`; T and i_stop are written
// by every call and agree between calls. `checkpoints` may be null.
int gsl_rasterize_fwd_stp(const float* means2d, const float* conics,
                          const float* opacities, const float* channels,
                          const float* depths, const float* depth_grads,
                          int n_channels, int c0, int cg, const int* gids,
                          const int64_t* bounds, int n_tiles, int tiles_x,
                          int tile_size, int height, int width, float* out,
                          float* t_final, int* i_stop, float* checkpoints,
                          void* stream) {
  const int bs = tile_size * tile_size;
  if (cg < 1 || cg > kMaxGroup || c0 < 0 || c0 + cg > n_channels ||
      tile_size < 1 || bs > 1024 || bs % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSL_LAUNCH(CG)                                                        \
  case CG:                                                                    \
    return static_cast<int>(launch<CG>(                                       \
        means2d, conics, opacities, channels, depths, depth_grads,            \
        n_channels, c0, gids, bounds, n_tiles, tiles_x, tile_size, height,    \
        width, out, t_final, i_stop, checkpoints, s))
  switch (cg) {
    GSL_LAUNCH(1);
    GSL_LAUNCH(2);
    GSL_LAUNCH(3);
    GSL_LAUNCH(4);
    GSL_LAUNCH(5);
    GSL_LAUNCH(6);
    GSL_LAUNCH(7);
    GSL_LAUNCH(8);
  }
#undef GSL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
