// K6: front-to-back compositing of each tile's depth-sorted surfels (2DGS).
//
// Replaces gsl_tpu/ops/surfel_pallas.py::_fwd_kernel_s (pallas_call in
// _rasterize_fwd_raw_s), with the oracle's semantics
// (gsl_tpu/ops/surfel.py::rasterize_surfels). Per (pixel, surfel) pair the
// ray-splat solve of surfel_terms.cuh; a pair counts when
// alpha = min(0.99, op * exp(-rho / 2)) >= 1/255, the solve is not
// degenerate and the depth is at least 0.2. Compositing stops, before the
// surfel is taken, at the first such pair with T * (1 - alpha) <= 1e-4.
// Outputs per pixel: the C composited channels without background; the
// final transmittance T; sum w * depth; the median depth (the depth of the
// surfel at which T first falls to 0.5 or below); the depth distortion
// sum_i w_i (m_i^2 A + M2 - 2 m_i M1) with the running sums A = sum w,
// M1 = sum w m, M2 = sum w m^2 over the surfels in front; the final A, M1,
// M2 (the backward needs them); and the global sorted position of the stop
// (2^30 when the pixel never stopped).
//
// What the TPU needed and this does not: the transmittance and the three
// distortion prefixes closed into log1p/exp and triangle matmuls on the MXU
// (four [P, 128] x [128, 128] products per chunk), 1024-slot stream blocks
// with a packed schedule, and a 13 + C payload sorted along with the keys.
// Here one block of tile_size^2 threads owns one tile, one thread one pixel,
// and walks the tile's range of the sorted surfel ids in batches of one id
// per thread, gathered by id into shared memory; every thread composites
// the batch in order, sequentially, as the oracle does, with its sums in
// registers. The block leaves as soon as every pixel has stopped.
//
// Bound on the H100: operations. A visited (pixel, surfel) pair costs 47 f32
// operations (hx, hy 12; the cross product 9; the guard 2; u, v 2; rho3d 3;
// the low-pass 6; the branch 2; depth 4; exp, alpha 4; three compares), a
// composited pair 26 + 2C more (transmittance 3, weight 1, the channels 2C,
// depth 2, the median 2, the mapped depth 5, the distortion 8, its sums 5).
// Against that stand 52 + 4C bytes per surfel, 4 per sorted id and
// 4 (C + 8) per pixel.
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels (a template parameter, so the sums stay in registers)
// and the caller launches once per group. Every launch recomputes and
// writes the same aux planes and stop index.
#include <cstdint>
#include <cuda_runtime.h>

#include "surfel_terms.cuh"

namespace {

constexpr int kMaxGroup = 8;
constexpr int kNeverStopped = 1 << 30;

template <int CG>
__global__ void rasterize_surfels_fwd_kernel(
    const float* __restrict__ geom,      // [N, 13] Tu Tv Tw zc opacity
    const float* __restrict__ channels,  // [N, C]
    int n_channels, int c0,
    const int* __restrict__ gids,        // [n_valid] sorted by (tile, depth)
    const int64_t* __restrict__ bounds,  // [n_tiles + 1] tile t: [b[t], b[t+1])
    int tiles_x, int tile_size, int height, int width,
    float* __restrict__ out,             // [H, W, C]
    float* __restrict__ aux,             // [7, H, W] T, sum w d, median,
                                         // distortion, A, M1, M2
    int* __restrict__ i_stop) {          // [H, W]
  extern __shared__ float smem[];
  const int bs = blockDim.x;  // tile_size^2
  float* s_geom = smem;                       // [kSplat, bs]
  float* s_col = smem + surfel::kSplat * bs;  // [CG, bs]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float min_t = static_cast<float>(1e-4);

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  float T = 1.0f, dacc = 0.0f, med = 0.0f, dist = 0.0f;
  float A = 0.0f, M1 = 0.0f, M2 = 0.0f;
  float acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = 0.0f;
  bool done = !inside;
  int stop = kNeverStopped;

  for (int64_t base = start; base < end; base += bs) {
    // also the barrier that frees shared memory from the previous batch
    if (__syncthreads_count(done) == bs) break;
    const int64_t idx = base + tid;
    if (idx < end) {
      const int g = gids[idx];
      const float* row = geom + static_cast<int64_t>(g) * surfel::kGeom;
#pragma unroll
      for (int k = 0; k < surfel::kGeom; ++k) s_geom[k * bs + tid] = row[k];
      const float twz = surfel::safe_twz(row[8]);
      s_geom[13 * bs + tid] = row[6] / twz;
      s_geom[14 * bs + tid] = row[7] / twz;
      const float* col = channels + static_cast<int64_t>(g) * n_channels + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c) s_col[c * bs + tid] = col[c];
    }
    __syncthreads();
    const int count = static_cast<int>(end - base < bs ? end - base : bs);
    for (int j = 0; j < count && !done; ++j) {
      const surfel::Terms t = surfel::solve(s_geom + j, bs, px, py);
      if (!t.keep) continue;
      const float next_t = T * (1.0f - t.alpha);
      if (next_t <= min_t) {
        done = true;
        stop = static_cast<int>(base + j);
        break;
      }
      const float w = t.alpha * T;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] += w * s_col[c * bs + j];
      dacc += w * t.depth;
      if (T > 0.5f && next_t <= 0.5f) med = t.depth;
      const float m = surfel::map_depth(t.depth);
      const float wm = w * m;
      const float wm2 = wm * m;
      dist += w * (m * m * A + M2 - 2.0f * m * M1);
      A += w;
      M1 += wm;
      M2 += wm2;
      T = next_t;
    }
  }
  if (!inside) return;
  const int64_t pix = static_cast<int64_t>(y) * width + x;
  const int64_t plane = static_cast<int64_t>(height) * width;
#pragma unroll
  for (int c = 0; c < CG; ++c) out[pix * n_channels + c0 + c] = acc[c];
  aux[0 * plane + pix] = T;
  aux[1 * plane + pix] = dacc;
  aux[2 * plane + pix] = med;
  aux[3 * plane + pix] = dist;
  aux[4 * plane + pix] = A;
  aux[5 * plane + pix] = M1;
  aux[6 * plane + pix] = M2;
  i_stop[pix] = stop;
}

template <int CG>
cudaError_t launch(const float* geom, const float* channels, int n_channels,
                   int c0, const int* gids, const int64_t* bounds,
                   int n_tiles, int tiles_x, int tile_size, int height,
                   int width, float* out, float* aux, int* i_stop,
                   cudaStream_t stream) {
  const int bs = tile_size * tile_size;
  const size_t smem =
      static_cast<size_t>(surfel::kSplat + CG) * bs * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_surfels_fwd_kernel<CG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_surfels_fwd_kernel<CG><<<n_tiles, bs, smem, stream>>>(
      geom, channels, n_channels, c0, gids, bounds, tiles_x, tile_size,
      height, width, out, aux, i_stop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_rasterize_surfels_fwd_max_group() { return kMaxGroup; }

// Composites channels [c0, c0 + cg) of `channels`; aux and i_stop are
// written by every call and agree between calls.
int gsl_rasterize_surfels_fwd(const float* geom, const float* channels,
                              int n_channels, int c0, int cg,
                              const int* gids, const int64_t* bounds,
                              int n_tiles, int tiles_x, int tile_size,
                              int height, int width, float* out, float* aux,
                              int* i_stop, void* stream) {
  if (cg < 1 || cg > kMaxGroup || c0 < 0 || c0 + cg > n_channels ||
      tile_size < 1 || tile_size * tile_size > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSL_LAUNCH(CG)                                                      \
  case CG:                                                                  \
    return static_cast<int>(launch<CG>(                                     \
        geom, channels, n_channels, c0, gids, bounds, n_tiles, tiles_x,     \
        tile_size, height, width, out, aux, i_stop, s))
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
