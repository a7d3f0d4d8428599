// K2: front-to-back alpha compositing of each tile's depth-sorted splats.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_fwd_kernel (pallas_call in
// _rasterize_fwd_raw). Same outputs: the composited channels without
// background, the final transmittance T and, per pixel, the global sorted
// position of the splat at which compositing stopped (2^30 when it never
// stopped), which the backward pass walks back from. Semantics are the
// oracle's (gsl_tpu/ops/rasterize_reference.py): alpha = min(0.999,
// op * exp(-sigma)); skip when sigma < 0 or alpha < 1/255; stop before
// compositing when T * (1 - alpha) <= 1e-4.
//
// What the TPU needed and this does not: the transmittance recurrence
// closed into log1p/exp triangle matmuls on the MXU, 1024-slot stream
// blocks with a packed schedule, and a payload sorted along with the keys.
// Here one block of tile_size^2 threads owns one tile, one thread one
// pixel, and walks the tile's range of the sorted Gaussian ids in batches
// of one id per thread. Each batch is gathered by id into shared memory
// (mean, conic, opacity, the channel group) and every thread composites it
// in order, sequentially, as the oracle does. The block leaves as soon as
// every pixel has stopped (__syncthreads_count).
//
// Bound on the H100: operations. Every (pixel, splat) pair a pixel visits
// costs ~16 f32 operations and an exp, plus 2 per channel when it is
// composited; at the bench scene that is ~10^9 operations against ~10^8
// bytes of inputs and outputs. The shared-memory batch turns the random
// gather into one load per splat per tile instead of one per pixel.
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels (a template parameter, so the sums stay in registers)
// and the caller launches once per group. Every launch recomputes the same
// T and stop index.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroup = 8;
constexpr int kNeverStopped = 1 << 30;

template <int CG>
__global__ void rasterize_fwd_kernel(
    const float* __restrict__ means2d,    // [N, 2]
    const float* __restrict__ conics,     // [N, 3]
    const float* __restrict__ opacities,  // [N]
    const float* __restrict__ channels,   // [N, C]
    int n_channels, int c0,
    const int* __restrict__ gids,         // [n_valid] sorted by (tile, depth)
    const int64_t* __restrict__ bounds,   // [n_tiles + 1] tile t: [b[t], b[t+1])
    int tiles_x, int tile_size, int height, int width,
    float* __restrict__ out,              // [H, W, C]
    float* __restrict__ t_final,          // [H, W]
    int* __restrict__ i_stop) {           // [H, W]
  extern __shared__ float smem[];
  const int bs = blockDim.x;  // tile_size^2
  float* s_mx = smem;
  float* s_my = s_mx + bs;
  float* s_ca = s_my + bs;
  float* s_cb = s_ca + bs;
  float* s_cc = s_cb + bs;
  float* s_op = s_cc + bs;
  float* s_col = s_op + bs;  // [CG, bs]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  const float min_t = static_cast<float>(1e-4);

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  float T = 1.0f;
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
      s_mx[tid] = means2d[2 * g + 0];
      s_my[tid] = means2d[2 * g + 1];
      s_ca[tid] = conics[3 * g + 0];
      s_cb[tid] = conics[3 * g + 1];
      s_cc[tid] = conics[3 * g + 2];
      s_op[tid] = opacities[g];
      const float* col = channels + static_cast<int64_t>(g) * n_channels + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c) s_col[c * bs + tid] = col[c];
    }
    __syncthreads();
    const int count = static_cast<int>(end - base < bs ? end - base : bs);
    for (int j = 0; j < count && !done; ++j) {
      const float dx = s_mx[j] - px;
      const float dy = s_my[j] - py;
      const float sigma = 0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) +
                          s_cb[j] * dx * dy;
      const float alpha = fminf(max_alpha, s_op[j] * expf(-sigma));
      if (sigma < 0.0f || alpha < threshold) continue;
      const float next_t = T * (1.0f - alpha);
      if (next_t <= min_t) {
        done = true;
        stop = static_cast<int>(base + j);
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] += w * s_col[c * bs + j];
      T = next_t;
    }
  }
  if (!inside) return;
  const int64_t pix = static_cast<int64_t>(y) * width + x;
#pragma unroll
  for (int c = 0; c < CG; ++c) out[pix * n_channels + c0 + c] = acc[c];
  t_final[pix] = T;
  i_stop[pix] = stop;
}

template <int CG>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   int n_channels, int c0, const int* gids,
                   const int64_t* bounds, int n_tiles, int tiles_x,
                   int tile_size, int height, int width, float* out,
                   float* t_final, int* i_stop, cudaStream_t stream) {
  const int bs = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(6 + CG) * bs * sizeof(float);
  rasterize_fwd_kernel<CG><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, n_channels, c0, gids, bounds,
      tiles_x, tile_size, height, width, out, t_final, i_stop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_rasterize_fwd_max_group() { return kMaxGroup; }

// Composites channels [c0, c0 + cg) of `channels`; T and i_stop are
// written by every call and agree between calls.
int gsl_rasterize_fwd(const float* means2d, const float* conics,
                      const float* opacities, const float* channels,
                      int n_channels, int c0, int cg, const int* gids,
                      const int64_t* bounds, int n_tiles, int tiles_x,
                      int tile_size, int height, int width, float* out,
                      float* t_final, int* i_stop, void* stream) {
  if (cg < 1 || cg > kMaxGroup || c0 < 0 || c0 + cg > n_channels ||
      tile_size < 1 || tile_size * tile_size > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSL_LAUNCH(CG)                                                       \
  case CG:                                                                   \
    return static_cast<int>(launch<CG>(                                      \
        means2d, conics, opacities, channels, n_channels, c0, gids, bounds,  \
        n_tiles, tiles_x, tile_size, height, width, out, t_final, i_stop, s))
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
