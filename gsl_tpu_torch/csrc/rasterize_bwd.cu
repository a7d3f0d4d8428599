// K3: backward of the per-tile compositing, one gradient row per sorted slot.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_bwd_kernel (pallas_call in
// _rasterize_bwd_raw), exact mode. For every sorted position (one tile, one
// Gaussian) it writes the sums over the tile's pixels of
//   d/d(mean x), d/d(mean y), d/d(conic a), d/d(conic b), d/d(conic c),
//   d/d(opacity), d/d(channel 0..C-1)
// given the cotangents of the composited channels and of alpha = 1 - T.
// A pixel takes a splat into account iff the forward composited it: the
// position lies before the pixel's stop, sigma >= 0 and alpha >= 1/255.
// Walking a tile's list back to front from the final transmittance:
//   T_exc  = T / (1 - a)                 transmittance in front of the splat
//   cg     = sum_c g_c * channel_c
//   dalpha = T_exc * cg - S / max(1 - a, 1e-3)
//   S     += a * T_exc * cg              starts at -T_final * g_alpha
//   dsigma = -a * dalpha                 only where op * exp(-sigma) < 0.999
//   dop    = dalpha * exp(-sigma)        under the same condition
//   dmean  = dsigma * (conic . delta), dconic = dsigma * (dx^2/2, dx dy, dy^2/2)
//   dchannel_c = a * T_exc * g_c
//
// What the TPU needed and this does not: the suffix products closed with
// log1p/exp and triangle matmuls, stream blocks revisited at tile borders
// with merge flags, and a payload sorted along with the keys. Here one block
// of tile_size^2 threads owns one tile, one thread one pixel. The block walks
// the tile's range of sorted ids backwards from the largest stop of its
// pixels, in batches of kBatch ids gathered into shared memory. Per splat the
// 6 + C per-pixel values are summed over each warp with shuffles (a warp in
// which no pixel composites the splat skips them), lane 0 leaves the warp's
// sums in shared memory, and after the batch the warps' sums are added in
// warp order and written as rows [6 + C]. No atomics: the result is the same
// in every run.
//
// Bound on the H100: operations. Deciding whether a visited (pixel, splat)
// pair was composited costs 18 operations (delta 2, sigma 9, negate and exp
// 2, alpha 2, three compares). A composited pair costs 35 + 4C more: 1 - a
// and T_exc 2, cg 2C, dalpha 4, weight and S 3, dsigma and dop 3, the conic
// products 6, the six geometry terms 11, the C channel terms C, and its
// share of the pixel sums, 6 + C adds. The bytes are those of the forward
// plus one row per sorted slot.
//
// Any C works: C <= 8 is a template parameter (cotangents in registers),
// larger C keeps the cotangents in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 64;
constexpr int kMaxTemplateC = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void rasterize_bwd_kernel(
    const float* __restrict__ means2d,    // [N, 2]
    const float* __restrict__ conics,     // [N, 3]
    const float* __restrict__ opacities,  // [N]
    const float* __restrict__ channels,   // [N, C]
    int n_channels,
    const int* __restrict__ gids,         // [n_valid] sorted by (tile, depth)
    const int64_t* __restrict__ bounds,   // [n_tiles + 1]
    int tiles_x, int tile_size, int height, int width,
    const float* __restrict__ g_out,      // [H, W, C]
    const float* __restrict__ g_alpha,    // [H, W]
    const float* __restrict__ t_final,    // [H, W]
    const int* __restrict__ i_stop,       // [H, W]
    float* __restrict__ rows) {           // [n_valid, 6 + C], zeroed
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int C = CT > 0 ? CT : n_channels;
  const int R = 6 + C;
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32
  const int n_warps = bs >> 5;
  float* s_mx = smem;
  float* s_my = s_mx + kBatch;
  float* s_ca = s_my + kBatch;
  float* s_cb = s_ca + kBatch;
  float* s_cc = s_cb + kBatch;
  float* s_op = s_cc + kBatch;
  float* s_col = s_op + kBatch;                  // [C, kBatch]
  float* s_part = s_col + C * kBatch;            // [n_warps, kBatch, R]
  int* s_flag = reinterpret_cast<int*>(s_part + n_warps * kBatch * R);
  float* s_g = reinterpret_cast<float*>(s_flag + n_warps * kBatch);  // [C, bs]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  const float min_one_minus = static_cast<float>(1e-3);

  const int start = static_cast<int>(bounds[tile]);
  const int end = static_cast<int>(bounds[tile + 1]);
  const int64_t pix = static_cast<int64_t>(y) * width + x;

  float T = 1.0f;
  float S = 0.0f;
  int stop = 0;  // a pixel outside the image composited nothing
  float g[CT > 0 ? CT : 1];
  if (inside) {
    T = t_final[pix];
    S = -T * g_alpha[pix];
    stop = i_stop[pix];
  }
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) g[c] = inside ? g_out[pix * C + c] : 0.0f;
  } else {
    for (int c = 0; c < C; ++c)
      s_g[c * bs + tid] = inside ? g_out[pix * C + c] : 0.0f;
  }

  // nothing at or behind the largest stop of the tile's pixels was composited
  if (tid == 0) s_last = start;
  __syncthreads();
  atomicMax(&s_last, stop < end ? stop : end);
  __syncthreads();
  const int last = s_last;

  const int n_batches = (last - start + kBatch - 1) / kBatch;
  for (int b = n_batches - 1; b >= 0; --b) {
    const int base = start + b * kBatch;
    const int count = last - base < kBatch ? last - base : kBatch;
    __syncthreads();  // the previous batch's sums have been written out
    if (tid < count) {
      const int gid = gids[base + tid];
      s_mx[tid] = means2d[2 * gid + 0];
      s_my[tid] = means2d[2 * gid + 1];
      s_ca[tid] = conics[3 * gid + 0];
      s_cb[tid] = conics[3 * gid + 1];
      s_cc[tid] = conics[3 * gid + 2];
      s_op[tid] = opacities[gid];
      const float* col = channels + static_cast<int64_t>(gid) * C;
      for (int c = 0; c < C; ++c) s_col[c * kBatch + tid] = col[c];
    }
    __syncthreads();
    for (int j = count - 1; j >= 0; --j) {
      const float ca = s_ca[j], cb = s_cb[j], cc = s_cc[j];
      const float dx = s_mx[j] - px;
      const float dy = s_my[j] - py;
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float e = expf(-sigma);
      const float raw = s_op[j] * e;
      const float alpha = fminf(max_alpha, raw);
      const bool comp =
          base + j < stop && !(sigma < 0.0f) && !(alpha < threshold);
      const bool any = __any_sync(kFullMask, comp);
      if (lane == 0) s_flag[warp * kBatch + j] = any;
      if (!any) continue;  // uniform over the warp

      const float a = comp ? alpha : 0.0f;
      const float one_minus = 1.0f - a;
      const float t_exc = T / one_minus;
      float cg = 0.0f;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) cg += g[c] * s_col[c * kBatch + j];
      } else {
        for (int c = 0; c < C; ++c)
          cg += s_g[c * bs + tid] * s_col[c * kBatch + j];
      }
      const float dalpha =
          comp ? t_exc * cg - S / fmaxf(one_minus, min_one_minus) : 0.0f;
      const float w = a * t_exc;
      S += w * cg;
      T = t_exc;
      const bool unclamped = raw < max_alpha;
      const float dsigma = unclamped ? -a * dalpha : 0.0f;
      const float dop = (unclamped && comp) ? dalpha * e : 0.0f;
      const float gx = ca * dx + cb * dy;
      const float gy = cc * dy + cb * dx;

      float* part = s_part + (warp * kBatch + j) * R;
      float v;
      v = warp_sum(dsigma * gx);
      if (lane == 0) part[0] = v;
      v = warp_sum(dsigma * gy);
      if (lane == 0) part[1] = v;
      v = warp_sum(dsigma * 0.5f * dx * dx);
      if (lane == 0) part[2] = v;
      v = warp_sum(dsigma * dx * dy);
      if (lane == 0) part[3] = v;
      v = warp_sum(dsigma * 0.5f * dy * dy);
      if (lane == 0) part[4] = v;
      v = warp_sum(dop);
      if (lane == 0) part[5] = v;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          v = warp_sum(w * g[c]);
          if (lane == 0) part[6 + c] = v;
        }
      } else {
        for (int c = 0; c < C; ++c) {
          v = warp_sum(w * s_g[c * bs + tid]);
          if (lane == 0) part[6 + c] = v;
        }
      }
    }
    __syncthreads();
    // the warps' sums, added in warp order: one row per sorted position
    for (int idx = tid; idx < count * R; idx += bs) {
      const int j = idx / R;
      const int v = idx - j * R;
      float sum = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp) {
        if (s_flag[wp * kBatch + j]) sum += s_part[(wp * kBatch + j) * R + v];
      }
      rows[static_cast<int64_t>(base) * R + idx] = sum;
    }
  }
}

template <int CT>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   int n_channels, const int* gids, const int64_t* bounds,
                   int n_tiles, int tiles_x, int tile_size, int height,
                   int width, const float* g_out, const float* g_alpha,
                   const float* t_final, const int* i_stop, float* rows,
                   cudaStream_t stream) {
  const int bs = tile_size * tile_size;
  const int n_warps = bs / 32;
  const int R = 6 + n_channels;
  size_t words = static_cast<size_t>(6 + n_channels) * kBatch +
                 static_cast<size_t>(n_warps) * kBatch * R +
                 static_cast<size_t>(n_warps) * kBatch;
  if (CT == 0) words += static_cast<size_t>(n_channels) * bs;
  const size_t smem = words * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_bwd_kernel<CT><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, n_channels, gids, bounds, tiles_x,
      tile_size, height, width, g_out, g_alpha, t_final, i_stop, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [n_valid, 6 + C] must be zeroed by the caller: positions at or behind
// a tile's largest stop are not written.
int gsl_rasterize_bwd(const float* means2d, const float* conics,
                      const float* opacities, const float* channels,
                      int n_channels, const int* gids, const int64_t* bounds,
                      int n_tiles, int tiles_x, int tile_size, int height,
                      int width, const float* g_out, const float* g_alpha,
                      const float* t_final, const int* i_stop, float* rows,
                      void* stream) {
  const int bs = tile_size * tile_size;
  if (n_channels < 1 || tile_size < 1 || bs > 1024 || bs % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSL_LAUNCH(CT)                                                        \
  return static_cast<int>(launch<CT>(                                         \
      means2d, conics, opacities, channels, n_channels, gids, bounds,         \
      n_tiles, tiles_x, tile_size, height, width, g_out, g_alpha, t_final,    \
      i_stop, rows, s))
  switch (n_channels <= kMaxTemplateC ? n_channels : 0) {
    case 1: GSL_LAUNCH(1);
    case 2: GSL_LAUNCH(2);
    case 3: GSL_LAUNCH(3);
    case 4: GSL_LAUNCH(4);
    case 5: GSL_LAUNCH(5);
    case 6: GSL_LAUNCH(6);
    case 7: GSL_LAUNCH(7);
    case 8: GSL_LAUNCH(8);
    default: GSL_LAUNCH(0);
  }
#undef GSL_LAUNCH
}

}  // extern "C"
