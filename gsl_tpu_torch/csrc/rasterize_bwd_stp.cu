// K3s: StopThePop backward, one gradient row per sorted slot.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_bwd_kernel, stp branch
// (pallas_call in _rasterize_bwd_raw), exact mode. For every sorted position
// (one tile, one Gaussian) it writes the sums over the tile's pixels of
//   d/d(mean x), d/d(mean y), d/d(conic a), d/d(conic b), d/d(conic c),
//   d/d(opacity), d/d(channel 0..C-1)
// given the cotangents of the composited channels and of alpha = 1 - T. The
// per-pixel order of every window is a constant; given it, the gradient is
// the ordinary compositing gradient with "in front" and "behind" read in the
// pixel's own order:
//   cg      = sum_c g_c * channel_c
//   q       = a * T_exc * cg
//   S_after = -T_final * g_alpha + sum of q over the entries behind
//   dalpha  = T_exc * cg - S_after / max(1 - a, 1e-3)
// and from dalpha on exactly K3's terms (rasterize_bwd.cu). Every slot of the
// tile's list with a > 0 takes part: the forward never stops.
//
// T is not rebuilt by dividing T_final as K3 does: with no stop a dense tile
// drives T_final to 0 and there is nothing to divide. (The TPU kernel has the
// same hazard, T_run * exp(-S_inc) = 0 * inf.) The forward (K2s) leaves T at
// the start of every window; this kernel walks a tile's windows back to
// front, starts each from its checkpoint, orders it with the forward's own
// code (stp_order.cuh) and runs the forward's own rule T_exc = T; T *= 1 - a
// over it, so T_exc is the forward's to the bit. Then q is laid out by rank
// and summed from the back, which gives S_after for every entry and the
// carry for the window in front. Every term is a product with T_exc, so a
// slot behind the point where T reached 0 gets exactly 0, and no gradient
// can be anything but finite.
//
// What the TPU needed and this does not: log1p/exp closures with window-level
// triangle matmuls, 2 x 15 shifted masked adds per sum, merge flags for
// stream blocks revisited at tile borders, a payload carried through the sort.
// Here one block of tile_size^2 threads owns one tile, one thread one pixel.
// Per window the 16 slots' fields are gathered by id into shared memory (one
// value per thread), each thread orders the window in registers and keeps
// T_exc and S_after by rank in its own two columns of shared memory, and the
// 6 + C per-pixel values of each slot are summed over each warp with shuffles
// (a warp in which no pixel composites the slot skips them), over the warps
// in warp order, and written as one row. No atomics: the same rows in every
// run.
//
// Bound on the H100: operations. Every (pixel, slot) pair costs 28 + 2C: the
// forward's 23, T_exc 2, cg 2C, q 2 and the suffix 1. A pair with a > 0
// costs K3's 35 + 4C more. A (pixel, window) whose live entries are out of
// order costs 360 more (the rank count). The bytes are the forward's, the
// checkpoints (64 per sorted slot), the cotangents and one row per valid
// slot.
//
// Any C works: C <= 8 is a template parameter (cotangents in registers),
// larger C keeps the cotangents in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "stp_order.cuh"

namespace {

constexpr int kMaxTemplateC = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kW = stp::kWindow;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void rasterize_bwd_stp_kernel(
    const float* __restrict__ means2d,      // [N, 2]
    const float* __restrict__ conics,       // [N, 3]
    const float* __restrict__ opacities,    // [N]
    const float* __restrict__ channels,     // [N, C]
    const float* __restrict__ depths,       // [N]
    const float* __restrict__ depth_grads,  // [N, 2]
    int n_channels,
    const int* __restrict__ gids,           // sorted by (tile, plane depth)
    const int64_t* __restrict__ bounds,     // [n_tiles + 1]
    int tiles_x, int tile_size, int height, int width,
    const float* __restrict__ g_out,        // [H, W, C]
    const float* __restrict__ g_alpha,      // [H, W]
    const float* __restrict__ t_final,      // [H, W]
    const float* __restrict__ checkpoints,  // [rows, bs], the forward's
    float* __restrict__ rows) {             // [n_slots, 6 + C], zeroed
  extern __shared__ float smem[];
  const int C = CT > 0 ? CT : n_channels;
  const int R = 6 + C;
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32
  const int n_warps = bs >> 5;
  float* s_geom = smem;                          // [kFields, kW]
  float* s_col = s_geom + stp::kFields * kW;     // [C, kW]
  float* s_part = s_col + C * kW;                // [n_warps, kW, R]
  int* s_flag = reinterpret_cast<int*>(s_part + n_warps * kW * R);
  float* s_texc = reinterpret_cast<float*>(s_flag + n_warps * kW);  // [kW, bs]
  float* s_after = s_texc + kW * bs;             // [kW, bs]
  float* s_g = s_after + kW * bs;                // [C, bs], CT == 0 only

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float max_alpha = static_cast<float>(0.999);
  const float min_one_minus = static_cast<float>(1e-3);

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  if (end <= start) return;  // uniform over the block
  const int64_t pix = static_cast<int64_t>(y) * width + x;

  // a pixel outside the image has zero cotangents and adds nothing
  float S = inside ? -t_final[pix] * g_alpha[pix] : 0.0f;
  float g[CT > 0 ? CT : 1];
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) g[c] = inside ? g_out[pix * C + c] : 0.0f;
  } else {
    for (int c = 0; c < C; ++c)
      s_g[c * bs + tid] = inside ? g_out[pix * C + c] : 0.0f;
  }
  float* texc_column = s_texc + tid;
  float* after_column = s_after + tid;

  const int64_t first_window = start / kW;
  for (int64_t window = (end - 1) / kW; window >= first_window; --window) {
    const int64_t base = window * kW;
    __syncthreads();  // the previous window's rows have been written out
    for (int v = tid; v < (stp::kFields + C) * kW; v += bs) {
      const int f = v / kW;
      const int l = v - f * kW;
      const int64_t idx = base + l;
      float value = 0.0f;  // outside the tile's range: opacity 0, a == 0
      if (idx >= start && idx < end) {
        const int gid = gids[idx];
        value = f < stp::kFields
                    ? stp::load_field(f, gid, means2d, conics, opacities,
                                      depths, depth_grads)
                    : channels[static_cast<int64_t>(gid) * C +
                               (f - stp::kFields)];
      }
      s_geom[v] = value;  // s_col follows s_geom
    }
    __syncthreads();

    float a[kW], d[kW];
#pragma unroll
    for (int l = 0; l < kW; ++l) {
      const stp::Pair p = stp::pair_terms(s_geom, kW, l, px, py);
      a[l] = p.a;
      d[l] = p.d;
    }
    const uint64_t ranks = stp::window_ranks(a, d);
    stp::window_transmittance(a, ranks, checkpoints[(window + tile) * bs + tid],
                              texc_column, bs);
    // q by rank, then summed from the back: S_after of every entry, and S
    // for the window in front
#pragma unroll
    for (int l = 0; l < kW; ++l) {
      const int r = stp::rank_of(ranks, l);
      float cg = 0.0f;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) cg += g[c] * s_col[c * kW + l];
      } else {
        for (int c = 0; c < C; ++c) cg += s_g[c * bs + tid] * s_col[c * kW + l];
      }
      after_column[r * bs] = a[l] * texc_column[r * bs] * cg;
    }
#pragma unroll
    for (int r = kW - 1; r >= 0; --r) {
      const float q = after_column[r * bs];
      after_column[r * bs] = S;
      S += q;
    }

#pragma unroll
    for (int l = 0; l < kW; ++l) {
      const bool comp = a[l] > 0.0f;
      const bool any = __any_sync(kFullMask, comp);
      if (lane == 0) s_flag[warp * kW + l] = any;
      if (!any) continue;  // uniform over the warp

      const stp::Pair p = stp::pair_terms(s_geom, kW, l, px, py);
      const float ca = s_geom[stp::kCa * kW + l];
      const float cb = s_geom[stp::kCb * kW + l];
      const float cc = s_geom[stp::kCc * kW + l];
      const int r = stp::rank_of(ranks, l);
      const float t_exc = texc_column[r * bs];
      const float s_behind = after_column[r * bs];
      float cg = 0.0f;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) cg += g[c] * s_col[c * kW + l];
      } else {
        for (int c = 0; c < C; ++c) cg += s_g[c * bs + tid] * s_col[c * kW + l];
      }
      const float dalpha =
          comp ? t_exc * cg - s_behind / fmaxf(1.0f - a[l], min_one_minus)
               : 0.0f;
      const float w = a[l] * t_exc;
      const bool unclamped = p.raw < max_alpha;
      const float dsigma = unclamped ? -a[l] * dalpha : 0.0f;
      const float dop = (unclamped && comp) ? dalpha * p.e : 0.0f;
      const float gx = ca * p.dx + cb * p.dy;
      const float gy = cc * p.dy + cb * p.dx;

      float* part = s_part + (warp * kW + l) * R;
      float v;
      v = warp_sum(dsigma * gx);
      if (lane == 0) part[0] = v;
      v = warp_sum(dsigma * gy);
      if (lane == 0) part[1] = v;
      v = warp_sum(dsigma * 0.5f * p.dx * p.dx);
      if (lane == 0) part[2] = v;
      v = warp_sum(dsigma * p.dx * p.dy);
      if (lane == 0) part[3] = v;
      v = warp_sum(dsigma * 0.5f * p.dy * p.dy);
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
    for (int idx = tid; idx < kW * R; idx += bs) {
      const int l = idx / R;
      const int v = idx - l * R;
      const int64_t pos = base + l;
      if (pos < start || pos >= end) continue;  // another tile's slot
      float sum = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp) {
        if (s_flag[wp * kW + l]) sum += s_part[(wp * kW + l) * R + v];
      }
      rows[pos * R + v] = sum;
    }
  }
}

template <int CT>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   const float* depths, const float* depth_grads,
                   int n_channels, const int* gids, const int64_t* bounds,
                   int n_tiles, int tiles_x, int tile_size, int height,
                   int width, const float* g_out, const float* g_alpha,
                   const float* t_final, const float* checkpoints,
                   float* rows, cudaStream_t stream) {
  const int bs = tile_size * tile_size;
  const int n_warps = bs / 32;
  const int R = 6 + n_channels;
  size_t words = static_cast<size_t>(stp::kFields + n_channels) * kW +
                 static_cast<size_t>(n_warps) * kW * R +
                 static_cast<size_t>(n_warps) * kW +
                 2 * static_cast<size_t>(kW) * bs;
  if (CT == 0) words += static_cast<size_t>(n_channels) * bs;
  const size_t smem = words * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_stp_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_bwd_stp_kernel<CT><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,
      gids, bounds, tiles_x, tile_size, height, width, g_out, g_alpha,
      t_final, checkpoints, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [n_slots, 6 + C] must be zeroed by the caller: only the valid
// positions are written.
int gsl_rasterize_bwd_stp(const float* means2d, const float* conics,
                          const float* opacities, const float* channels,
                          const float* depths, const float* depth_grads,
                          int n_channels, const int* gids,
                          const int64_t* bounds, int n_tiles, int tiles_x,
                          int tile_size, int height, int width,
                          const float* g_out, const float* g_alpha,
                          const float* t_final, const float* checkpoints,
                          float* rows, void* stream) {
  const int bs = tile_size * tile_size;
  if (n_channels < 1 || tile_size < 1 || bs > 1024 || bs % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSL_LAUNCH(CT)                                                        \
  return static_cast<int>(launch<CT>(                                         \
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,  \
      gids, bounds, n_tiles, tiles_x, tile_size, height, width, g_out,        \
      g_alpha, t_final, checkpoints, rows, s))
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
