// K7: backward of the surfel compositing, one gradient row per sorted slot.
//
// Replaces gsl_tpu/ops/surfel_pallas.py::_bwd_kernel_s (pallas_call in
// _rasterize_bwd_raw_s), the hand-derived gradient of K6. For every sorted
// position (one tile, one surfel) it writes the sums over the tile's pixels
// of d/d(Tu[3], Tv[3], Tw[3], zu, zv, z0, opacity, channel 0..C-1), given
// the cotangents of the composited channels, of alpha = 1 - T, of
// sum w * depth and of the distortion (the median depth has no gradient).
// A pixel takes a surfel into account iff the forward composited it: the
// position lies before the pixel's stop and the solve of surfel_terms.cuh
// keeps the pair. Walking a tile's list back to front from the forward's
// final T, with the forward's final sums A, M1, M2 of w, w m, w m^2:
//   T_exc  = T / (1 - a),  w = a T_exc
//   dw     = g . ch + g_depth depth
//            + g_dist (m^2 (A - w) + (M2 - w m^2) - 2 m (M1 - w m))
//   dalpha = T_exc dw - S / max(1 - a, 1e-3)
//   S     += w dw                        starts at -T_final * g_alpha
//   ddepth = w (g_depth + 2 g_dist (m (A - w) - (M1 - w m)) dm/dd)
// then, where op * G < 0.99, through G = exp(-rho / 2) into rho3d = u^2 + v^2
// or rho2d by the branch the forward took, through the plane cross
// (dhx = hy x ds, dhy = ds x hx) into the nine T entries, rho2d through the
// projected centre into Tw, and the depth into zc (z0 alone where the
// low-pass won). The distortion is symmetric in its pairs, so its derivative
// by w_i runs over every other surfel of the pixel: the reference's
// "total - suffix - self" prefix plus its suffix is the total less the
// surfel itself, and no suffix sums are carried.
//
// What the TPU needed and this does not: the suffix products and the four
// suffix sums closed with log1p/exp and triangle matmuls, stream blocks
// revisited at tile borders with merge flags, and a second payload sort
// before the per-surfel reduce. Here one block of tile_size^2 threads owns
// one tile, one thread one pixel. The block walks the tile's range of
// sorted ids backwards from the largest stop of its pixels, in batches of
// kBatch ids gathered into shared memory. Per surfel the 13 + C per-pixel
// values are summed over each warp with shuffles (a warp in which no pixel
// composited the surfel skips them), lane 0 leaves the warp's sums in
// shared memory, and after the batch the warps' sums are added in warp
// order and written as rows [13 + C]. No atomics: the result is the same in
// every run.
//
// Bound on the H100: operations. Deciding whether a visited (pixel, surfel)
// pair was composited costs 48 operations (the forward's 47 and the stop
// compare). A composited pair costs 123 + 4C more: T_exc and w 3, the mapped
// depth and its products 7, cg 2C, the three totals 3, dw 10, dalpha 4,
// ddepth 11, S 2, dG, dop and drho 4, du and dv 8, ds 7, the two cross
// products 18, the centre terms 6, the nine T values 25, the zc values 2,
// the C channel values, and its share of the pixel sums, 13 + C adds. The
// bytes are the forward's plus one row of 13 + C values per sorted slot.
//
// Any C works: C <= 8 is a template parameter (cotangents in registers),
// larger C keeps the cotangents in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "surfel_terms.cuh"

namespace {

constexpr int kBatch = 32;
constexpr int kMaxTemplateC = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void rasterize_surfels_bwd_kernel(
    const float* __restrict__ geom,      // [N, 13] Tu Tv Tw zc opacity
    const float* __restrict__ channels,  // [N, C]
    int n_channels,
    const int* __restrict__ gids,        // [n_valid] sorted by (tile, depth)
    const int64_t* __restrict__ bounds,  // [n_tiles + 1]
    int tiles_x, int tile_size, int height, int width,
    const float* __restrict__ g_out,     // [H, W, C]
    const float* __restrict__ g_aux,     // [3, H, W] alpha, sum w d, distortion
    const float* __restrict__ aux,       // [7, H, W] the forward's
    const int* __restrict__ i_stop,      // [H, W]
    float* __restrict__ rows) {          // [n_valid, 13 + C], zeroed
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int C = CT > 0 ? CT : n_channels;
  const int R = surfel::kGeom + C;
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32
  const int n_warps = bs >> 5;
  float* s_geom = smem;                             // [kSplat, kBatch]
  float* s_col = s_geom + surfel::kSplat * kBatch;  // [C, kBatch]
  float* s_part = s_col + C * kBatch;               // [n_warps, kBatch, R]
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
  const float max_alpha = static_cast<float>(0.99);
  const float min_one_minus = static_cast<float>(1e-3);

  const int start = static_cast<int>(bounds[tile]);
  const int end = static_cast<int>(bounds[tile + 1]);
  const int64_t pix = static_cast<int64_t>(y) * width + x;
  const int64_t plane = static_cast<int64_t>(height) * width;

  float T = 1.0f, S = 0.0f;
  float gd = 0.0f, gD = 0.0f, Afin = 0.0f, M1fin = 0.0f, M2fin = 0.0f;
  int stop = 0;  // a pixel outside the image composited nothing
  float g[CT > 0 ? CT : 1];
  if (inside) {
    T = aux[0 * plane + pix];
    Afin = aux[4 * plane + pix];
    M1fin = aux[5 * plane + pix];
    M2fin = aux[6 * plane + pix];
    S = -T * g_aux[0 * plane + pix];
    gd = g_aux[1 * plane + pix];
    gD = g_aux[2 * plane + pix];
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
      const float* row = geom + static_cast<int64_t>(gid) * surfel::kGeom;
#pragma unroll
      for (int k = 0; k < surfel::kGeom; ++k)
        s_geom[k * kBatch + tid] = row[k];
      const float twz = surfel::safe_twz(row[8]);
      s_geom[13 * kBatch + tid] = row[6] / twz;
      s_geom[14 * kBatch + tid] = row[7] / twz;
      const float* col = channels + static_cast<int64_t>(gid) * C;
      for (int c = 0; c < C; ++c) s_col[c * kBatch + tid] = col[c];
    }
    __syncthreads();
    for (int j = count - 1; j >= 0; --j) {
      const float* sg = s_geom + j;
      const surfel::Terms t = surfel::solve(sg, kBatch, px, py);
      const bool comp = base + j < stop && t.keep;
      const bool any = __any_sync(kFullMask, comp);
      if (lane == 0) s_flag[warp * kBatch + j] = any;
      if (!any) continue;  // uniform over the warp

      const float a = comp ? t.alpha : 0.0f;
      const float one_minus = 1.0f - a;
      const float t_exc = T / one_minus;
      const float w = a * t_exc;
      const float m = comp ? surfel::map_depth(t.depth) : 0.0f;
      const float wm = w * m;
      const float wm2 = wm * m;
      float cg = 0.0f;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) cg += g[c] * s_col[c * kBatch + j];
      } else {
        for (int c = 0; c < C; ++c)
          cg += s_g[c * bs + tid] * s_col[c * kBatch + j];
      }
      // the sums over every other composited surfel of the pixel
      const float A_all = Afin - w;
      const float M1_all = M1fin - wm;
      const float M2_all = M2fin - wm2;
      const float dw = cg + gd * t.depth +
                       gD * (m * m * A_all + M2_all - 2.0f * m * M1_all);
      const float dalpha =
          comp ? t_exc * dw - S / fmaxf(one_minus, min_one_minus) : 0.0f;
      const float ddepth =
          comp ? w * (gd + 2.0f * gD * (m * A_all - M1_all) *
                               surfel::dmap_ddepth(t.depth))
               : 0.0f;
      if (comp) S += w * dw;
      T = t_exc;

      const bool nc = t.raw < max_alpha;
      const float op = sg[12 * kBatch];
      const float dG = nc ? dalpha * op : 0.0f;
      const float dop = (nc && comp) ? dalpha * t.G : 0.0f;
      const float drho = -0.5f * t.G * dG;
      const float drho3 = t.use3d ? drho : 0.0f;
      const float drho2 = t.use3d ? 0.0f : drho;
      const float dd3 = t.use3d ? ddepth : 0.0f;
      const float du = 2.0f * t.u * drho3 + dd3 * sg[9 * kBatch];
      const float dv = 2.0f * t.v * drho3 + dd3 * sg[10 * kBatch];
      const float ds0 = du / t.cz;
      const float ds1 = dv / t.cz;
      const float ds2 = -(du * t.u + dv * t.v) / t.cz;
      // dhx = hy x ds, dhy = ds x hx
      const float dhx0 = t.hy[1] * ds2 - t.hy[2] * ds1;
      const float dhx1 = t.hy[2] * ds0 - t.hy[0] * ds2;
      const float dhx2 = t.hy[0] * ds1 - t.hy[1] * ds0;
      const float dhy0 = ds1 * t.hx[2] - ds2 * t.hx[1];
      const float dhy1 = ds2 * t.hx[0] - ds0 * t.hx[2];
      const float dhy2 = ds0 * t.hx[1] - ds1 * t.hx[0];
      // the low-pass branch reaches Tw through the projected centre
      const float dcxp = -(4.0f * t.dxp * drho2);
      const float dcyp = -(4.0f * t.dyp * drho2);
      const float twz = surfel::safe_twz(sg[8 * kBatch]);

      float* part = s_part + (warp * kBatch + j) * R;
      float v;
#define GSL_SUM(k, expr)       \
  v = warp_sum(expr);          \
  if (lane == 0) part[k] = v
      GSL_SUM(0, -dhx0);
      GSL_SUM(1, -dhy0);
      GSL_SUM(2, px * dhx0 + py * dhy0);
      GSL_SUM(3, -dhx1);
      GSL_SUM(4, -dhy1);
      GSL_SUM(5, px * dhx1 + py * dhy1);
      GSL_SUM(6, -dhx2 + dcxp / twz);
      GSL_SUM(7, -dhy2 + dcyp / twz);
      GSL_SUM(8, px * dhx2 + py * dhy2 -
                     (dcxp * sg[6 * kBatch] + dcyp * sg[7 * kBatch]) /
                         (twz * twz));
      GSL_SUM(9, dd3 * t.u);
      GSL_SUM(10, dd3 * t.v);
      GSL_SUM(11, ddepth);
      GSL_SUM(12, dop);
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          GSL_SUM(surfel::kGeom + c, w * g[c]);
        }
      } else {
        for (int c = 0; c < C; ++c) {
          GSL_SUM(surfel::kGeom + c, w * s_g[c * bs + tid]);
        }
      }
#undef GSL_SUM
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
cudaError_t launch(const float* geom, const float* channels, int n_channels,
                   const int* gids, const int64_t* bounds, int n_tiles,
                   int tiles_x, int tile_size, int height, int width,
                   const float* g_out, const float* g_aux, const float* aux,
                   const int* i_stop, float* rows, cudaStream_t stream,
                   int* attributes) {
  const int bs = tile_size * tile_size;
  const int n_warps = bs / 32;
  const int R = surfel::kGeom + n_channels;
  size_t words = static_cast<size_t>(surfel::kSplat + n_channels) * kBatch +
                 static_cast<size_t>(n_warps) * kBatch * R +
                 static_cast<size_t>(n_warps) * kBatch;
  if (CT == 0) words += static_cast<size_t>(n_channels) * bs;
  const size_t smem = words * sizeof(float);
  if (attributes != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t err =
        cudaFuncGetAttributes(&attr, rasterize_surfels_bwd_kernel<CT>);
    if (err != cudaSuccess) return err;
    attributes[0] = attr.numRegs;
    attributes[1] = static_cast<int>(attr.localSizeBytes);
    attributes[2] = static_cast<int>(smem);
    return cudaSuccess;
  }
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_surfels_bwd_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_surfels_bwd_kernel<CT><<<n_tiles, bs, smem, stream>>>(
      geom, channels, n_channels, gids, bounds, tiles_x, tile_size, height,
      width, g_out, g_aux, aux, i_stop, rows);
  return cudaGetLastError();
}

int dispatch(const float* geom, const float* channels, int n_channels,
             const int* gids, const int64_t* bounds, int n_tiles, int tiles_x,
             int tile_size, int height, int width, const float* g_out,
             const float* g_aux, const float* aux, const int* i_stop,
             float* rows, cudaStream_t s, int* attributes) {
#define GSL_LAUNCH(CT)                                                       \
  return static_cast<int>(launch<CT>(                                        \
      geom, channels, n_channels, gids, bounds, n_tiles, tiles_x, tile_size, \
      height, width, g_out, g_aux, aux, i_stop, rows, s, attributes))
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

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [n_valid, 13 + C] must be zeroed by the caller: positions at or
// behind a tile's largest stop are not written.
int gsl_rasterize_surfels_bwd(const float* geom, const float* channels,
                              int n_channels, const int* gids,
                              const int64_t* bounds, int n_tiles, int tiles_x,
                              int tile_size, int height, int width,
                              const float* g_out, const float* g_aux,
                              const float* aux, const int* i_stop,
                              float* rows, void* stream) {
  const int bs = tile_size * tile_size;
  if (n_channels < 1 || tile_size < 1 || bs > 1024 || bs % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(geom, channels, n_channels, gids, bounds, n_tiles, tiles_x,
                  tile_size, height, width, g_out, g_aux, aux, i_stop, rows,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..2]: registers per thread, local (spill) bytes per thread and
// dynamic shared bytes per block of the kernel that n_channels and
// tile_size select.
int gsl_rasterize_surfels_bwd_attributes(int n_channels, int tile_size,
                                         int* out) {
  if (n_channels < 1 || tile_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(nullptr, nullptr, n_channels, nullptr, nullptr, 0, 1,
                  tile_size, 0, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, out);
}

}  // extern "C"
