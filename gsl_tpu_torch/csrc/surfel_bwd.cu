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
// sorted ids backwards from the largest stop of its pixels (a max over the
// warps, no atomics), in batches of kBatch slots.
//
// Bound on the H100: operations. Deciding whether a visited (pixel, surfel)
// pair was composited costs 48 operations (the forward's 47 and the stop
// compare). A composited pair costs 123 + 4C more: T_exc and w 3, the mapped
// depth and its products 7, cg 2C, the three totals 3, dw 10, dalpha 4,
// ddepth 11, S 2, dG, dop and drho 4, du and dv 8, ds 7, the two cross
// products 18, the centre terms 6, the nine T values 25, the zc values 2,
// the C channel values, and its share of the pixel sums, 13 + C adds. The
// bytes are the forward's plus one row of 13 + C values per sorted slot.
// Before this design the kernel ran at 11x that bound (NVIDIA H100, 1M
// surfels, 1088x1920, C = 6): the 13 + C five-step shuffle sums of each
// (slot, warp) in which a pixel composites cost 1.0 of 5.6 ms, and the
// gather sat behind two barriers per batch. Of the new kernel's 3.8 ms the
// solve is 0.9, the gradient and its sums the rest; the gradient's six IEEE
// divisions by cz and Tw.z cost 1.4 more (an IEEE division checks its
// operands and branches to a slow path, which a warp runs if any lane
// needs it: the likely cause, not measured). What the design does about
// it:
//
// - The 13 + C values of a (slot, warp) are summed with one transposed sum
//   (warp_reduce.cuh): 21 shuffles at C = 6 instead of 95, the warp's row
//   left in 13 + C lanes that store it at once.
// - The gradient multiplies by 1 / cz and 1 / Tw.z, two reciprocals where
//   there were six divisions; the rows move by roundings.
// - A slot's fields lie together in shared memory (a record of 15 + C
//   floats padded to 16 bytes), read with four 16-byte loads per visited
//   pair where the strided layout took fifteen 4-byte ones.
// - The ids and records of the next batch are copied into a second buffer
//   with cp.async (__pipeline_memcpy_async) while this one is computed, the
//   ids two batches ahead. The copies gather by surfel id, which TMA's tiled
//   copies do not serve. The thread that copies a slot's Tw derives its
//   projected centre once its own copies have landed. The warps' partial
//   rows and their masks are double-buffered, so the cross-warp sum of one
//   batch (in warp order) runs during the next: one __syncthreads per batch.
// - The 47-operation solve of every visited pair is the bound's own floor
//   and stays as surfel_terms.cuh has it, shared with K6 (0.9 ms here).
// - The tensor cores play no part: there is no matrix product, and TF32
//   sums would not hold the rows to their tolerances.
//
// No atomics: the result is the same in every run.
// C <= 8 is a template parameter (cotangents in registers), larger C keeps
// the cotangents in shared memory and sums the row in chunks of 32 values.
// A launch takes at most max_group(tile_size) channels, the most whose
// block fits the 227 KiB of shared memory (the partial rows grow with C);
// the wrapper launches wider C once per group of channels and adds the
// groups' geometry columns (ops/rasterize.py, backward_by_channel_groups).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "surfel_terms.cuh"
#include "warp_reduce.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kBatch = 32;
using Mask = unsigned;  // one bit per slot of a batch
constexpr int kMaxTemplateC = 8;
constexpr int kMaxThreads = 1024;  // tile_size <= 32
// the dynamic shared memory a block of the H100 may ask for
constexpr size_t kMaxSharedBytes = 227 * 1024;
using gsl::kFullMask;

// A slot's record in shared memory: its kSplat values (surfel_terms.cuh's
// order), its C channels, padded to whole 16-byte loads.
__host__ __device__ __forceinline__ int record_floats(int n_channels) {
  return (surfel::kSplat + n_channels + 3) & ~3;
}

// The first kLoad values of a record, in four 16-byte loads: the kSplat
// values the solve reads and the first channel.
constexpr int kLoad = 16;
__device__ __forceinline__ void load_record(const float* rec,
                                            float (&r)[kLoad]) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int i = 0; i < kLoad / 4; ++i) {
    const float4 v = r4[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

size_t smem_words(int n_channels, int bs, bool g_shared) {
  const int n_warps = bs / 32;
  const int R = surfel::kGeom + n_channels;
  size_t words =
      2 * static_cast<size_t>(record_floats(n_channels)) * kBatch +
      2 * static_cast<size_t>(kBatch) +                 // ids
      2 * static_cast<size_t>(n_warps) * kBatch * R +   // partial rows
      2 * static_cast<size_t>(n_warps) * (sizeof(Mask) / 4) +  // masks
      static_cast<size_t>(n_warps);                     // the warps' stops
  if (g_shared) words += static_cast<size_t>(n_channels) * bs;
  return words;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void __launch_bounds__(kMaxThreads) rasterize_surfels_bwd_kernel(
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
  extern __shared__ __align__(16) float smem[];
  const int C = CT > 0 ? CT : n_channels;
  const int R = surfel::kGeom + C;
  const int RS = record_floats(C);
  const int F = kBatch * RS;  // one buffer of gathered records
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32
  const int n_warps = bs >> 5;
  float* s_fields = smem;                                    // [2][F]
  int* s_ids = reinterpret_cast<int*>(s_fields + 2 * F);     // [2][kBatch]
  float* s_part = reinterpret_cast<float*>(s_ids + 2 * kBatch);
  Mask* s_mask =                                     // [2][nw][kBatch][R]
      reinterpret_cast<Mask*>(s_part + 2 * n_warps * kBatch * R);
  int* s_stop = reinterpret_cast<int*>(s_mask + 2 * n_warps);  // [nw]
  float* s_g = reinterpret_cast<float*>(s_stop + n_warps);  // [C][bs]

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

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
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

  // nothing at or behind the largest stop of the tile's pixels was
  // composited: the largest over each warp, then over the warps
  const int mine = static_cast<int>(stop < end ? stop : end);
  const int warp_max = __reduce_max_sync(kFullMask, mine);
  if (lane == 0) s_stop[warp] = warp_max;
  __syncthreads();
  int64_t last = start;
  for (int wp = 0; wp < n_warps; ++wp) {
    last = s_stop[wp] > last ? s_stop[wp] : last;
  }
  const int n_batches = static_cast<int>((last - start + kBatch - 1) / kBatch);
  if (n_batches == 0) return;  // uniform over the block

  auto count_of = [&](int b) {
    const int64_t left = last - (start + static_cast<int64_t>(b) * kBatch);
    return static_cast<int>(left < kBatch ? left : kBatch);
  };
  // batch b's ids into s_ids[b & 1]
  auto issue_ids = [&](int b) {
    if (b >= 0 && tid < count_of(b)) {
      __pipeline_memcpy_async(s_ids + (b & 1) * kBatch + tid,
                              gids + start + static_cast<int64_t>(b) * kBatch +
                                  tid,
                              sizeof(int));
    }
  };
  // batch b's fields into s_fields[b & 1] by the ids in s_ids[b & 1]. The
  // thread of slot j in the first warp copies its Tw (fields 6, 7, 8);
  // project() derives the centre from them once they have landed.
  auto issue_fields = [&](int b) {
    if (b < 0) return;
    const int count = count_of(b);
    float* buf = s_fields + (b & 1) * F;
    const int* ids = s_ids + (b & 1) * kBatch;
    if (tid < count) {
      const float* row = geom + static_cast<int64_t>(ids[tid]) * surfel::kGeom;
#pragma unroll
      for (int k = 6; k < 9; ++k) {
        __pipeline_memcpy_async(buf + tid * RS + k, row + k, sizeof(float));
      }
    }
    // the other ten geometry fields, then the channels
    for (int v = tid; v < (10 + C) * kBatch; v += bs) {
      const int f = v / kBatch;
      const int j = v - f * kBatch;
      if (j >= count) continue;
      const int64_t gid = ids[j];
      const float* src;
      int field;
      if (f < 10) {
        field = f < 6 ? f : f + 3;
        src = geom + gid * surfel::kGeom + field;
      } else {
        field = surfel::kSplat + f - 10;
        src = channels + gid * C + (f - 10);
      }
      __pipeline_memcpy_async(buf + j * RS + field, src, sizeof(float));
    }
  };
  // after this thread's copies of batch b have landed: the projected centre
  // Tw.xy / Tw.z of its slot, with a zero Tw.z replaced by 1
  auto project = [&](int b) {
    if (b >= 0 && tid < count_of(b)) {
      float* rec = s_fields + (b & 1) * F + tid * RS;
      const float twz = surfel::safe_twz(rec[8]);
      rec[13] = rec[6] / twz;
      rec[14] = rec[7] / twz;
    }
  };
  // the warps' partial rows of batch b, added in warp order: one row per
  // sorted position
  auto write_rows = [&](int b) {
    const float* part = s_part + (b & 1) * n_warps * kBatch * R;
    const Mask* mask = s_mask + (b & 1) * n_warps;
    const int64_t base = start + static_cast<int64_t>(b) * kBatch;
    const int count = count_of(b);
    for (int idx = tid; idx < count * R; idx += bs) {
      const int j = idx / R;
      float sum = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp) {
        if ((mask[wp] >> j) & 1u) sum += part[wp * kBatch * R + idx];
      }
      rows[base * R + idx] = sum;
    }
  };

  issue_ids(n_batches - 1);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  issue_fields(n_batches - 1);
  issue_ids(n_batches - 2);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  project(n_batches - 1);
  __syncthreads();

  for (int b = n_batches - 1; b >= 0; --b) {
    // in flight during this batch: the next batch's fields (their ids
    // arrived before the last barrier) and the ids of the one after
    issue_fields(b - 1);
    issue_ids(b - 2);
    __pipeline_commit();
    if (b < n_batches - 1) write_rows(b + 1);

    const int64_t base = start + static_cast<int64_t>(b) * kBatch;
    const int count = count_of(b);
    const float* s_rec = s_fields + (b & 1) * F;
    float* part = s_part + ((b & 1) * n_warps + warp) * kBatch * R;
    Mask warp_mask = 0u;
    for (int j = count - 1; j >= 0; --j) {
      const float* rec = s_rec + j * RS;
      float sg[kLoad];
      load_record(rec, sg);
      const surfel::Terms t = surfel::solve(sg, 1, px, py);
      const bool comp = base + j < stop && t.keep;
      if (!__any_sync(kFullMask, comp)) continue;  // uniform over the warp
      warp_mask |= Mask{1} << j;

      const float a = comp ? t.alpha : 0.0f;
      const float one_minus = 1.0f - a;
      const float t_exc = T / one_minus;
      const float w = a * t_exc;
      const float m = comp ? surfel::map_depth(t.depth) : 0.0f;
      const float wm = w * m;
      const float wm2 = wm * m;
      float cg = 0.0f;
      if constexpr (CT > 0) {
        constexpr int k0 = surfel::kSplat;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          cg += g[c] * (k0 + c < kLoad ? sg[k0 + c < kLoad ? k0 + c : 0]
                                       : rec[k0 + c]);
        }
      } else {
        for (int c = 0; c < C; ++c)
          cg += s_g[c * bs + tid] * rec[surfel::kSplat + c];
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
      const float op = sg[12];
      const float dG = nc ? dalpha * op : 0.0f;
      const float dop = (nc && comp) ? dalpha * t.G : 0.0f;
      const float drho = -0.5f * t.G * dG;
      const float drho3 = t.use3d ? drho : 0.0f;
      const float drho2 = t.use3d ? 0.0f : drho;
      const float dd3 = t.use3d ? ddepth : 0.0f;
      const float du = 2.0f * t.u * drho3 + dd3 * sg[9];
      const float dv = 2.0f * t.v * drho3 + dd3 * sg[10];
      // by reciprocals: six IEEE divisions here cost 1.4 ms (see the note
      // at the top)
      const float icz = 1.0f / t.cz;
      const float ds0 = du * icz;
      const float ds1 = dv * icz;
      const float ds2 = -(du * t.u + dv * t.v) * icz;
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
      const float itwz = 1.0f / surfel::safe_twz(sg[8]);
      const float geo[surfel::kGeom] = {
          -dhx0,
          -dhy0,
          px * dhx0 + py * dhy0,
          -dhx1,
          -dhy1,
          px * dhx1 + py * dhy1,
          -dhx2 + dcxp * itwz,
          -dhy2 + dcyp * itwz,
          px * dhx2 + py * dhy2 -
              (dcxp * sg[6] + dcyp * sg[7]) * (itwz * itwz),
          dd3 * t.u,
          dd3 * t.v,
          ddepth,
          dop};

      float* row = part + j * R;
      constexpr int G = surfel::kGeom;
      if constexpr (CT > 0) {
        constexpr int L = G + CT;
        float v[L];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          v[k] = k < G ? geo[k < G ? k : 0] : w * g[k >= G ? k - G : 0];
        }
        const float sum = gsl::warp_transpose_sum<L>(v, lane);
        if (gsl::transpose_writer<L>(lane)) {
          row[gsl::transpose_index<L>(lane)] = sum;
        }
      } else {
        // chunks of 32 values: the 13 geometry values and the first 19
        // channels, then 32 channels at a time
        for (int k0 = 0; k0 < R; k0 += 32) {
          float v[32];
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int c = k0 + k - G;
            v[k] = c < 0 ? geo[k < G ? k : 0]
                         : (c < C ? w * s_g[c * bs + tid] : 0.0f);
          }
          // 32 values: lane l holds value l
          const float sum = gsl::warp_transpose_sum<32>(v, lane);
          if (k0 + lane < R) row[k0 + lane] = sum;
        }
      }
    }
    if (lane == 0) s_mask[(b & 1) * n_warps + warp] = warp_mask;
    __pipeline_wait_prior(0);
    project(b - 1);
    __syncthreads();
  }
  write_rows(0);
}

template <int CT>
cudaError_t launch(const float* geom, const float* channels, int n_channels,
                   const int* gids, const int64_t* bounds, int n_tiles,
                   int tiles_x, int tile_size, int height, int width,
                   const float* g_out, const float* g_aux, const float* aux,
                   const int* i_stop, float* rows, cudaStream_t stream,
                   int* attributes) {
  const int bs = tile_size * tile_size;
  const size_t smem = smem_words(n_channels, bs, CT == 0) * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_surfels_bwd_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_surfels_bwd_kernel<CT>, bs, smem,
                                  attributes);
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

bool bad_shape(int n_channels, int tile_size) {
  const int bs = tile_size * tile_size;
  return n_channels < 1 || tile_size < 1 || bs > kMaxThreads || bs % 32 != 0;
}


// The largest channel count whose block fits kMaxSharedBytes at this tile
// size (0 for a bad tile size): the wrapper launches the kernel once per
// group of at most that many channels.
int max_group(int tile_size) {
  if (bad_shape(1, tile_size)) return 0;
  const int bs = tile_size * tile_size;
  int c = 0;
  while (smem_words(c + 1, bs, c + 1 > kMaxTemplateC) * sizeof(float) <=
         kMaxSharedBytes) {
    ++c;
  }
  return c;
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most channels one launch takes at this tile size.
int gsl_rasterize_surfels_bwd_max_group(int tile_size) {
  return max_group(tile_size);
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
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(geom, channels, n_channels, gids, bounds, n_tiles, tiles_x,
                  tile_size, height, width, g_out, g_aux, aux, i_stop, rows,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// n_channels and tile_size select.
int gsl_rasterize_surfels_bwd_attributes(int n_channels, int tile_size,
                                         int* out) {
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(nullptr, nullptr, n_channels, nullptr, nullptr, 0, 1,
                  tile_size, 0, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, out);
}

}  // extern "C"
