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
// The forward stops before T reaches 1e-4, so T_final > 0 and T_exc is
// rebuilt by division, as the TPU kernel's suffix products are.
//
// What the TPU needed and this does not: the suffix products closed with
// log1p/exp and triangle matmuls, stream blocks revisited at tile borders
// with merge flags, and a payload sorted along with the keys. Here one block
// of tile_size^2 threads owns one tile, one thread one pixel, and walks the
// tile's range of sorted ids backwards from the largest stop of its pixels,
// in batches of kBatch slots.
//
// Bound on the H100: operations. Deciding whether a visited (pixel, splat)
// pair was composited costs 18 operations (delta 2, sigma 9, negate and exp
// 2, alpha 2, three compares). A composited pair costs 35 + 4C more: 1 - a
// and T_exc 2, cg 2C, dalpha 4, weight and S 3, dsigma and dop 3, the conic
// products 6, the six geometry terms 11, the C channel terms C, and its
// share of the pixel sums, 6 + C adds. The bytes are those of the forward
// plus one row per sorted slot.
//
// Before this design the kernel ran at 11.4x that bound (2.27 ms; NVIDIA
// H100 80GB HBM3 at 700 W, 1M Gaussians, 1088x1920, C = 3). Removing one
// part at a time from a copy (scripts/torch_kernel_parts.py) showed where:
// the 6 + C five-step shuffle sums of each (slot, warp) in which a pixel
// composites cost 0.90 ms, the gather and the barriers around it 0.14, the
// cross-warp sum behind a third barrier 0.07, the shared-memory atomic for
// the last stop nothing measurable. In this design the composite test of
// the 534 M visited (pixel, slot) pairs takes about 1.0 ms, as the forward
// (K2) does over the same pairs, and the gradient about 0.9: it runs for
// the whole warp in each of the 7.0 M (slot, warp)s where 11 of 32 pixels
// composite on average. What the design does:
//
// - The 6 + C values of a (slot, warp) are summed with one transposed sum
//   (warp_reduce.cuh): 12 shuffles at C = 3 instead of 45, the warp's row
//   left in 6 + C lanes that store it at once.
// - T / (1 - a) and S / max(1 - a, 1e-3) are approximate divisions
//   (__fdividef, within 2 ulp for a divisor in [1e-3, 1]): the IEEE
//   quotient's range check and branch cost 0.17 ms more.
// - A slot's fields lie together in shared memory (a record of 6 + C
//   floats padded to 16 bytes), read with 16-byte loads.
// - The ids and records of the next batch are copied into a second buffer
//   with cp.async (__pipeline_memcpy_async) while this one is computed, the
//   ids two batches ahead. The copies gather by Gaussian id, 4 bytes from
//   arrays of 2, 3, 1 and C floats per Gaussian, which TMA's tiled copies do
//   not serve. The warps' partial rows and their masks are double-buffered,
//   so the cross-warp sum of one batch (in warp order) runs during the next:
//   one __syncthreads per batch of 64 slots, where there were three
//   (batches of 32 cost 0.07 ms more).
// - The tile's last stop is the largest over each warp (__reduce_max_sync),
//   then over the warps: no atomic.
// - Positions are int64 throughout.
// - At most 64 registers, so four blocks of 256 threads fit an SM.
// - The tensor cores play no part: there is no matrix product, and TF32
//   sums would not hold the rows to their tolerances.
//
// No atomics: the order of every addition is fixed, the same rows in every
// run.
// C <= 8 is a template parameter (cotangents in registers), larger C keeps
// the cotangents in shared memory and sums the row in chunks of 32 values.
// A launch takes at most max_group(tile_size) channels, the most whose
// block fits the 227 KiB of shared memory (the partial rows grow with C);
// the wrapper launches wider C once per group of channels and adds the
// groups' geometry columns (ops/rasterize.py, backward_by_channel_groups).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "warp_reduce.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kBatch = 64;
// one bit per slot of a batch
using Mask = std::conditional_t<(kBatch > 32), unsigned long long, unsigned>;
constexpr int kFields = 6;  // mean x, mean y, conic a, b, c, opacity
constexpr int kMaxTemplateC = 8;
constexpr int kMaxThreads = 1024;  // tile_size <= 32
// the dynamic shared memory a block of the H100 may ask for
constexpr size_t kMaxSharedBytes = 227 * 1024;
using gsl::kFullMask;

// A slot's record in shared memory: its six fields, its C channels, padded
// to whole 16-byte loads.
__host__ __device__ __forceinline__ int record_floats(int n_channels) {
  return (kFields + n_channels + 3) & ~3;
}

// The values of a record that a visited pair reads, in 16-byte loads: the
// whole record where C is known at compile time, else the six fields and
// the first two channels.
template <int CT>
__host__ __device__ constexpr int load_floats() {
  return CT > 0 ? (kFields + CT + 3) & ~3 : 8;
}

template <int N>
__device__ __forceinline__ void load_record(const float* rec, float (&r)[N]) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = r4[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

size_t smem_words(int n_channels, int bs, bool g_shared) {
  const int n_warps = bs / 32;
  const int R = kFields + n_channels;
  size_t words = 2 * static_cast<size_t>(record_floats(n_channels)) * kBatch +
                 2 * static_cast<size_t>(kBatch) +                // ids
                 2 * static_cast<size_t>(n_warps) * kBatch * R +  // rows
                 2 * static_cast<size_t>(n_warps) * sizeof(Mask) / 4 +
                                                                  // masks
                 static_cast<size_t>(n_warps);             // the warps' stops
  if (g_shared) words += static_cast<size_t>(n_channels) * bs;
  return words;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void __launch_bounds__(kMaxThreads) rasterize_bwd_kernel(
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
  extern __shared__ __align__(16) float smem[];
  const int C = CT > 0 ? CT : n_channels;
  const int R = kFields + C;
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
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  const float min_one_minus = static_cast<float>(1e-3);

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  const int64_t pix = static_cast<int64_t>(y) * width + x;

  float T = 1.0f;
  float S = 0.0f;
  int64_t stop = 0;  // a pixel outside the image composited nothing
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

  // nothing at or behind the largest stop of the tile's pixels was
  // composited: the largest over each warp, then over the warps (positions
  // lie below 2^30, see ops/rasterize.py)
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
  // batch b's records into s_fields[b & 1] by the ids in s_ids[b & 1]
  auto issue_fields = [&](int b) {
    if (b < 0) return;
    const int count = count_of(b);
    float* buf = s_fields + (b & 1) * F;
    const int* ids = s_ids + (b & 1) * kBatch;
    for (int v = tid; v < R * kBatch; v += bs) {
      const int f = v / kBatch;
      const int j = v - f * kBatch;
      if (j >= count) continue;
      const int64_t gid = ids[j];
      const float* src;
      if (f < 2) {
        src = means2d + 2 * gid + f;
      } else if (f < 5) {
        src = conics + 3 * gid + (f - 2);
      } else if (f == 5) {
        src = opacities + gid;
      } else {
        src = channels + gid * C + (f - kFields);
      }
      __pipeline_memcpy_async(buf + j * RS + f, src, sizeof(float));
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
  __syncthreads();

  constexpr int kLoad = load_floats<CT>();
  for (int b = n_batches - 1; b >= 0; --b) {
    // in flight during this batch: the next batch's records (their ids
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
      float r[kLoad];
      load_record(rec, r);
      const float ca = r[2], cb = r[3], cc = r[4];
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float e = expf(-sigma);
      const float raw = r[5] * e;
      const float alpha = fminf(max_alpha, raw);
      const bool comp =
          base + j < stop && !(sigma < 0.0f) && !(alpha < threshold);
      if (!__any_sync(kFullMask, comp)) continue;  // uniform over the warp
      warp_mask |= Mask{1} << j;

      const float a = comp ? alpha : 0.0f;
      const float one_minus = 1.0f - a;
      // 1 - a lies in [1e-3, 1], where __fdividef is within 2 ulp of the
      // IEEE quotient, which costs a range check and a branch
      const float t_exc = __fdividef(T, one_minus);
      float cg = 0.0f;
      if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) cg += g[c] * r[kFields + c];
      } else {
        for (int c = 0; c < C; ++c)
          cg += s_g[c * bs + tid] * rec[kFields + c];
      }
      const float dalpha =
          comp ? t_exc * cg - __fdividef(S, fmaxf(one_minus, min_one_minus))
               : 0.0f;
      const float w = a * t_exc;
      S += w * cg;
      T = t_exc;
      const bool unclamped = raw < max_alpha;
      const float dsigma = unclamped ? -a * dalpha : 0.0f;
      const float dop = (unclamped && comp) ? dalpha * e : 0.0f;
      const float gx = ca * dx + cb * dy;
      const float gy = cc * dy + cb * dx;
      const float geo[kFields] = {dsigma * gx,
                                  dsigma * gy,
                                  dsigma * 0.5f * dx * dx,
                                  dsigma * dx * dy,
                                  dsigma * 0.5f * dy * dy,
                                  dop};

      float* row = part + j * R;
      if constexpr (CT > 0) {
        constexpr int L = kFields + CT;
        float v[L];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          v[k] = k < kFields ? geo[k < kFields ? k : 0]
                             : w * g[k >= kFields ? k - kFields : 0];
        }
        const float sum = gsl::warp_transpose_sum<L>(v, lane);
        if (gsl::transpose_writer<L>(lane)) {
          row[gsl::transpose_index<L>(lane)] = sum;
        }
      } else {
        // chunks of 32 values: the six geometry values and the first 26
        // channels, then 32 channels at a time
        for (int k0 = 0; k0 < R; k0 += 32) {
          float v[32];
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int c = k0 + k - kFields;
            v[k] = c < 0 ? geo[k < kFields ? k : 0]
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
    __syncthreads();
  }
  write_rows(0);
}

template <int CT>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   int n_channels, const int* gids, const int64_t* bounds,
                   int n_tiles, int tiles_x, int tile_size, int height,
                   int width, const float* g_out, const float* g_alpha,
                   const float* t_final, const int* i_stop, float* rows,
                   cudaStream_t stream, int* attributes) {
  const int bs = tile_size * tile_size;
  const size_t smem = smem_words(n_channels, bs, CT == 0) * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_bwd_kernel<CT>, bs, smem,
                                  attributes);
  }
  rasterize_bwd_kernel<CT><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, n_channels, gids, bounds, tiles_x,
      tile_size, height, width, g_out, g_alpha, t_final, i_stop, rows);
  return cudaGetLastError();
}

int dispatch(const float* means2d, const float* conics,
             const float* opacities, const float* channels, int n_channels,
             const int* gids, const int64_t* bounds, int n_tiles, int tiles_x,
             int tile_size, int height, int width, const float* g_out,
             const float* g_alpha, const float* t_final, const int* i_stop,
             float* rows, cudaStream_t s, int* attributes) {
#define GSL_LAUNCH(CT)                                                        \
  return static_cast<int>(launch<CT>(                                         \
      means2d, conics, opacities, channels, n_channels, gids, bounds,         \
      n_tiles, tiles_x, tile_size, height, width, g_out, g_alpha, t_final,    \
      i_stop, rows, s, attributes))
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
int gsl_rasterize_bwd_max_group(int tile_size) {
  return max_group(tile_size);
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
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(means2d, conics, opacities, channels, n_channels, gids,
                  bounds, n_tiles, tiles_x, tile_size, height, width, g_out,
                  g_alpha, t_final, i_stop, rows,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// n_channels and tile_size select.
int gsl_rasterize_bwd_attributes(int n_channels, int tile_size, int* out) {
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(nullptr, nullptr, nullptr, nullptr, n_channels, nullptr,
                  nullptr, 0, 1, tile_size, 0, 0, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, out);
}

}  // extern "C"
