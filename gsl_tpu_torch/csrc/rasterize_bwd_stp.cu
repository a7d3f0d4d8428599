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
// front, starts each from its checkpoint and runs the forward's rule
// T_exc = T; T *= 1 - a in the forward's order (stp_order.cuh), so T_exc is
// the forward's to the bit. Every term is a product with T_exc, so a slot
// behind the point where T reached 0 gets exactly 0, and no gradient can be
// anything but finite.
//
// What the TPU needed and this does not: log1p/exp closures with window-level
// triangle matmuls, 2 x 15 shifted masked adds per sum, merge flags for
// stream blocks revisited at tile borders, a payload carried through the sort.
//
// Bound on the H100: operations, counted as the function needs them. Pass
// 1 repeats K2s's walk (its T_exc must equal K2s's bit for bit), so it is
// charged what K2s's bound charges: 12 a (pixel, slot) pair, 5 more a pair
// at or below alpha_skip.cuh's cut (past it alpha < 1/255 for certain) and
// 9 + 2C a composited pair. This design runs ~26 on every pair (the
// offsets and sigma 11, the exponential, alpha and its two tests 6, d_p 4,
// the live and in-order tests 3, T *= 1 - a 2): it has no skip cut. A pair
// with a > 0 costs K3's 35 + 4C more (pass 2). A (pixel, window) whose
// live entries are out of order costs
// n_live^2 compares (live_order) and 5 + 2C a live entry to redo T_exc, q
// and S in the pixel's order. The bytes are the forward's, the checkpoints
// (64 per sorted slot), the cotangents and one row per valid slot. Before
// this design the kernel ran at 24x the bound counted then (28 + 2C a
// pair, 360 an out-of-order window), and removing one part at a time
// showed where (NVIDIA H100, 1M Gaussians,
// 1088x1920, C = 3): the 6 + C five-step shuffle sums of each (slot, warp)
// in which a pixel composites cost 4.2 of 8.3 ms, the 120-compare rank
// count run by a whole warp for one out-of-order lane 3.7; the gather sat
// behind two barriers per window; 2 blocks of 256 threads per SM.
// What the design does about each:
//
// - Two passes over a window per thread. Pass 1 evaluates each slot's
//   pair terms once, keeps T_exc (position order) in the thread's own
//   column of shared memory and a 16-bit mask of the live entries (a > 0)
//   in a register, and tests whether the live entries already ascend
//   (stp_order.cuh's still_in_order, the common case). No 16-entry
//   register arrays: the kernel fits 64 registers, four blocks of 256 per SM.
// - A lane whose live entries are out of order ranks only those (n_live^2
//   compares of d_p laid out in its second column; 2.2 live entries per
//   (pixel, window) on average in the bench scene) with stp_order.cuh's
//   live_order, as K2s does, so their relative order, and T_exc, are the
//   forward's to the bit. It then redoes T_exc over the live entries in
//   that order and lays S_after out by position in the second column.
// - Pass 2 visits, back to front, only the slots some pixel of the warp
//   composites (the live masks, __any_sync), evaluates their pair terms again
//   for the gradient, carries S itself where the window was in order, and
//   sums the 6 + C values over the warp with one transposed sum
//   (warp_reduce.cuh): 12 shuffles at C = 3 instead of 45, the warp's row
//   left in 6 + C lanes that store it at once. Its loop is not unrolled:
//   sixteen copies of the body took 1.7 times as long (5.2 ms against 3.0).
// - A slot's fields lie together in shared memory (a record of 9 + C floats
//   padded to 16 bytes), read with three 16-byte loads where the strided
//   layout took nine 4-byte ones: shared-memory instructions, which the
//   shuffles share a pipe with, bounded pass 1.
// - The ids and records of the next window are copied into a second buffer
//   with cp.async (__pipeline_memcpy_async) while this one is computed, the
//   ids two windows ahead. The copies gather by Gaussian id, 4 bytes from
//   arrays of 2, 3 and 1 floats per Gaussian, which TMA's tiled copies do
//   not serve. The warps' partial rows and their masks are double-buffered
//   too, so the cross-warp sum of one window (in warp order, one thread per
//   value of the window's rows) runs during the next one: one __syncthreads
//   per window. The checkpoint row is read one window ahead, coalesced.
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

#include "stp_order.cuh"
#include "warp_reduce.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kMaxTemplateC = 8;
constexpr int kMaxThreads = 1024;  // tile_size <= 32
// the dynamic shared memory a block of the H100 may ask for
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kW = stp::kWindow;
using gsl::kFullMask;

// Where field `field` of Gaussian `g` lies (the order of stp::Field, then
// the C channels).
__device__ __forceinline__ const float* field_address(
    int field, int g, int n_channels, const float* __restrict__ means2d,
    const float* __restrict__ conics, const float* __restrict__ opacities,
    const float* __restrict__ channels, const float* __restrict__ depths,
    const float* __restrict__ depth_grads) {
  switch (field) {
    case stp::kMx: return means2d + 2 * g;
    case stp::kMy: return means2d + 2 * g + 1;
    case stp::kCa: return conics + 3 * g;
    case stp::kCb: return conics + 3 * g + 1;
    case stp::kCc: return conics + 3 * g + 2;
    case stp::kOp: return opacities + g;
    case stp::kDepth: return depths + g;
    case stp::kKzx: return depth_grads + 2 * g;
    case stp::kKzy: return depth_grads + 2 * g + 1;
    default:
      return channels + static_cast<int64_t>(g) * n_channels +
             (field - stp::kFields);
  }
}

// A slot's record in shared memory: its nine fields (stp::Field order), its
// C channels, padded to whole 16-byte loads.
__host__ __device__ __forceinline__ int record_floats(int n_channels) {
  return (stp::kFields + n_channels + 3) & ~3;
}

// The first kLoad values of a record, in three 16-byte loads: the nine
// fields pair_terms reads and the first channels.
constexpr int kLoad = 12;
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
  const int R = 6 + n_channels;
  size_t words = 2 * static_cast<size_t>(record_floats(n_channels)) * kW +
                 2 * static_cast<size_t>(kW) +                 // ids
                 2 * static_cast<size_t>(n_warps) * kW * R +   // partial rows
                 2 * static_cast<size_t>(n_warps) +            // masks
                 2 * static_cast<size_t>(kW) * bs;             // columns
  if (g_shared) words += static_cast<size_t>(n_channels) * bs;
  return words;
}

// CT > 0: the channel count, known at compile time; CT == 0: n_channels.
template <int CT>
__global__ void __launch_bounds__(kMaxThreads) rasterize_bwd_stp_kernel(
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
  extern __shared__ __align__(16) float smem[];
  const int C = CT > 0 ? CT : n_channels;
  const int R = 6 + C;
  const int RS = record_floats(C);
  const int F = kW * RS;  // one buffer of gathered records
  const int bs = blockDim.x;              // tile_size^2, a multiple of 32
  const int n_warps = bs >> 5;
  float* s_fields = smem;                                     // [2][F]
  int* s_ids = reinterpret_cast<int*>(s_fields + 2 * F);      // [2][kW]
  float* s_part = reinterpret_cast<float*>(s_ids + 2 * kW);   // [2][nw][kW][R]
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_part + 2 * n_warps * kW * R);  // [2][nw]
  float* s_texc = reinterpret_cast<float*>(s_mask + 2 * n_warps);  // [kW][bs]
  float* s_after = s_texc + kW * bs;                          // [kW][bs]
  float* s_g = s_after + kW * bs;                   // [C][bs], CT == 0 only

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
  // cg of the slot whose record is `rec`, its first kLoad values in r
  auto channel_dot = [&](const float* rec, const float (&r)[kLoad]) {
    float cg = 0.0f;
    if constexpr (CT > 0) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        constexpr int k0 = stp::kFields;
        cg += g[c] * (k0 + c < kLoad ? r[k0 + c < kLoad ? k0 + c : 0]
                                     : rec[k0 + c]);
      }
    } else {
      for (int c = 0; c < C; ++c)
        cg += s_g[c * bs + tid] * rec[stp::kFields + c];
    }
    return cg;
  };

  const int64_t first = start / kW;
  const int64_t last = (end - 1) / kW;
  // window wd's ids into s_ids[wd & 1]; positions off the tile's range are
  // never read
  auto issue_ids = [&](int64_t wd) {
    const int64_t idx = wd * kW + tid;
    if (wd >= first && tid < kW && idx >= start && idx < end) {
      __pipeline_memcpy_async(s_ids + (wd & 1) * kW + tid, gids + idx,
                              sizeof(int));
    }
  };
  // window wd's records into s_fields[wd & 1] by the ids in s_ids[wd & 1];
  // a slot off the tile's range is zeros: opacity 0, a == 0
  auto issue_fields = [&](int64_t wd) {
    if (wd < first) return;
    float* buf = s_fields + (wd & 1) * F;
    const int* ids = s_ids + (wd & 1) * kW;
    for (int v = tid; v < (stp::kFields + C) * kW; v += bs) {
      const int f = v / kW;
      const int l = v - f * kW;
      const int64_t idx = wd * kW + l;
      float* dst = buf + l * RS + f;
      if (idx >= start && idx < end) {
        __pipeline_memcpy_async(
            dst,
            field_address(f, ids[l], C, means2d, conics, opacities, channels,
                          depths, depth_grads),
            sizeof(float));
      } else {
        *dst = 0.0f;
      }
    }
  };
  // the warps' partial rows of window wd, added in warp order: one row per
  // sorted position of the tile
  auto write_rows = [&](int64_t wd) {
    const float* part = s_part + (wd & 1) * n_warps * kW * R;
    const unsigned* mask = s_mask + (wd & 1) * n_warps;
    for (int idx = tid; idx < kW * R; idx += bs) {
      const int l = idx / R;
      const int64_t pos = wd * kW + l;
      if (pos < start || pos >= end) continue;  // another tile's slot
      float sum = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp) {
        if ((mask[wp] >> l) & 1u) sum += part[wp * kW * R + idx];
      }
      rows[pos * R + (idx - l * R)] = sum;
    }
  };

  issue_ids(last);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  issue_fields(last);
  issue_ids(last - 1);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float t_next = checkpoints[(last + tile) * bs + tid];

  for (int64_t wd = last; wd >= first; --wd) {
    // in flight during this window: the next window's fields (their ids
    // arrived before the last barrier) and the ids of the one after
    issue_fields(wd - 1);
    issue_ids(wd - 2);
    __pipeline_commit();
    const float T0 = t_next;
    if (wd > first) t_next = checkpoints[(wd - 1 + tile) * bs + tid];
    if (wd < last) write_rows(wd + 1);

    const float* sf = s_fields + (wd & 1) * F;
    // pass 1: pair terms once per slot; T_exc in position order into the
    // thread's column, the live mask, the in-order test
    float T = T0;
    float last_d = -INFINITY;
    bool ordered = true;
    unsigned live = 0u;
#pragma unroll
    for (int l = 0; l < kW; ++l) {
      float r[kLoad];
      load_record(sf + l * RS, r);
      const stp::Pair p = stp::pair_terms(r, 1, 0, px, py);
      const bool lv = p.a > 0.0f;
      if (lv) ordered = stp::still_in_order(ordered, p.d, last_d);
      live |= lv ? 1u << l : 0u;
      texc_column[l * bs] = T;
      T *= 1.0f - p.a;
    }
    if (!ordered) {
      // a and d_p of the live entries into the two columns
      for (unsigned m = live; m != 0u; m &= m - 1u) {
        const int i = __ffs(m) - 1;
        float r[kLoad];
        load_record(sf + i * RS, r);
        const stp::Pair p = stp::pair_terms(r, 1, 0, px, py);
        texc_column[i * bs] = p.a;
        after_column[i * bs] = p.d;
      }
      // the live entries in this pixel's order (stp_order.cuh's pairwise
      // rule among them alone); rank r's position in bits [4r, 4r + 4)
      int n_live;
      const uint64_t order = stp::live_order(
          live, [&](int i) { return after_column[i * bs]; }, n_live);
      // T_exc by the forward's rule in that order, q by position, then
      // S_after by position from the back of the order
      float Tr = T0;
      for (int k = 0; k < n_live; ++k) {
        const int l = static_cast<int>((order >> (4 * k)) & 15u);
        const float a = texc_column[l * bs];
        float r[kLoad];
        load_record(sf + l * RS, r);
        texc_column[l * bs] = Tr;
        after_column[l * bs] = a * Tr * channel_dot(sf + l * RS, r);
        Tr *= 1.0f - a;
      }
      for (int r = n_live - 1; r >= 0; --r) {
        const int l = static_cast<int>((order >> (4 * r)) & 15u);
        const float q = after_column[l * bs];
        after_column[l * bs] = S;
        S += q;
      }
    }

    // pass 2, back to front: the slots some pixel of the warp composites
    // (not unrolled, see the note at the top)
    unsigned warp_mask = 0u;
    float* part = s_part + ((wd & 1) * n_warps + warp) * kW * R;
#pragma unroll 1
    for (int l = kW - 1; l >= 0; --l) {
      const bool comp = (live >> l) & 1u;
      if (!__any_sync(kFullMask, comp)) continue;  // uniform over the warp
      warp_mask |= 1u << l;

      const float* rec = sf + l * RS;
      float r[kLoad];
      load_record(rec, r);
      const stp::Pair p = stp::pair_terms(r, 1, 0, px, py);
      const float ca = r[stp::kCa];
      const float cb = r[stp::kCb];
      const float cc = r[stp::kCc];
      const float t_exc = texc_column[l * bs];
      const float cg = channel_dot(rec, r);
      float s_behind;
      if (ordered) {  // position order is the pixel's: carry S here
        s_behind = S;
        S += p.a * t_exc * cg;
      } else {
        s_behind = after_column[l * bs];
      }
      const float dalpha =
          comp ? t_exc * cg - s_behind / fmaxf(1.0f - p.a, min_one_minus)
               : 0.0f;
      const float w = p.a * t_exc;
      const bool unclamped = p.raw < max_alpha;
      const float dsigma = unclamped ? -p.a * dalpha : 0.0f;
      const float dop = (unclamped && comp) ? dalpha * p.e : 0.0f;
      const float gx = ca * p.dx + cb * p.dy;
      const float gy = cc * p.dy + cb * p.dx;
      const float geo[6] = {dsigma * gx,
                            dsigma * gy,
                            dsigma * 0.5f * p.dx * p.dx,
                            dsigma * p.dx * p.dy,
                            dsigma * 0.5f * p.dy * p.dy,
                            dop};
      float* row = part + l * R;
      if constexpr (CT > 0) {
        constexpr int L = 6 + CT;
        float v[L];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          v[k] = k < 6 ? geo[k < 6 ? k : 0] : w * g[k >= 6 ? k - 6 : 0];
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
            const int c = k0 + k - 6;
            v[k] = c < 0 ? geo[k < 6 ? k : 0]
                         : (c < C ? w * s_g[c * bs + tid] : 0.0f);
          }
          // 32 values: lane l holds value l
          const float sum = gsl::warp_transpose_sum<32>(v, lane);
          if (k0 + lane < R) row[k0 + lane] = sum;
        }
      }
    }
    if (lane == 0) s_mask[(wd & 1) * n_warps + warp] = warp_mask;
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  write_rows(first);
}

template <int CT>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   const float* depths, const float* depth_grads,
                   int n_channels, const int* gids, const int64_t* bounds,
                   int n_tiles, int tiles_x, int tile_size, int height,
                   int width, const float* g_out, const float* g_alpha,
                   const float* t_final, const float* checkpoints,
                   float* rows, cudaStream_t stream, int* attributes) {
  const int bs = tile_size * tile_size;
  const size_t smem = smem_words(n_channels, bs, CT == 0) * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_stp_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_bwd_stp_kernel<CT>, bs, smem,
                                  attributes);
  }
  rasterize_bwd_stp_kernel<CT><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,
      gids, bounds, tiles_x, tile_size, height, width, g_out, g_alpha,
      t_final, checkpoints, rows);
  return cudaGetLastError();
}

int dispatch(const float* means2d, const float* conics,
             const float* opacities, const float* channels,
             const float* depths, const float* depth_grads, int n_channels,
             const int* gids, const int64_t* bounds, int n_tiles, int tiles_x,
             int tile_size, int height, int width, const float* g_out,
             const float* g_alpha, const float* t_final,
             const float* checkpoints, float* rows, cudaStream_t s,
             int* attributes) {
#define GSL_LAUNCH(CT)                                                        \
  return static_cast<int>(launch<CT>(                                         \
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,  \
      gids, bounds, n_tiles, tiles_x, tile_size, height, width, g_out,        \
      g_alpha, t_final, checkpoints, rows, s, attributes))
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
int gsl_rasterize_bwd_stp_max_group(int tile_size) {
  return max_group(tile_size);
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
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(means2d, conics, opacities, channels, depths, depth_grads,
                  n_channels, gids, bounds, n_tiles, tiles_x, tile_size,
                  height, width, g_out, g_alpha, t_final, checkpoints, rows,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// n_channels and tile_size select.
int gsl_rasterize_bwd_stp_attributes(int n_channels, int tile_size,
                                     int* out) {
  if (bad_shape(n_channels, tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  n_channels, nullptr, nullptr, 0, 1, tile_size, 0, 0,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, out);
}

}  // extern "C"
