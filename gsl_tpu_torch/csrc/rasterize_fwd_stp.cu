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
// the sort (which capped the channels at 3). Here one block owns one tile,
// and each pixel walks the tile's windows in order. In a window it
// composites every entry with a > 0 in place, w = a T; T *= 1 - a, and
// tests on the way whether those entries already stand in its order
// (stp_order.cuh's in-order rule, the common case). If they do not, it
// takes the window again from T and the sums it started with: it ranks the
// live entries alone by the pairwise rule, runs T_exc = T; T *= 1 - a in
// that order, and adds the channels in position order. An entry with a = 0
// multiplies T by exactly 1 wherever it stands, so T and the weights are
// those of a rank over all 16 entries, to the bit.
//
// With `checkpoints` the kernel also leaves T at the start of every window,
// row (position / 16 + tile) of [rows, tile_size^2]: the backward (K3s)
// starts each window from it instead of dividing T_final, which is 0 where
// a dense tile saturates.
//
// Bound on the H100: operations, counted as this design needs them. Every
// (pixel, slot) pair costs 12: delta 2, sigma 9, the compare with the
// slot's cut. A pair at or below the cut costs 5 more (negate and exp 2,
// alpha 2, the compare with 1/255), a pair with a > 0 another 9 + 2C (d_p
// 4, the order test 2, weight, 1 - a, T, C multiply-adds), and a (pixel,
// window) whose live entries are out of order n_live^2 compares to rank
// them. With no stop the pairs are 256 x the valid slots. The bytes are
// K2's plus 12 per Gaussian (depth, slopes), and 64 per sorted slot with
// checkpoints.
//
// Before this design the kernel ran at 6.7x that bound (1.400 ms launched
// with checkpoints; NVIDIA H100 80GB HBM3 at 700 W, 1M Gaussians,
// 1088x1920, C = 3): each window's 16 alphas and depths lay in register
// arrays (72 registers, 3 blocks of 256 per SM), an out-of-order pixel
// ranked all 16 entries (120 compares; 0.36 ms) and walked a 16-entry
// column in shared memory, a warp ran that path whenever one of its lanes
// needed it (34% of the (window, warp)s; 0.47 ms in all), and a pair read
// nine strided 4-byte shared loads. What the design does (much of it the
// machinery of K3s, rasterize_bwd_stp.cu):
//
// - No 16-entry register arrays: one pass over a window keeps the live
//   mask, the order test and, for the live entries, (d_p, a) in the
//   thread's own column of shared memory.
// - An out-of-order pixel ranks only its live entries (n_live^2 compares;
//   3.9 live entries per out-of-order (pixel, window) at the bench scene)
//   from the column, and evaluates no pair terms again.
// - Each slot carries the sigma beyond which its alpha is below 1/255 for
//   certain (alpha_skip.cuh); an entry that no pixel of the warp can keep is
//   passed at its sigma, without the exponential, d_p or the order test.
// - One pixel a thread; two a thread need more registers and leave half
//   the warps to hide the latency, and were slower.
// - A slot's fields lie together in shared memory (a record of 10 + C floats
//   padded to 16 bytes), read with three 16-byte loads.
// - The ids and records of the next batch of kBatch slots (whole windows)
//   are copied into a second buffer with cp.async while this one is
//   composited, the ids two batches ahead: one __syncthreads per batch
//   (tile_batches.cuh).
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels and the caller launches once per group; every launch
// orders the windows and computes T again.
#include <cstdint>
#include <cuda_runtime.h>

#include "alpha_skip.cuh"
#include "stp_order.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kW = stp::kWindow;
constexpr int kBatch = 64;  // a multiple of kW
constexpr int kNeverStopped = 1 << 30;
// a record: the nine fields of stp::Field, the skip sigma (alpha_skip.cuh),
// then the channels
constexpr int kSkip = stp::kFields;
constexpr int kChannel0 = stp::kFields + 1;

// Where field `field` of Gaussian `g` lies (the order of stp::Field, then
// the channels from c0 on).
__device__ __forceinline__ const float* field_address(
    int field, int64_t g, int n_channels, int c0,
    const float* __restrict__ means2d, const float* __restrict__ conics,
    const float* __restrict__ opacities, const float* __restrict__ channels,
    const float* __restrict__ depths, const float* __restrict__ depth_grads) {
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
    default: return channels + g * n_channels + c0 + (field - stp::kFields);
  }
}

// A slot's record in shared memory: its nine fields (stp::Field order), its
// skip sigma, its CG channels, padded to whole 16-byte loads. A pair reads
// the first kLoad values (the nine fields, the skip sigma and the first two
// channels) with three 16-byte loads.
__host__ __device__ constexpr int record_floats(int cg) {
  return gsl::record_floats(kChannel0 + cg);
}
constexpr int kLoad = 12;

size_t smem_words(int cg, int bs) {
  return 2 * static_cast<size_t>(record_floats(cg)) * kBatch +  // records
         2 * static_cast<size_t>(kBatch) +                      // ids
         2 * static_cast<size_t>(kW) * bs;                      // columns
}

// one pixel a thread: blockDim.x == tile_size^2
template <int CG>
__global__ void __launch_bounds__(1024) rasterize_fwd_stp_kernel(
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
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = record_floats(CG);
  constexpr int F = kBatch * RS;  // one buffer of gathered records
  float* s_fields = smem;                                    // [2][F]
  int* s_ids = reinterpret_cast<int*>(s_fields + 2 * F);     // [2][kBatch]
  // [kW][bs]: the pixel's (d_p, a) of each live entry of the window, and
  // where the window is out of order each live entry's weight a T_exc in
  // place of a
  float2* s_column = reinterpret_cast<float2*>(s_ids + 2 * kBatch);
  const int bs = tile_size * tile_size;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;  // the tile's pixel
  const int x = (tile % tiles_x) * tile_size + tid % tile_size;
  const int y = (tile / tiles_x) * tile_size + tid / tile_size;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  float T = 1.0f;
  float acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = 0.0f;

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  const int64_t first = start / kW;  // windows [first, last]
  const int64_t last = (end - 1) / kW;
  constexpr int kWindows = kBatch / kW;  // windows a batch
  const int n_batches =
      end > start ? static_cast<int>((last - first) / kWindows + 1) : 0;
  // batch b: the positions [(first + b kWindows) kW, + kBatch), of which
  // those in [start, end) are the tile's; the others are zeros (opacity 0,
  // a == 0) and cut everywhere
  auto batch = [&](int b) {
    const int64_t base = (first + static_cast<int64_t>(b) * kWindows) * kW;
    const int64_t lo = start - base, hi = end - base;
    return gsl::Batch{base, static_cast<int>(lo > 0 ? lo : 0),
                      static_cast<int>(hi < kBatch ? hi : kBatch)};
  };
  auto issue_ids = [&](int b) {
    gsl::issue_ids(s_ids + (b & 1) * kBatch, gids, batch(b));
  };
  // the fields but the opacity, then the group's channels, by the ids in
  // s_ids[b & 1]; the opacity by the slot's own thread, which derives the
  // cut from it
  auto issue_records = [&](int b) {
    float* buf = s_fields + (b & 1) * F;
    const int* ids = s_ids + (b & 1) * kBatch;
    auto field = [](int i) { return i < stp::kOp ? i : i + 1; };
    gsl::issue_values<kBatch>(
        buf, RS, ids, batch(b), stp::kFields - 1 + CG,
        [&](int i) {
          const int f = field(i);
          return f < stp::kFields ? f : f + 1;
        },
        [&](int i, int64_t g) {
          return field_address(field(i), g, n_channels, c0, means2d, conics,
                               opacities, channels, depths, depth_grads);
        });
    gsl::issue_own<kBatch>(buf, RS, ids, batch(b), stp::kOp,
                           [&](int64_t g) { return opacities + g; });
  };
  auto derive = [&](int b) {
    gsl::skip_sigmas<kBatch>(s_fields + (b & 1) * F, RS, batch(b), stp::kOp,
                             kSkip);
  };
  // channel c of the record rec whose first kLoad values are r
  auto channel = [&](const float (&r)[kLoad], const float* rec, int c) {
    return kChannel0 + c < kLoad ? r[kChannel0 + c < kLoad ? kChannel0 + c : 0]
                                 : rec[kChannel0 + c];
  };

  gsl::walk_batches(n_batches, issue_ids, issue_records, derive, [&](int b) {
    const float* s_rec = s_fields + (b & 1) * F;
    const int64_t wd0 = first + static_cast<int64_t>(b) * kWindows;
    const int n_windows = static_cast<int>(
        last - wd0 + 1 < kWindows ? last - wd0 + 1 : kWindows);
    for (int w = 0; w < n_windows; ++w) {
      const float* s_win = s_rec + w * kW * RS;
      if (checkpoints != nullptr) {
        checkpoints[(wd0 + w + tile) * bs + tid] = T;
      }
      const float T0 = T;
      float acc0[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) acc0[c] = acc[c];
      unsigned live = 0u;
      bool ordered = true;
      float last_d = -INFINITY;
      // every entry once: composited in position order, which is the
      // pixel's order unless the test below says otherwise; an entry beyond
      // its cut is passed at its sigma (a == 0 for certain), and a branch
      // that every lane of a warp takes costs the warp nothing more
#pragma unroll
      for (int l = 0; l < kW; ++l) {
        const float* rec = s_win + l * RS;
        float r[kLoad];
        gsl::load_record(rec, r);
        const float dx = r[stp::kMx] - px;
        const float dy = r[stp::kMy] - py;
        const float sigma = stp::sigma_of(r, 1, 0, dx, dy);
        if (sigma > r[kSkip]) continue;
        const stp::Pair q = stp::pair_terms_at(r, 1, 0, dx, dy, sigma);
        if (!(q.a > 0.0f)) continue;
        ordered = stp::still_in_order(ordered, q.d, last_d);
        live |= 1u << l;
        s_column[l * bs + tid] = make_float2(q.d, q.a);
        const float wgt = q.a * T;
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] += wgt * channel(r, rec, c);
        T *= 1.0f - q.a;
      }
      if (ordered) continue;
      // out of order: the window again from T0 and acc0, in the pixel's
      // order of its live entries
      float2* column = s_column + tid;
      int n_live;
      const uint64_t order = stp::live_order(
          live, [&](int i) { return column[i * bs].x; }, n_live);
      float t = T0;
      for (int r = 0; r < n_live; ++r) {
        const int l = static_cast<int>((order >> (4 * r)) & 15u);
        const float a = column[l * bs].y;
        column[l * bs].y = a * t;
        t *= 1.0f - a;
      }
      T = t;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] = acc0[c];
      for (unsigned m = live; m != 0u; m &= m - 1u) {
        const int l = __ffs(m) - 1;
        const float wgt = column[l * bs].y;
        const float* rec = s_win + l * RS;
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] += wgt * rec[kChannel0 + c];
      }
    }
  });
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
                   cudaStream_t stream, int* attributes) {
  const int bs = tile_size * tile_size;
  const size_t smem = smem_words(CG, bs) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_fwd_stp_kernel<CG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_fwd_stp_kernel<CG>, bs, smem,
                                  attributes);
  }
  rasterize_fwd_stp_kernel<CG><<<n_tiles, bs, smem, stream>>>(
      means2d, conics, opacities, channels, depths, depth_grads, n_channels,
      c0, gids, bounds, tiles_x, tile_size, height, width, out, t_final,
      i_stop, checkpoints);
  return cudaGetLastError();
}

int dispatch(const float* means2d, const float* conics,
             const float* opacities, const float* channels,
             const float* depths, const float* depth_grads, int n_channels,
             int c0, int cg, const int* gids, const int64_t* bounds,
             int n_tiles, int tiles_x, int tile_size, int height, int width,
             float* out, float* t_final, int* i_stop, float* checkpoints,
             cudaStream_t s, int* attributes) {
  return static_cast<int>(gsl::for_group(cg, [&](auto group) {
    return launch<decltype(group)::value>(
        means2d, conics, opacities, channels, depths, depth_grads,
        n_channels, c0, gids, bounds, n_tiles, tiles_x, tile_size, height,
        width, out, t_final, i_stop, checkpoints, s, attributes);
  }));
}

// one pixel a thread in whole warps, as the wrapper asks
bool bad_tile(int tile_size) {
  const int bs = tile_size * tile_size;
  return tile_size < 1 || bs > 1024 || bs % 32 != 0;
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_rasterize_fwd_stp_max_group() { return gsl::kMaxGroup; }

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
  if (cg < 1 || cg > gsl::kMaxGroup || c0 < 0 || c0 + cg > n_channels ||
      bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(means2d, conics, opacities, channels, depths, depth_grads,
                  n_channels, c0, cg, gids, bounds, n_tiles, tiles_x,
                  tile_size, height, width, out, t_final, i_stop,
                  checkpoints, static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// composites min(n_channels, kMaxGroup) channels at tile_size.
int gsl_rasterize_fwd_stp_attributes(int n_channels, int tile_size,
                                     int* out) {
  if (n_channels < 1 || bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = n_channels < gsl::kMaxGroup ? n_channels : gsl::kMaxGroup;
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  n_channels, 0, cg, nullptr, nullptr, 0, 1, tile_size, 0, 0,
                  nullptr, nullptr, nullptr, nullptr, nullptr, out);
}

}  // extern "C"
