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
// Here one block owns one tile and walks the tile's range of the sorted
// Gaussian ids in batches; every pixel composites the batch in order,
// sequentially, as the oracle does.
//
// Bound on the H100: operations, counted as this design needs them. Every
// (pixel, splat) pair a pixel visits costs 12 f32 operations (delta 2,
// sigma 9, the compare with the splat's cut), a pair at or below the cut 5
// more (negate and exp 2, alpha 2, the compare with 1/255), a composited
// pair 3 + 2C more (1 - a, T, the weight, C multiply-adds); at the bench
// scene that is ~7 10^9 operations against ~10^8 bytes of inputs and
// outputs.
//
// The per-pair arithmetic is K3's composite test (rasterize_bwd.cu), the
// same expressions in the same order: K3 decides which pairs were
// composited by computing them again, and rebuilds T by dividing T_final.
//
// Before this design the kernel ran at 6.3x that bound (0.920 ms launched;
// NVIDIA H100 80GB HBM3 at 700 W, 1M Gaussians, 1088x1920, C = 3). Removing
// one part at a time from a copy (scripts/torch_kernel_parts.py) showed an
// instruction-bound walk: its alpha test alone took 0.58 ms, six strided
// 4-byte shared loads a pair 0.18, the gather, its barriers and the exits
// nothing measurable. What the design does:
//
// - Each slot carries the sigma beyond which its alpha is below 1/255 for
//   certain (alpha_skip.cuh, computed once per batch from its opacity). A
//   pair past that cut is passed without the exponential; a branch that
//   every lane of a warp takes costs the warp nothing more, and a splat a
//   few pixels wide misses most of a tile's warps. Only the pairs at or
//   below the cut take the exact test, so every decision is the one K3
//   repeats.
// - kPix pixels a thread (pixel p and p + blockDim.x of the tile): one
//   record read and one turn of the loop serve kPix pairs, whose chains are
//   independent. Each thread walks the batch until its pixels have
//   stopped, as the oracle does; no warp vote.
// - A slot's fields lie together in shared memory (mean, conic, opacity,
//   skip sigma, the channel group: a record padded to 16 bytes); a pair
//   reads the first eight values with two 16-byte loads.
// - The ids and records of the next batch are copied into a second buffer
//   with cp.async while this one is composited, the ids two batches ahead
//   (tile_batches.cuh).
// - One barrier per batch of kBatch slots, and it is the block's exit test
//   (__syncthreads_count): it frees the batch's buffer, publishes the next
//   one and lets the block leave once every pixel has stopped.
// - At most kMaxRegs registers; the tensor cores play no part: there is no
//   matrix product.
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels (a template parameter, so the sums stay in registers)
// and the caller launches once per group. Every launch recomputes the same
// T and stop index. Any tile size up to 32 works: the block has kPix pixels
// a thread in whole warps, and threads past the tile's pixels idle.
#include <cstdint>
#include <cuda_runtime.h>

#include "alpha_skip.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kBatch = 64;
constexpr int kPix = 2;
constexpr int kMaxRegs = 64;
constexpr int kMaxThreads = 1024 / kPix;  // tile_size <= 32
// mean x, y, conic a, b, c, opacity, and the sigma beyond which the pair is
// skipped for certain (alpha_skip.cuh); then the group's channels
constexpr int kFields = 7;
constexpr int kOp = 5;
constexpr int kSkip = 6;
constexpr int kNeverStopped = 1 << 30;

// A slot's record in shared memory: its seven fields, its CG channels,
// padded to whole 16-byte loads. A pair reads the first kLoad values (the
// seven fields and the first channel) with two 16-byte loads.
__host__ __device__ constexpr int record_floats(int cg) {
  return gsl::record_floats(kFields + cg);
}
constexpr int kLoad = 8;

// Threads of a block: kPix pixels each, whole warps.
int block_threads(int tile_size) {
  const int per = (tile_size * tile_size + kPix - 1) / kPix;
  return (per + 31) & ~31;
}

size_t smem_words(int cg) {
  return 2 * static_cast<size_t>(record_floats(cg)) * kBatch +  // records
         2 * static_cast<size_t>(kBatch);                       // ids
}

template <int CG>
__global__ void __launch_bounds__(kMaxThreads,
                                  65536 / (kMaxThreads * kMaxRegs))
    rasterize_fwd_kernel(
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
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = record_floats(CG);
  constexpr int F = kBatch * RS;  // one buffer of gathered records
  float* s_fields = smem;                                  // [2][F]
  int* s_ids = reinterpret_cast<int*>(s_fields + 2 * F);   // [2][kBatch]
  const int nt = blockDim.x;
  const int bs = tile_size * tile_size;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float max_alpha = static_cast<float>(0.999);
  const float min_t = static_cast<float>(1e-4);

  // pixel k of this thread is the tile's pixel tid + k * nt; it is done
  // once its stop is set (a pixel outside the image is done from the
  // start, with stop -1, and writes nothing)
  float px[kPix], py[kPix], T[kPix], acc[kPix][CG];
  int stop[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = tid + k * nt;
    const int x = (tile % tiles_x) * tile_size + p % tile_size;
    const int y = (tile / tiles_x) * tile_size + p / tile_size;
    px[k] = static_cast<float>(x) + 0.5f;
    py[k] = static_cast<float>(y) + 0.5f;
    stop[k] = p < bs && x < width && y < height ? kNeverStopped : -1;
    T[k] = 1.0f;
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[k][c] = 0.0f;
  }
  auto all_done = [&]() {
    bool d = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) d = d && stop[k] != kNeverStopped;
    return d;
  };

  const int64_t start = bounds[tile];
  const int64_t end = bounds[tile + 1];
  const int n_batches = static_cast<int>((end - start + kBatch - 1) / kBatch);
  // batch b: the sorted positions [start + b kBatch, + kBatch) up to end
  auto batch = [&](int b) {
    const int64_t base = start + static_cast<int64_t>(b) * kBatch;
    const int64_t left = end - base;
    return gsl::Batch{base, 0, static_cast<int>(left < kBatch ? left : kBatch)};
  };
  auto issue_ids = [&](int b) {
    gsl::issue_ids(s_ids + (b & 1) * kBatch, gids, batch(b));
  };
  // the mean, the conic and the group's channels by the ids in
  // s_ids[b & 1]; the opacity by the slot's own thread, which derives the
  // cut from it
  auto issue_records = [&](int b) {
    float* buf = s_fields + (b & 1) * F;
    const int* ids = s_ids + (b & 1) * kBatch;
    gsl::issue_values<kBatch>(
        buf, RS, ids, batch(b), 5 + CG,
        [](int i) { return i < 5 ? i : kFields + i - 5; },
        [&](int i, int64_t g) {
          return i < 2   ? means2d + 2 * g + i
                 : i < 5 ? conics + 3 * g + (i - 2)
                         : channels + g * n_channels + c0 + (i - 5);
        });
    gsl::issue_own<kBatch>(buf, RS, ids, batch(b), kOp,
                           [&](int64_t g) { return opacities + g; });
  };
  auto derive = [&](int b) {
    gsl::skip_sigmas<kBatch>(s_fields + (b & 1) * F, RS, batch(b), kOp,
                             kSkip);
  };

  // the block leaves after the batch at which every pixel has stopped
  gsl::walk_batches(n_batches, issue_ids, issue_records, derive, [&](int b) {
    const gsl::Batch s = batch(b);
    // each thread walks the batch until its pixels have stopped; a branch
    // that every lane of a warp takes the same way costs the warp nothing
    // more than the branch, so a slot no pixel of the warp can keep is
    // passed at its sigma
    const float* rec = s_fields + (b & 1) * F;
    for (int j = 0; j < s.hi && !all_done(); ++j, rec += RS) {
      float r[kLoad];
      gsl::load_record(rec, r);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (stop[k] != kNeverStopped) continue;
        const float ca = r[2], cb = r[3], cc = r[4];
        const float dx = r[0] - px[k];
        const float dy = r[1] - py[k];
        const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
        if (sigma > r[kSkip]) continue;  // alpha < 1/255 for certain
        // the exact test, K3's arithmetic
        const float alpha = fminf(max_alpha, r[kOp] * expf(-sigma));
        if (sigma < 0.0f || alpha < threshold) continue;
        const float next_t = T[k] * (1.0f - alpha);
        if (next_t <= min_t) {
          stop[k] = static_cast<int>(s.base + j);
          continue;
        }
        const float w = alpha * T[k];
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          constexpr int k0 = kFields;
          acc[k][c] += w * (k0 + c < kLoad ? r[k0 + c < kLoad ? k0 + c : 0]
                                           : rec[k0 + c]);
        }
        T[k] = next_t;
      }
    }
    return all_done();
  });
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = tid + k * nt;
    const int x = (tile % tiles_x) * tile_size + p % tile_size;
    const int y = (tile / tiles_x) * tile_size + p / tile_size;
    if (p >= bs || x >= width || y >= height) continue;
    const int64_t pix = static_cast<int64_t>(y) * width + x;
#pragma unroll
    for (int c = 0; c < CG; ++c) out[pix * n_channels + c0 + c] = acc[k][c];
    t_final[pix] = T[k];
    i_stop[pix] = stop[k];
  }
}

template <int CG>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* channels,
                   int n_channels, int c0, const int* gids,
                   const int64_t* bounds, int n_tiles, int tiles_x,
                   int tile_size, int height, int width, float* out,
                   float* t_final, int* i_stop, cudaStream_t stream,
                   int* attributes) {
  const int nt = block_threads(tile_size);
  const size_t smem = smem_words(CG) * sizeof(float);
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_fwd_kernel<CG>, nt, smem,
                                  attributes);
  }
  rasterize_fwd_kernel<CG><<<n_tiles, nt, smem, stream>>>(
      means2d, conics, opacities, channels, n_channels, c0, gids, bounds,
      tiles_x, tile_size, height, width, out, t_final, i_stop);
  return cudaGetLastError();
}

int dispatch(const float* means2d, const float* conics,
             const float* opacities, const float* channels, int n_channels,
             int c0, int cg, const int* gids, const int64_t* bounds,
             int n_tiles, int tiles_x, int tile_size, int height, int width,
             float* out, float* t_final, int* i_stop, cudaStream_t s,
             int* attributes) {
  return static_cast<int>(gsl::for_group(cg, [&](auto group) {
    return launch<decltype(group)::value>(
        means2d, conics, opacities, channels, n_channels, c0, gids, bounds,
        n_tiles, tiles_x, tile_size, height, width, out, t_final, i_stop, s,
        attributes);
  }));
}

bool bad_tile(int tile_size) {
  return tile_size < 1 || tile_size * tile_size > 1024;
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_rasterize_fwd_max_group() { return gsl::kMaxGroup; }

// Composites channels [c0, c0 + cg) of `channels`; T and i_stop are
// written by every call and agree between calls.
int gsl_rasterize_fwd(const float* means2d, const float* conics,
                      const float* opacities, const float* channels,
                      int n_channels, int c0, int cg, const int* gids,
                      const int64_t* bounds, int n_tiles, int tiles_x,
                      int tile_size, int height, int width, float* out,
                      float* t_final, int* i_stop, void* stream) {
  if (cg < 1 || cg > gsl::kMaxGroup || c0 < 0 || c0 + cg > n_channels ||
      bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(means2d, conics, opacities, channels, n_channels, c0, cg,
                  gids, bounds, n_tiles, tiles_x, tile_size, height, width,
                  out, t_final, i_stop, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// composites min(n_channels, kMaxGroup) channels at tile_size.
int gsl_rasterize_fwd_attributes(int n_channels, int tile_size, int* out) {
  if (n_channels < 1 || bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = n_channels < gsl::kMaxGroup ? n_channels : gsl::kMaxGroup;
  return dispatch(nullptr, nullptr, nullptr, nullptr, n_channels, 0, cg,
                  nullptr, nullptr, 0, 1, tile_size, 0, 0, nullptr, nullptr,
                  nullptr, nullptr, out);
}

}  // extern "C"
