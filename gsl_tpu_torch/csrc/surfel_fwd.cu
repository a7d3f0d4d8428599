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
// and walks the tile's range of the sorted surfel ids in batches of kBatch
// slots; every thread composites a batch in order, sequentially, as the
// oracle does, with its sums in registers.
//
// Bound on the H100: operations. A visited (pixel, surfel) pair costs 47 f32
// operations (hx, hy 12; the cross product 9; the guard 2; u, v 2; rho3d 3;
// the low-pass 6; the branch 2; depth 4; exp, alpha 4; three compares), a
// composited pair 26 + 2C more (transmittance 3, weight 1, the channels 2C,
// depth 2, the median 2, the mapped depth 5, the distortion 8, its sums 5).
// Against that stand 52 + 4C bytes per surfel, 4 per sorted id and
// 4 (C + 8) per pixel.
//
// Before this design the kernel ran at 5.6x that bound (2.43 ms; NVIDIA
// H100 80GB HBM3 at 700 W, 1M surfels, 1088x1920, C = 6). Removing one
// part at a time from a copy (scripts/torch_kernel_parts.py) showed where:
// the compositing after the solve cost 0.26 ms, the gather by id with its
// two divisions per slot 0.05, the second barrier 0.01; batches of 32 or
// 64 slots in place of 256 cost 0.04 and 0.01 more; lanes idling beside
// lanes that had not stopped cost nothing (0.5% of the warps' steps). The
// rest is the solve: 88 instructions per (slot, warp) step, two IEEE
// divisions and an exponential among them, over 18.3 M steps, which one
// instruction per clock on each of the 528 schedulers takes about 1.6 ms
// to issue. What the design does:
//
// - Two slots a step: their solves are independent, so the scheduler
//   overlaps one's latency with the other's; the loop is uniform over the
//   warp (its exit is a vote). One slot a step costs 0.22 ms more.
// - A slot's 15 solve values (the 13 geometry values and the projected
//   centre) and its channels lie together in shared memory (a record of
//   15 + CG floats padded to 16 bytes); the solve reads them with four
//   16-byte loads where the strided layout took fifteen 4-byte ones (read
//   by 4-byte loads, the records cost 0.05 ms more).
// - The ids and records of the next batch are copied into a second buffer
//   with cp.async (__pipeline_memcpy_async) while this one is composited,
//   the ids two batches ahead. The copies gather by surfel id, which TMA's
//   tiled copies do not serve. The thread that copied a slot's Tw derives
//   its projected centre once its own copies have landed.
// - One barrier per batch of 64 slots, and it is the block's exit test
//   (__syncthreads_count): it frees the batch's buffer, publishes the next
//   one and lets the block leave once every pixel has stopped.
// - At most 64 registers, so four blocks of 256 threads fit an SM.
// - The solve is surfel_terms.cuh's, shared with K7, so both take the same
//   keep decisions from the same rounded values. Per pixel the compositing
//   is sequential, in the plain version's order.
//
// The channel count C is not capped: one launch composites a group of up to
// kMaxGroup channels (a template parameter, so the sums stay in registers)
// and the caller launches once per group. Every launch recomputes and
// writes the same aux planes and stop index.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "surfel_terms.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kBatch = 64;
constexpr int kMaxGroup = gsl::kMaxGroup;  // the groups for_group lists
constexpr int kMaxThreads = 1024;  // tile_size <= 32
constexpr int kNeverStopped = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;

// A slot's record in shared memory: its kSplat values (surfel_terms.cuh's
// order), its CG channels, padded to whole 16-byte loads.
__host__ __device__ constexpr int record_floats(int cg) {
  return (surfel::kSplat + cg + 3) & ~3;
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

size_t smem_words(int cg) {
  return 2 * static_cast<size_t>(record_floats(cg)) * kBatch +  // records
         2 * static_cast<size_t>(kBatch);                       // ids
}

template <int CG>
__global__ void __launch_bounds__(kMaxThreads) rasterize_surfels_fwd_kernel(
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
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = record_floats(CG);
  constexpr int F = kBatch * RS;  // one buffer of gathered records
  float* s_fields = smem;                                  // [2][F]
  int* s_ids = reinterpret_cast<int*>(s_fields + 2 * F);   // [2][kBatch]
  const int bs = blockDim.x;  // tile_size^2, a multiple of 32

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

  const int n_batches = static_cast<int>((end - start + kBatch - 1) / kBatch);
  auto count_of = [&](int b) {
    const int64_t left = end - (start + static_cast<int64_t>(b) * kBatch);
    return static_cast<int>(left < kBatch ? left : kBatch);
  };
  // batch b's ids into s_ids[b & 1]
  auto issue_ids = [&](int b) {
    if (b < n_batches && tid < count_of(b)) {
      __pipeline_memcpy_async(s_ids + (b & 1) * kBatch + tid,
                              gids + start + static_cast<int64_t>(b) * kBatch +
                                  tid,
                              sizeof(int));
    }
  };
  // batch b's records into s_fields[b & 1] by the ids in s_ids[b & 1]. The
  // thread of slot j copies its Tw (fields 6, 7, 8); project() derives the
  // centre from them once they have landed.
  auto issue_fields = [&](int b) {
    if (b >= n_batches) return;
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
    // the other ten geometry values, then the group's channels
    for (int v = tid; v < (10 + CG) * kBatch; v += bs) {
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
        src = channels + gid * n_channels + c0 + (f - 10);
      }
      __pipeline_memcpy_async(buf + j * RS + field, src, sizeof(float));
    }
  };
  // after this thread's copies of batch b have landed: the projected centre
  // Tw.xy / Tw.z of its slot, with a zero Tw.z replaced by 1
  auto project = [&](int b) {
    if (b < n_batches && tid < count_of(b)) {
      float* rec = s_fields + (b & 1) * F + tid * RS;
      const float twz = surfel::safe_twz(rec[8]);
      rec[13] = rec[6] / twz;
      rec[14] = rec[7] / twz;
    }
  };

  if (n_batches > 0) {  // uniform over the block
    issue_ids(0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    issue_fields(0);
    issue_ids(1);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    project(0);
    __syncthreads();
  }
  for (int b = 0; b < n_batches; ++b) {
    // in flight during this batch: the next batch's records (their ids
    // arrived before the last barrier) and the ids of the one after
    issue_fields(b + 1);
    issue_ids(b + 2);
    __pipeline_commit();

    const int64_t base = start + static_cast<int64_t>(b) * kBatch;
    const int count = count_of(b);
    const float* s_rec = s_fields + (b & 1) * F;
    // composites slot j of this batch: t solved from its record rec, whose
    // first kLoad values are sg
    auto composite = [&](const surfel::Terms& t, const float* sg,
                         const float* rec, int j) {
      if (done || !t.keep) return;
      const float next_t = T * (1.0f - t.alpha);
      if (next_t <= min_t) {
        done = true;
        stop = static_cast<int>(base + j);
        return;
      }
      const float w = t.alpha * T;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        constexpr int k0 = surfel::kSplat;
        acc[c] += w * (k0 + c < kLoad ? sg[k0 + c < kLoad ? k0 + c : 0]
                                      : rec[k0 + c]);
      }
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
    };
    // two slots a step: their solves are independent, so one hides the
    // other's latency; each pixel still composites them in order. The loop
    // is uniform over the warp and leaves once all its pixels have stopped.
    for (int j = 0; j < count; j += 2) {
      if (__all_sync(kFullMask, done)) break;
      const int jb = j + 1 < count ? j + 1 : j;
      const float* ra = s_rec + j * RS;
      const float* rb = s_rec + jb * RS;
      float sa[kLoad], sb[kLoad];
      load_record(ra, sa);
      load_record(rb, sb);
      const surfel::Terms ta = surfel::solve(sa, 1, px, py);
      const surfel::Terms tb = surfel::solve(sb, 1, px, py);
      composite(ta, sa, ra, j);
      if (jb != j) composite(tb, sb, rb, jb);
    }
    __pipeline_wait_prior(0);
    project(b + 1);
    // the one barrier of a batch: this batch's buffer is free, the next
    // one's records are in place, and the block leaves once every pixel
    // has stopped
    if (__syncthreads_count(done) == bs) break;
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
                   cudaStream_t stream, int* attributes) {
  const int bs = tile_size * tile_size;
  const size_t smem = smem_words(CG) * sizeof(float);
  if (attributes != nullptr) {
    return gsl::kernel_attributes(rasterize_surfels_fwd_kernel<CG>, bs, smem,
                                  attributes);
  }
  rasterize_surfels_fwd_kernel<CG><<<n_tiles, bs, smem, stream>>>(
      geom, channels, n_channels, c0, gids, bounds, tiles_x, tile_size,
      height, width, out, aux, i_stop);
  return cudaGetLastError();
}

int dispatch(const float* geom, const float* channels, int n_channels,
             int c0, int cg, const int* gids, const int64_t* bounds,
             int n_tiles, int tiles_x, int tile_size, int height, int width,
             float* out, float* aux, int* i_stop, cudaStream_t s,
             int* attributes) {
  return static_cast<int>(gsl::for_group(cg, [&](auto group) {
    return launch<decltype(group)::value>(
        geom, channels, n_channels, c0, gids, bounds, n_tiles, tiles_x,
        tile_size, height, width, out, aux, i_stop, s, attributes);
  }));
}

// whole warps: the loop's exit is a vote over the warp
bool bad_tile(int tile_size) {
  const int bs = tile_size * tile_size;
  return tile_size < 1 || bs > kMaxThreads || bs % 32 != 0;
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
      bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  return dispatch(geom, channels, n_channels, c0, cg, gids, bounds, n_tiles,
                  tiles_x, tile_size, height, width, out, aux, i_stop,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of the kernel that
// composites min(n_channels, kMaxGroup) channels at tile_size.
int gsl_rasterize_surfels_fwd_attributes(int n_channels, int tile_size,
                                         int* out) {
  if (n_channels < 1 || bad_tile(tile_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = n_channels < kMaxGroup ? n_channels : kMaxGroup;
  return dispatch(nullptr, nullptr, n_channels, 0, cg, nullptr, nullptr, 0,
                  1, tile_size, 0, 0, nullptr, nullptr, nullptr, nullptr,
                  out);
}

}  // extern "C"
