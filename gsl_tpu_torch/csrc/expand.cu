// K1: expand Gaussians into (tile, depth) sort keys, one slot per touched
// tile.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_expand_kernel (pallas_call in
// _expand_sorted). It computes the same function: for every Gaussian's
// tile-rectangle slot, the tile, the key (tile << 32) | bits(max(depth, 0)),
// the Gaussian id, and the StopThePop peak-alpha tile cull
// (op * exp(-min sigma over the tile box) < 1/255 marks the slot invalid).
// A Gaussian culled by projection keeps one dummy slot, invalid as well.
// Invalid slots get key INT64_MAX so the sort puts them last.
// With stp_resort (the StopThePop branch of _expand_kernel) the depth in the
// key is the Gaussian's depth plane at the centre of the slot's tile,
//   depth + kz_x * (tc_x - mean_x) + kz_y * (tc_y - mean_y),
// kz = depth_grads; the centre depth and kz are not carried along: the
// per-pixel-resort kernels gather them by id.
//
// What the TPU needed and this does not: slot -> Gaussian lookup by windowed
// one-hot matmuls, f32 slot offsets (exact only below 2^24), and a payload
// carried through the sort; the rasterizer gathers the payload by Gaussian
// id after the sort. What it keeps: the walk slot by slot. A block owns a
// run of kThreads consecutive Gaussians and so one contiguous slot range
// (slot_runs.cuh). It stages the run's records in shared memory, one
// Gaussian a thread, then its threads stride over the slot range: each
// finds its slot's Gaussian by binary search over the staged offsets,
// computes the tile from the slot's place in the rectangle, culls and keys
// it, and the warp writes 32 neighbouring keys and ids. One thread per
// Gaussian looping over that Gaussian's slots (the design before) kept each
// warp as long as its longest Gaussian and scattered its stores.
//
// Bound on the H100: bytes. Each Gaussian reads 52 bytes (offset 8, rect 16,
// depth 4, mean 8, conic 12, opacity 4; 8 more of depth_grads with
// stp_resort) and each slot writes 12 (key 8, id 4); the cull is ~40 flops
// and one exp per slot (the plane key 8 more), far below the card's
// 67 TFLOP/s f32 rate at the ~2.6 slots per Gaussian of the bench scene.
// No atomics: every slot is written by one thread, the same in every run.
//
// Built with -fmad=false: the plain PyTorch version (expand_plain) is held
// to this kernel bit for bit, and PyTorch rounds every multiply and add on
// its own. Constants are written as (float)<double> because PyTorch casts a
// Python float scalar to float32 that way.
#include <cstdint>
#include <cuda_runtime.h>

#include "slot_runs.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kThreads = 128;  // threads of a block, Gaussians of its run
// the staged record of a Gaussian, one array of kThreads each
enum Field { kMinX, kMinY, kW, kH, kDepth, kMx, kMy, kCa, kCb, kCc, kOp,
             kKzx, kKzy, kFields };
// shared words: the run's offsets (kThreads + 1, padded) and the records
constexpr int kSmemWords = kThreads + 4 + kFields * kThreads;

__device__ __forceinline__ float sigma_at(float ca, float cb, float cc,
                                          float dx, float dy) {
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) expand_kernel(
    const int64_t* __restrict__ offsets,  // [N] exclusive prefix of max(hits, 1)
    const int* __restrict__ rect,         // [N, 4] min_x, min_y, width, height
    const float* __restrict__ depths,     // [N]
    const float* __restrict__ means2d,    // [N, 2]
    const float* __restrict__ conics,     // [N, 3]
    const float* __restrict__ opacities,  // [N]
    const float* __restrict__ depth_grads,  // [N, 2], read with stp_resort
    int n, int tile_size, int tiles_x, int tiles_y, int culling,
    int stp_resort,
    int64_t* __restrict__ keys,           // [total]
    int* __restrict__ gids) {             // [total]
  extern __shared__ __align__(16) float smem[];
  int* s_off = reinterpret_cast<int*>(smem);
  // [kFields][kThreads]: the rectangle's four ints, then the floats
  int* s_int = s_off + kThreads + 4;
  float* s_rec = smem + kThreads + 4;
  const int t = threadIdx.x;
  const int g0 = static_cast<int>(blockIdx.x) * kThreads;
  if (g0 + t < n) {
    const int g = g0 + t;
    const int4 r = reinterpret_cast<const int4*>(rect)[g];
    s_int[kMinX * kThreads + t] = r.x;
    s_int[kMinY * kThreads + t] = r.y;
    s_int[kW * kThreads + t] = r.z;
    s_int[kH * kThreads + t] = r.w;
    s_rec[kDepth * kThreads + t] = depths[g];
    s_rec[kMx * kThreads + t] = means2d[2 * g + 0];
    s_rec[kMy * kThreads + t] = means2d[2 * g + 1];
    s_rec[kCa * kThreads + t] = conics[3 * g + 0];
    s_rec[kCb * kThreads + t] = conics[3 * g + 1];
    s_rec[kCc * kThreads + t] = conics[3 * g + 2];
    s_rec[kOp * kThreads + t] = opacities[g];
    if (stp_resort) {
      s_rec[kKzx * kThreads + t] = depth_grads[2 * g + 0];
      s_rec[kKzy * kThreads + t] = depth_grads[2 * g + 1];
    }
  }
  // the slot past the last Gaussian's: it has max(w * h, 1) slots
  int64_t end = 0;
  if (g0 + kThreads >= n) {
    end = offsets[n - 1] + max(rect[4 * (n - 1) + 2] * rect[4 * (n - 1) + 3],
                               1);
  }
  const gsl::SlotRun run = gsl::stage_run(offsets, n, kThreads, end, s_off);
  const float ts = static_cast<float>(tile_size);
  const float eps = static_cast<float>(1e-12);
  const float threshold = static_cast<float>(1.0 / 255.0);
  for (int s = t; s < run.slots; s += kThreads) {
    const int i = gsl::slot_owner(s_off, run.count, s);
    const int local = s - s_off[i];
    const int w = s_int[kW * kThreads + i];
    const int hits = w * s_int[kH * kThreads + i];
    const int64_t at = run.s0 + s;
    gids[at] = run.g0 + i;
    if (hits == 0) {  // culled by projection: one invalid dummy slot
      keys[at] = INT64_MAX;
      continue;
    }
    const int ty = min(s_int[kMinY * kThreads + i] + local / w, tiles_y - 1);
    const int tx = s_int[kMinX * kThreads + i] + local % w;
    const float mx = s_rec[kMx * kThreads + i];
    const float my = s_rec[kMy * kThreads + i];
    bool valid = true;
    if (culling) {
      const float ca = s_rec[kCa * kThreads + i];
      const float cb = s_rec[kCb * kThreads + i];
      const float cc = s_rec[kCc * kThreads + i];
      const float ca_safe = fmaxf(ca, eps);
      const float cc_safe = fmaxf(cc, eps);
      // exact peak alpha over the tile box: sigma's minimum is 0 if the
      // mean is inside, else the least of its minima along the four edges
      const float xlo = static_cast<float>(tx) * ts - mx;
      const float xhi = xlo + ts;
      const float ylo = static_cast<float>(ty) * ts - my;
      const float yhi = ylo + ts;
      const float e0 = sigma_at(ca, cb, cc, xlo,
                                clampf(-cb * xlo / cc_safe, ylo, yhi));
      const float e1 = sigma_at(ca, cb, cc, xhi,
                                clampf(-cb * xhi / cc_safe, ylo, yhi));
      const float e2 = sigma_at(ca, cb, cc,
                                clampf(-cb * ylo / ca_safe, xlo, xhi), ylo);
      const float e3 = sigma_at(ca, cb, cc,
                                clampf(-cb * yhi / ca_safe, xlo, xhi), yhi);
      float smin = fminf(fminf(e0, e1), fminf(e2, e3));
      const bool inside = xlo <= 0.0f && xhi >= 0.0f && ylo <= 0.0f &&
                          yhi >= 0.0f;
      smin = inside ? 0.0f : fmaxf(smin, 0.0f);
      valid = !(s_rec[kOp * kThreads + i] * expf(-smin) < threshold);
    }
    float key_depth = s_rec[kDepth * kThreads + i];
    if (stp_resort) {
      const float tcx = (static_cast<float>(tx) + 0.5f) * ts;
      const float tcy = (static_cast<float>(ty) + 0.5f) * ts;
      key_depth = key_depth + s_rec[kKzx * kThreads + i] * (tcx - mx) +
                  s_rec[kKzy * kThreads + i] * (tcy - my);
    }
    const int64_t dbits =
        static_cast<int64_t>(__float_as_uint(fmaxf(key_depth, 0.0f)));
    const int64_t tile = static_cast<int64_t>(ty) * tiles_x + tx;
    keys[at] = valid ? ((tile << 32) | dbits) : INT64_MAX;
  }
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_expand(const int64_t* offsets, const int* rect, const float* depths,
               const float* means2d, const float* conics,
               const float* opacities, const float* depth_grads, int n,
               int tile_size, int tiles_x, int tiles_y, int culling,
               int stp_resort, int64_t* keys, int* gids, void* stream) {
  if ((stp_resort && depth_grads == nullptr) ||
      // rect is read a Gaussian's int4 (16 bytes, 16-byte aligned) at a
      // time
      reinterpret_cast<uintptr_t>(rect) % 16 != 0 ||
      // a run's slots fit an int: each Gaussian has at most every tile
      static_cast<int64_t>(tiles_x) * tiles_y * kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    expand_kernel<<<blocks, kThreads, kSmemWords * sizeof(float), s>>>(
        offsets, rect, depths, means2d, conics, opacities, depth_grads, n,
        tile_size, tiles_x, tiles_y, culling, stp_resort, keys, gids);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM.
int gsl_expand_attributes(int* out) {
  return static_cast<int>(gsl::kernel_attributes(
      expand_kernel, kThreads, kSmemWords * sizeof(float), out));
}

}  // extern "C"
