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
// carried through the sort. Here one thread owns one Gaussian and writes its
// slots from its int64 exclusive-prefix offset; the rasterizer gathers the
// payload by Gaussian id after the sort.
//
// Bound on the H100: bytes. Each Gaussian reads 52 bytes (offset 8, rect 16,
// depth 4, mean 8, conic 12, opacity 4; 8 more of depth_grads with
// stp_resort) and each slot writes 12 (key 8, id 4); the cull is ~40 flops
// and one exp per slot (the plane key 8 more), far below the card's
// 67 TFLOP/s f32 rate at the ~2.6 slots per Gaussian of the bench scene.
// Writes of one thread's slots are contiguous, so neighbouring threads
// write neighbouring runs; the design keeps the kernel to one pass over
// the Gaussians with no atomics.
//
// Built with -fmad=false: the plain PyTorch version (expand_plain) is held
// to this kernel bit for bit, and PyTorch rounds every multiply and add on
// its own. Constants are written as (float)<double> because PyTorch casts a
// Python float scalar to float32 that way.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int64_t off = offsets[g];
  const int min_x = rect[4 * g + 0];
  const int min_y = rect[4 * g + 1];
  const int w = rect[4 * g + 2];
  const int h = rect[4 * g + 3];
  const int hits = w * h;
  if (hits == 0) {  // culled by projection: one invalid dummy slot
    keys[off] = INT64_MAX;
    gids[off] = g;
    return;
  }
  const float depth = depths[g];
  const float kzx = stp_resort ? depth_grads[2 * g + 0] : 0.0f;
  const float kzy = stp_resort ? depth_grads[2 * g + 1] : 0.0f;
  const float mx = means2d[2 * g + 0];
  const float my = means2d[2 * g + 1];
  const float ca = conics[3 * g + 0];
  const float cb = conics[3 * g + 1];
  const float cc = conics[3 * g + 2];
  const float op = opacities[g];
  const float ts = static_cast<float>(tile_size);
  const float eps = static_cast<float>(1e-12);
  const float threshold = static_cast<float>(1.0 / 255.0);
  const float ca_safe = fmaxf(ca, eps);
  const float cc_safe = fmaxf(cc, eps);
  for (int local = 0; local < hits; ++local) {
    const int ty = min(min_y + local / w, tiles_y - 1);
    const int tx = min_x + local % w;
    bool valid = true;
    if (culling) {
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
      valid = !(op * expf(-smin) < threshold);
    }
    float key_depth = depth;
    if (stp_resort) {
      const float tcx = (static_cast<float>(tx) + 0.5f) * ts;
      const float tcy = (static_cast<float>(ty) + 0.5f) * ts;
      key_depth = depth + kzx * (tcx - mx) + kzy * (tcy - my);
    }
    const int64_t dbits =
        static_cast<int64_t>(__float_as_uint(fmaxf(key_depth, 0.0f)));
    const int64_t tile = static_cast<int64_t>(ty) * tiles_x + tx;
    keys[off + local] = valid ? ((tile << 32) | dbits) : INT64_MAX;
    gids[off + local] = g;
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
  if (stp_resort && depth_grads == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    expand_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        offsets, rect, depths, means2d, conics, opacities, depth_grads, n,
        tile_size, tiles_x, tiles_y, culling, stp_resort, keys, gids);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
