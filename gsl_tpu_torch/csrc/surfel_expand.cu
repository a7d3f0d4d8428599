// K5: expand surfels into (tile, depth) sort keys, one slot per touched tile.
//
// Replaces gsl_tpu/ops/surfel_pallas.py::_expand_kernel_s (pallas_call in
// _expand_sorted_s). It computes the same function without the payload: for
// every slot of a surfel's tile rectangle, the tile, the key
// (tile << 32) | bits(max(depth, 0)) and the surfel id. The surfel path has
// no peak-alpha tile cull and no StopThePop keys, so the kernel reads only
// the offsets, the rectangles and the depths. A surfel culled by projection
// (empty rectangle) keeps one dummy slot with key INT64_MAX, which the sort
// puts last.
//
// What the TPU needed and this does not: slot -> surfel lookup by windowed
// one-hot matmuls over a 32-lane table, f32 slot offsets (exact only below
// 2^24), a key of 32 - tile_bits depth bits, and the 13 + C payload rows
// carried through the sort. Here one thread owns one surfel and writes its
// slots from its int64 exclusive-prefix offset; the key keeps all 32 depth
// bits; the rasterizer gathers the payload by surfel id after the sort.
//
// Bound on the H100: bytes. Each surfel reads 28 bytes (offset 8, rect 16,
// depth 4) and each slot writes 12 (key 8, id 4); the integer work per slot
// is a division, a remainder and a shift. One thread's slots are contiguous,
// so neighbouring threads write neighbouring runs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) expand_surfel_kernel(
    const int64_t* __restrict__ offsets,  // [N] exclusive prefix of max(hits, 1)
    const int* __restrict__ rect,         // [N, 4] min_x, min_y, width, height
    const float* __restrict__ depths,     // [N]
    int n, int tiles_x, int tiles_y,
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
  const int64_t dbits =
      static_cast<int64_t>(__float_as_uint(fmaxf(depths[g], 0.0f)));
  for (int local = 0; local < hits; ++local) {
    const int ty = min(min_y + local / w, tiles_y - 1);
    const int tx = min_x + local % w;
    const int64_t tile = static_cast<int64_t>(ty) * tiles_x + tx;
    keys[off + local] = (tile << 32) | dbits;
    gids[off + local] = g;
  }
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_expand_surfel(const int64_t* offsets, const int* rect,
                      const float* depths, int n, int tiles_x, int tiles_y,
                      int64_t* keys, int* gids, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    expand_surfel_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        offsets, rect, depths, n, tiles_x, tiles_y, keys, gids);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
