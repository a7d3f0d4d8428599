// K5: expand surfels into (tile, depth) sort keys, one slot per touched tile.
//
// Replaces gsl_tpu/ops/surfel_pallas.py:61 _expand_kernel_s (pallas_call at
// :163, in _expand_sorted_s). It computes the same function without the
// payload: for every slot of a surfel's tile rectangle, the tile (its row
// clamped to tiles_y - 1, as surfel_pallas.py:101 does), the key
// (tile << 32) | bits(max(depth, 0)) with all 32 depth bits, and the surfel
// id. A surfel culled by projection (empty rectangle) keeps one dummy slot
// with key INT64_MAX, which the sort puts last. The surfel path has no
// peak-alpha tile cull and no StopThePop keys.
//
// What the TPU needed and this does not: slot -> surfel lookup by windowed
// one-hot matmuls over a 32-lane table, f32 slot offsets (exact only below
// 2^24), a key of 32 - tile_bits depth bits, and the 13 + C payload rows
// carried through the sort; the rasterizer gathers the payload by surfel id
// after the sort. What it keeps: the walk slot by slot, as K1 (expand.cu)
// walks it without the cull. A block owns a run of kThreads consecutive
// surfels and so one contiguous slot range (slot_runs.cuh). It stages each
// surfel's rectangle (one 16-byte load) and depth bits in shared memory, one
// surfel a thread; then its threads stride over the run's slots, each finds
// its slot's surfel by binary search over the staged offsets, and a warp
// writes 32 neighbouring keys (256 bytes) and ids (128 bytes). One thread a
// surfel looping over its slots (the design before) kept each warp as long
// as its longest surfel and scattered each store over 32 places.
//
// Bound on the H100: bytes. Each surfel reads 28 bytes (offset 8, rect 16,
// depth 4) and each slot writes 12 (key 8, id 4); a slot's integer work (a
// search of log2(kThreads) steps, a division and a remainder) is far below
// the card's issue rate. No atomics: every slot is written by one thread,
// the same in every run.
#include <cstdint>
#include <cuda_runtime.h>

#include "slot_runs.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kThreads = 128;  // threads of a block, surfels of its run
// the staged record of a surfel, one array of kThreads each
enum Field { kMinX, kMinY, kW, kH, kBits, kFields };
// shared words: the run's offsets (kThreads + 1, padded) and the records
constexpr int kSmemWords = kThreads + 4 + kFields * kThreads;

__global__ void __launch_bounds__(kThreads) expand_surfel_kernel(
    const int64_t* __restrict__ offsets,  // [N] exclusive prefix of max(hits, 1)
    const int* __restrict__ rect,         // [N, 4] min_x, min_y, width, height
    const float* __restrict__ depths,     // [N]
    int n, int tiles_x, int tiles_y,
    int64_t* __restrict__ keys,           // [total]
    int* __restrict__ gids) {             // [total]
  extern __shared__ __align__(16) float smem[];
  int* s_off = reinterpret_cast<int*>(smem);
  // [kFields][kThreads]: the rectangle's four ints, then the depth bits
  int* s_rec = s_off + kThreads + 4;
  const int t = threadIdx.x;
  const int g0 = static_cast<int>(blockIdx.x) * kThreads;
  if (g0 + t < n) {
    const int g = g0 + t;
    const int4 r = reinterpret_cast<const int4*>(rect)[g];
    s_rec[kMinX * kThreads + t] = r.x;
    s_rec[kMinY * kThreads + t] = r.y;
    s_rec[kW * kThreads + t] = r.z;
    s_rec[kH * kThreads + t] = r.w;
    s_rec[kBits * kThreads + t] =
        static_cast<int>(__float_as_uint(fmaxf(depths[g], 0.0f)));
  }
  // the slot past the last surfel's: it has max(w * h, 1) slots
  int64_t end = 0;
  if (g0 + kThreads >= n) {
    end = offsets[n - 1] + max(rect[4 * (n - 1) + 2] * rect[4 * (n - 1) + 3],
                               1);
  }
  const gsl::SlotRun run = gsl::stage_run(offsets, n, kThreads, end, s_off);
  for (int s = t; s < run.slots; s += kThreads) {
    const int i = gsl::slot_owner(s_off, run.count, s);
    const int local = s - s_off[i];
    const int w = s_rec[kW * kThreads + i];
    const int64_t at = run.s0 + s;
    gids[at] = run.g0 + i;
    if (w * s_rec[kH * kThreads + i] == 0) {  // culled: one dummy slot
      keys[at] = INT64_MAX;
      continue;
    }
    const int ty = min(s_rec[kMinY * kThreads + i] + local / w, tiles_y - 1);
    const int tx = s_rec[kMinX * kThreads + i] + local % w;
    const int64_t tile = static_cast<int64_t>(ty) * tiles_x + tx;
    const int64_t dbits =
        static_cast<uint32_t>(s_rec[kBits * kThreads + i]);
    keys[at] = (tile << 32) | dbits;
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
  // rect is read a surfel's int4 (16 bytes, 16-byte aligned) at a time
  if (reinterpret_cast<uintptr_t>(rect) % 16 != 0 ||
      // a run's slots fit an int: each surfel has at most every tile
      static_cast<int64_t>(tiles_x) * tiles_y * kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    expand_surfel_kernel<<<blocks, kThreads, kSmemWords * sizeof(float), s>>>(
        offsets, rect, depths, n, tiles_x, tiles_y, keys, gids);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM.
int gsl_expand_surfel_attributes(int* out) {
  return static_cast<int>(gsl::kernel_attributes(
      expand_surfel_kernel, kThreads, kSmemWords * sizeof(float), out));
}

}  // extern "C"
