// A tile's sorted slots gathered batch by batch into shared memory, and the
// launch helpers of the raster kernels' C entry points. The gather serves
// the forward kernels K2 (rasterize_fwd.cu) and K2s (rasterize_fwd_stp.cu);
// K3, K3s, K6 and K7 still carry their own copies of the same scheme and
// use the helpers alone.
//
// Each slot's values lie together in one record padded to whole 16-byte
// loads. The records of a batch are copied by Gaussian id with cp.async
// (__pipeline_memcpy_async; TMA's tiled copies do not gather by id) into
// one of two buffers while the block works on the other, the ids two
// batches ahead, with one barrier a batch.
#pragma once
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace gsl {

// Channels one launch composites; the wrappers launch once per group.
constexpr int kMaxGroup = 8;

// Floats of a record of n values: whole 16-byte loads.
__host__ __device__ constexpr int record_floats(int n) {
  return (n + 3) & ~3;
}

// The first N values of a record (N a multiple of 4), in N / 4 16-byte
// loads.
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

// The tile's slots of one batch: slot j of the buffer holds the sorted
// position base + j for lo <= j < hi; the buffer's other slots are zeros.
struct Batch {
  int64_t base;
  int lo, hi;
};

// Starts the copies of a batch's ids: ids[j] = gids[base + j].
__device__ __forceinline__ void issue_ids(int* ids, const int* gids,
                                          Batch s) {
  for (int j = s.lo + static_cast<int>(threadIdx.x); j < s.hi;
       j += blockDim.x) {
    __pipeline_memcpy_async(ids + j, gids + s.base + j, sizeof(int));
  }
}

// Starts the copies of n values of each of the kBatch slots of a batch
// into their records of rs floats in `buf`: value i of slot j is
// *addr(i, ids[j]) and lands at buf[j * rs + at(i)]. The threads take the
// (value, slot)s in turn, slot fastest.
template <int kBatch, class At, class Addr>
__device__ __forceinline__ void issue_values(float* buf, int rs,
                                             const int* ids, Batch s, int n,
                                             At at, Addr addr) {
  for (int v = threadIdx.x; v < n * kBatch; v += blockDim.x) {
    const int i = v / kBatch;
    const int j = v - i * kBatch;
    float* dst = buf + j * rs + at(i);
    if (j >= s.lo && j < s.hi) {
      __pipeline_memcpy_async(dst, addr(i, static_cast<int64_t>(ids[j])),
                              sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
}

// Starts the copy of one value of each slot of a batch, *addr(ids[j]) to
// buf[j * rs + at], by the slot's own thread (j mod blockDim.x): that
// thread may read it after its own __pipeline_wait_prior, before the
// barrier, to derive other values of the record (walk_batches' derive).
template <int kBatch, class Addr>
__device__ __forceinline__ void issue_own(float* buf, int rs, const int* ids,
                                          Batch s, int at, Addr addr) {
  for (int j = threadIdx.x; j < kBatch; j += blockDim.x) {
    float* dst = buf + j * rs + at;
    if (j >= s.lo && j < s.hi) {
      __pipeline_memcpy_async(dst, addr(static_cast<int64_t>(ids[j])),
                              sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
}

// Walks the batches 0 .. n - 1 of a tile, batch b in buffer b & 1:
// ids(b) starts the copies of batch b's ids, records(b) those of its
// records (its ids are in place), derive(b) runs once this thread's
// copies of batch b have landed, and body(b) works on batch b while the
// records of batch b + 1 and the ids of batch b + 2 are copied. One
// barrier a batch: it frees the batch's buffer and publishes the next.
// Where body returns a bool, the barrier counts it
// (__syncthreads_count), and the walk ends after the batch at which every
// thread of the block returned true.
template <class Ids, class Records, class Derive, class Body>
__device__ __forceinline__ void walk_batches(int n, Ids ids, Records records,
                                             Derive derive, Body body) {
  if (n <= 0) return;  // uniform over the block
  ids(0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  records(0);
  if (n > 1) ids(1);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  derive(0);
  __syncthreads();
  for (int b = 0; b < n; ++b) {
    if (b + 1 < n) records(b + 1);
    if (b + 2 < n) ids(b + 2);
    __pipeline_commit();
    if constexpr (std::is_void_v<decltype(body(b))>) {
      body(b);
      __pipeline_wait_prior(0);
      if (b + 1 < n) derive(b + 1);
      __syncthreads();
    } else {
      const bool done = body(b);
      __pipeline_wait_prior(0);
      if (b + 1 < n) derive(b + 1);
      if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    }
  }
}

// f(std::integral_constant<int, cg>()) for a channel group 1 <= cg <=
// kMaxGroup: the kernel instantiated for the group.
template <class F>
cudaError_t for_group(int cg, F f) {
  switch (cg) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}
static_assert(kMaxGroup == 8, "for_group lists the groups 1 .. kMaxGroup");

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM of `kernel` launched
// with `threads` threads and `smem` bytes.
template <class K>
cudaError_t kernel_attributes(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace gsl
