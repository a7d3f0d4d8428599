// K4: per-Gaussian sums of the per-slot gradient rows that a backward
// kernel wrote.
//
// Replaces gsl_tpu/ops/rasterize_pallas.py::_reduce_kernel (pallas_call in
// _reduce_sorted_rows, reached through _reduce_by_gid for the 3DGS rows and
// from surfel_pallas.py::_surfel_bwd for the surfel rows). Output row g
// holds the sums of the rows' R columns; behind column kGeom it also holds
// the sums of the absolute values of the first n_abs columns. For K3's rows
// (R = 6 + C, n_abs = 2) that is the reference's column order
//   dmx dmy da db dc dop |dmx| |dmy| channel 0..C-1
// where |dmx|, |dmy| sum the absolute values of the per-(tile, Gaussian)
// mean gradients (the AbsGS densification statistic). The surfel rows
// (R = 13 + C) take n_abs = 0.
//
// What the TPU needed and this does not: a second sort of the rows by
// Gaussian id and a windowed one-hot matmul with a carry over a sequential
// grid. A Gaussian's slots are contiguous in expansion order
// (offsets[g] .. offsets[g + 1]) and inv_order maps a slot to its sorted
// position (valid ones come first; their count is read from device memory,
// so the host never waits for it). A block owns a run of consecutive
// Gaussians (run_length) and so one contiguous slot range (slot_runs.cuh),
// which it takes in passes of up to kStageFloats / R slots:
// 1. the pass's sorted positions, read coalesced;
// 2. the valid slots' rows gathered into shared memory in slot order by
//    4-byte cp.async copies (a row of odd R is only 4-byte aligned), all of
//    a thread's in flight at once;
// 3. one thread per (Gaussian, output column) adds its Gaussian's staged
//    rows in slot order and writes the sum; a Gaussian whose slots go on
//    into the next pass leaves its sums so far in shared memory (only the
//    pass's last Gaussian can), and the next pass starts from them.
// Every sum starts at 0 and adds the same values in the same order as one
// thread walking the Gaussian's slots would (the design before): no
// atomics, the same result in every run, bit for bit that design's (a
// Gaussian without slots gets zeros, wherever it sits in the run). One
// thread per (Gaussian, column) walking its slots had one dependent pair
// of random loads (inv_order, then the row) in flight at a time, and was
// bound by their latency. Here a block waits three round trips (offsets,
// positions, rows) per pass, and eight blocks of 32 registers per SM
// overlap them; a stage of 16 KB left more of the SM to L1 and to resident
// blocks than larger ones (NVIDIA H100, scripts/torch_kernel_parts.py).
//
// Bound on the H100: bytes. Each row is read once (4 R bytes per valid
// slot), each slot's sorted position once (4 bytes) and each offset once
// (8 bytes), and 4 (R + n_abs) bytes per Gaussian are written; the
// additions are one per byte-quadruple read. A row at a random 4-byte
// offset spans two or three 32-byte sectors, so the sectors the rows
// occupy are 1.8 times their bytes at R = 9 and 1.4 times at R = 19 (the
// bench scene).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "slot_runs.cuh"
#include "tile_batches.cuh"

namespace {

constexpr int kGeom = 6;  // K3's geometry columns; absolute sums follow them
constexpr int kThreads = 256;
constexpr int kMaxRun = 256;        // Gaussians a block owns, at most
constexpr int kStageFloats = 4096;  // row values staged a pass

__host__ __device__ inline int pass_slots(int n_cols) {
  return kStageFloats / n_cols > 1 ? kStageFloats / n_cols : 1;
}

// Gaussians a block owns: a power of two from 32 to kMaxRun that one pass
// holds with a quarter to spare at the mean slots per Gaussian (128 for
// K3's rows of the bench scene, 64 for K7's). Smaller shared memory (more
// resident blocks and L1) and whole runs in one pass both paid on the card.
int run_length(int n_cols, int64_t total, int n) {
  const double per_gaussian = n > 0 && total > n ? double(total) / n : 1.0;
  int run = kMaxRun;
  while (run > 32 && 1.25 * run * per_gaussian > pass_slots(n_cols)) {
    run >>= 1;
  }
  return run;
}

// shared words: a run's offsets (kMaxRun + 1, padded), two carries of
// R + n_abs sums, a pass's sorted positions and its rows [pass, R]
size_t smem_bytes(int n_cols, int n_abs) {
  const size_t pass = pass_slots(n_cols);
  return sizeof(float) * (kMaxRun + 4 +
                          2 * static_cast<size_t>(n_cols + n_abs) +
                          pass * (1 + n_cols));
}

__global__ void __launch_bounds__(kThreads) reduce_grads_kernel(
    const float* __restrict__ rows,       // [>= n_valid, R]
    int n_cols,                           // R
    int n_abs,                            // absolute sums behind kGeom
    const int64_t* __restrict__ offsets,  // [N] first slot of each Gaussian
    int64_t total,                        // slots, dummies included
    const int* __restrict__ inv_order,    // [total] slot -> sorted position
    const int64_t* __restrict__ n_valid_ptr,  // [1] valid sorted positions
    int n,
    int run_len,                          // Gaussians a block owns
    float* __restrict__ out) {            // [N, R + n_abs]
  extern __shared__ __align__(16) float smem[];
  const int n_out = n_cols + n_abs;
  const int pass = pass_slots(n_cols);
  int* s_off = reinterpret_cast<int*>(smem);
  float* s_carry = smem + kMaxRun + 4;  // [2][n_out], by the pass's parity
  int* s_pos = reinterpret_cast<int*>(s_carry + 2 * n_out);
  float* s_row = reinterpret_cast<float*>(s_pos + pass);
  const int t = threadIdx.x;
  const int64_t n_valid = *n_valid_ptr;
  const gsl::SlotRun run = gsl::stage_run(offsets, n, run_len, total, s_off);
  // this thread's output columns (one where R + n_abs <= kThreads), for
  // every i_step-th Gaussian
  const int span = min(n_out, kThreads);
  const int i0 = t / span;
  const int i_step = kThreads / span;
  // kThreads (slot, column) pairs further on
  const int row_step = kThreads / n_cols, col_step = kThreads % n_cols;
  // one pass at least: a run of Gaussians without slots writes zeros
  for (int b = 0, parity = 0; b == 0 || b < run.slots;
       b += pass, parity ^= 1) {
    const int cnt = min(pass, run.slots - b);
    for (int j = t; j < cnt; j += kThreads) {
      const int pos = inv_order[run.s0 + b + j];
      s_pos[j] = pos < n_valid ? pos : -1;  // -1: culled or dummy slot
    }
    __syncthreads();
    // value idx = j * R + c of the pass's rows, every kThreads-th a thread,
    // copied with cp.async: all of a thread's copies in flight at once
    int j = t / n_cols;
    int c = t - j * n_cols;
    for (int idx = t; idx < cnt * n_cols; idx += kThreads) {
      const int pos = s_pos[j];
      if (pos >= 0) {
        __pipeline_memcpy_async(
            s_row + idx, rows + static_cast<int64_t>(pos) * n_cols + c,
            sizeof(float));
      }
      j += row_step;
      c += col_step;
      if (c >= n_cols) {
        c -= n_cols;
        ++j;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // the Gaussians with slots in this pass, and those without slots that
    // start at it (and, in the run's last pass, that end the run): all of
    // the run's where one pass holds them. The first may have begun in the
    // pass before (its sums so far in the carry), the last may go on into
    // the next (its sums into the other carry).
    const bool ends_run = b + cnt == run.slots;
    int first = b == 0 ? 0 : gsl::slot_owner(s_off, run.count, b);
    while (first > 0 && s_off[first - 1] == b) --first;
    const int last = ends_run ? run.count - 1
                           : gsl::slot_owner(s_off, run.count, b + cnt - 1);
    for (int v = t % span; i0 < i_step && v < n_out; v += span) {
      const bool absolute = v >= kGeom && v < kGeom + n_abs;
      const int src = v < kGeom ? v : (absolute ? v - kGeom : v - n_abs);
      for (int i = first + i0; i <= last; i += i_step) {
        const int lo = s_off[i] - b;
        const int hi = s_off[i + 1] - b;
        float sum = lo < 0 ? s_carry[parity * n_out + v] : 0.0f;
        for (int k = max(lo, 0); k < min(hi, cnt); ++k) {
          if (s_pos[k] < 0) continue;
          const float x = s_row[k * n_cols + src];
          sum += absolute ? fabsf(x) : x;
        }
        if (hi > cnt) {
          s_carry[(parity ^ 1) * n_out + v] = sum;
        } else {
          out[static_cast<int64_t>(run.g0 + i) * n_out + v] = sum;
        }
      }
    }
    if (b + pass < run.slots) __syncthreads();  // uniform over the block
  }
}

// The dynamic shared bytes of the kernel for R = n_cols; 0 where R and
// n_abs are refused: R above ~4,000, whose pass of one slot would need more
// than the default 48 KB, or absolute sums the rows do not have.
size_t prepare(int n_cols, int n_abs, cudaError_t* err) {
  const bool taken = n_cols >= 1 && n_abs >= 0 &&
                     (n_abs == 0 || (n_abs <= kGeom && kGeom <= n_cols)) &&
                     smem_bytes(n_cols, n_abs) <= 48 * 1024;
  *err = taken ? cudaSuccess : cudaErrorInvalidValue;
  return taken ? smem_bytes(n_cols, n_abs) : 0;
}

}  // namespace

extern "C" {

const char* gsl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gsl_reduce_grads(const float* rows, int n_cols, int n_abs,
                     const int64_t* offsets, int64_t total,
                     const int* inv_order, const int64_t* n_valid, int n,
                     float* out, void* stream) {
  cudaError_t err;
  const size_t smem = prepare(n_cols, n_abs, &err);
  // a run's slots fit an int, as inv_order's positions do
  if (err == cudaSuccess && total > INT32_MAX) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int run = run_length(n_cols, total, n);
  reduce_grads_kernel<<<(n + run - 1) / run, kThreads, smem, s>>>(
      rows, n_cols, n_abs, offsets, total, inv_order, n_valid, n, run, out);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block and resident blocks per SM for R = n_cols.
int gsl_reduce_grads_attributes(int n_cols, int n_abs, int* out) {
  cudaError_t err;
  const size_t smem = prepare(n_cols, n_abs, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      gsl::kernel_attributes(reduce_grads_kernel, kThreads, smem, out));
}

}  // extern "C"
