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
// so the host never waits for it), so one thread per (Gaussian, output column) walks the
// Gaussian's slots and adds that column of each valid row, in slot order:
// no atomics, the same result in every run. Neighbouring threads read
// neighbouring columns of the same row.
//
// Bound on the H100: bytes. Each row is read once (4 R bytes per valid
// slot), each slot's sorted position once (4 bytes) and each offset once
// (8 bytes), and 4 (R + n_abs) bytes per Gaussian are written; the
// additions are one per byte-quadruple read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGeom = 6;  // K3's geometry columns; absolute sums follow them

__global__ void reduce_grads_kernel(
    const float* __restrict__ rows,       // [>= n_valid, R]
    int n_cols,                           // R
    int n_abs,                            // absolute sums behind kGeom
    const int64_t* __restrict__ offsets,  // [N] first slot of each Gaussian
    int64_t total,                        // slots, dummies included
    const int* __restrict__ inv_order,    // [total] slot -> sorted position
    const int64_t* __restrict__ n_valid_ptr,  // [1] valid sorted positions
    int n,
    float* __restrict__ out) {            // [N, R + n_abs]
  const int64_t n_valid = *n_valid_ptr;
  const int n_out = n_cols + n_abs;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(n) * n_out) return;
  const int g = static_cast<int>(idx / n_out);
  const int v = static_cast<int>(idx - static_cast<int64_t>(g) * n_out);
  const bool absolute = v >= kGeom && v < kGeom + n_abs;
  const int src = v < kGeom ? v : (absolute ? v - kGeom : v - n_abs);
  const int64_t s0 = offsets[g];
  const int64_t s1 = g + 1 < n ? offsets[g + 1] : total;
  float sum = 0.0f;
  for (int64_t s = s0; s < s1; ++s) {
    const int pos = inv_order[s];
    if (pos >= n_valid) continue;  // culled or dummy slot
    const float x = rows[static_cast<int64_t>(pos) * n_cols + src];
    sum += absolute ? fabsf(x) : x;
  }
  out[idx] = sum;
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
  if (n_cols < 1 || n_abs < 0 ||
      (n_abs > 0 && (n_abs > kGeom || kGeom > n_cols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const int64_t work = static_cast<int64_t>(n) * (n_cols + n_abs);
  const int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  reduce_grads_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, n_cols, n_abs, offsets, total, inv_order, n_valid, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
