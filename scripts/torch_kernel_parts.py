"""Cost of each part of six hand-written kernels of the PyTorch port, on one
CUDA card: the forward kernels K2 (csrc/rasterize_fwd.cu), K2s
(csrc/rasterize_fwd_stp.cu) and K6 (csrc/surfel_fwd.cu), and the backward
kernels K3 (csrc/rasterize_bwd.cu), K3s (csrc/rasterize_bwd_stp.cu) and K7
(csrc/surfel_bwd.cu).

    python3 scripts/torch_kernel_parts.py [--kernels K2,K2s,K3,K6,K3s,K7]
                                          [--previous DIR]

Each part is removed in turn by a preprocessor switch that this script
writes into a copy of the kernel's source under gsl_tpu_torch/build/parts/
(the package's sources stay as they are), and every copy is timed with CUDA
events at chip_smoke.py's bench scene (1M Gaussians or surfels, 1088x1920,
bench pose; K2, K2s, K3 and K3s at C = 3, K6 and K7 at C = 6) beside the
copy with nothing removed, which is timed first and last. A copy with a
part removed computes wrong results: only its time is read. Where a part
decides something (a test, a vote, an order), its result stays in what the
kernel writes, so the compiler cannot delete the work before it. The parts
of the kernels as they are:

- K2: the channel sums; everything after the alpha test (the kept pairs
  counted into T); the skip cut (every pair to the exact test); the
  block's early exit (every batch walked); and choices undone: one or four pixels a thread in
  place of two, a register cap of 40 (and of 32 with one pixel a thread,
  also with the alpha test alone or without the skip cut), batches of 32
  or 128 slots in place of 64, the records read with 4-byte loads;
- K2s (with checkpoints, as training calls it): the checkpoint stores; the
  out-of-order path (every window taken as in order, the test kept); the
  skip cut; and choices undone: alpha evaluated again in the out-of-order
  path where pass 1 stores it, batches of 16, 32 or 128 slots in place of
  64, the records read with 4-byte loads;
- K3: the transposed warp sums (each lane adds up its own values instead),
  and everything after the composite test (the gradient and its sums);
  and three choices undone: IEEE divisions for T / (1 - a) and
  S / max(1 - a, 1e-3), batches of 32 slots in place of 64, and the
  slots' records read with 4-byte loads;
- K6: everything after the solve but the transmittance and the stop; and
  three choices undone: one solve a step in place of two, the records read
  with 4-byte loads, and batches of 32 or 128 slots in place of 64;
- K3s: the transposed warp sums, the out-of-order lanes' path (every
  window taken as in order), pass 2 (the gradient), and both; and two
  choices undone: pass 2 unrolled, and a build for 3 blocks per SM;
- K7: the transposed warp sums, and everything after the solve, once as
  commit 173d447 removed it (right after an unused vote, which lets the
  compiler delete the solve too) and once after the vote is recorded; and
  two choices undone: the six IEEE divisions by cz and Tw.z in place of
  the two reciprocals, and a build for 3 blocks per SM.

With --previous DIR, also K2 and K2s as they were before their redesign,
from DIR/gsl_tpu_torch/csrc (`git archive 48a8ffb gsl_tpu_torch/csrc | tar
-x -C DIR`): K2 without its channel sums, with everything after the alpha
test removed as above, with the six fields read from one record by two
16-byte loads in place of six strided 4-byte loads, with the batch
gathered once (and the barrier after the gather passed only then), without
the block's exit count, and with batches of 64 slots in place of 256; K2s
without its checkpoint stores, without the out-of-order path, without the
120-compare rank count (ranks taken as the identity), with the nine fields
read from one record by three 16-byte loads, and with the batch gathered
once (and its two barriers passed only then). Each "whole" copy's outputs
are compared with the package's kernel's: K2's out, T and i_stop, K2s's
out, T, i_stop and the checkpoint rows the backward reads. (The version of
this script in commit 48a8ffb timed K3 and K6 of commit 1eebc16 the same
way, the one in commit 173d447 K3s and K7 of commit daa6548.)

Prints ptxas's registers and spills, the registers, spills, shared bytes
and resident blocks per SM that the card's runtime reports, every time;
for K2 the tiles' list lengths, the waves of resident blocks and the
(warp, slot) steps of warps of 32 pixels and of 32 threads of two pixels
each; for K2s the (pixel, window)s and their live entries, those out of
order and the (window, warp)s with one; for K3, K3s and K7 the (slot,
warp)s with a composited pixel that the plain versions count; for K6 the
(warp, slot) steps, those in which some lanes of the warp have already
stopped, and the lane steps that idle; writes
chiprun_out/kernel_parts.json.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from gsl_tpu_torch.ops import cuda_build  # noqa: E402
from gsl_tpu_torch.ops import rasterize as R  # noqa: E402
from gsl_tpu_torch.ops import rasterize_stp as STP  # noqa: E402
from gsl_tpu_torch.ops import surfel_rasterize as SR  # noqa: E402
from gsl_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsl_tpu_torch.renderers import tile_renderer  # noqa: E402
from gsl_tpu_torch.utils.convert import state_from_raw_arrays  # noqa: E402

OUT = os.path.join(REPO, "gsl_tpu_torch", "build", "parts")
K2, K2S, K3, K6, K3S, K7 = ("rasterize_fwd", "rasterize_fwd_stp",
                             "rasterize_bwd", "surfel_fwd",
                             "rasterize_bwd_stp", "surfel_bwd")
SHORT = {"K2": K2, "K2s": K2S, "K3": K3, "K6": K6, "K3s": K3S, "K7": K7}
KERNEL_FN = {K2: "rasterize_fwd_kernel", K2S: "rasterize_fwd_stp_kernel",
             K3: "rasterize_bwd_kernel", K6: "rasterize_surfels_fwd_kernel",
             K3S: "rasterize_bwd_stp_kernel",
             K7: "rasterize_surfels_bwd_kernel"}
CHANNELS = {K2: 3, K2S: 3, K3: 3, K6: 6, K3S: 3, K7: 6}

# one more block per SM where the kernel is built for 4 of 256 threads;
# IEEE divisions where the kernel takes approximate ones
CUR_HEAD = ("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
#ifdef GSL_BLOCKS
#define GSL_LB __launch_bounds__(256, GSL_BLOCKS)
#else
#define GSL_LB __launch_bounds__(kMaxThreads)
#endif
#ifdef GSL_IEEE_DIV
#define GSL_DIV(a, b) ((a) / (b))
#else
#define GSL_DIV(a, b) __fdividef(a, b)
#endif
""")


def cur_bounds(name):
    fn = KERNEL_FN[name]
    return (f"__global__ void __launch_bounds__(kMaxThreads) {fn}(",
            f"__global__ void GSL_LB {fn}(")


# the transposed sum replaced by each lane's own total
SUM = ("        const float sum = gsl::warp_transpose_sum<L>(v, lane);\n",
       "#ifdef GSL_NO_SUMS\n        float sum = 0.0f;\n"
       "        for (int kk = 0; kk < L; ++kk) sum += v[kk];\n#else\n"
       "        const float sum = gsl::warp_transpose_sum<L>(v, lane);\n"
       "#endif\n")


def scalar_loads(n):
    """A record read value by value, 4 bytes a load, where it took 16-byte
    loads; `n` names the count of values read."""
    return ("  const float4* r4 = reinterpret_cast<const float4*>(rec);\n",
            "#ifdef GSL_SCALAR_LOADS\n#pragma unroll\n"
            f"  for (int i = 0; i < {n}; ++i) r[i] = rec[i];\n"
            "  return;\n#endif\n"
            "  const float4* r4 = reinterpret_cast<const float4*>(rec);\n")


def scalar_call(indent, n):
    """The record read value by value at the kernel's one call of
    gsl::load_record (tile_batches.cuh), 4 bytes a load; `n` names the count
    of values read."""
    call = f"{indent}gsl::load_record(rec, r);\n"
    return (call, f"#ifdef GSL_SCALAR_LOADS\n{indent}for (int i = 0; i < {n}; "
            f"++i) r[i] = rec[i];\n#else\n{call}#endif\n")


def constant(name, n, macro):
    """`constexpr int name = n;` of the kernel set by the macro."""
    return (f"constexpr int {name} = {n};",
            f"\n#ifdef {macro}\nconstexpr int {name} = {macro};\n#else\n"
            f"constexpr int {name} = {n};\n#endif\n")


def batch(n):
    """kBatch (n in the kernel) set by GSL_BATCH."""
    return constant("kBatch", n, "GSL_BATCH")


# the rest of a (slot, warp) dropped once its vote is recorded in the warp's
# mask: the mask is read by the cross-warp sum, so the vote and what it
# depends on stay in the build (a copy that drops them right after an
# unused vote lets the compiler delete the test or the solve as well)
def after_vote(switch):
    text = "      warp_mask |= Mask{1} << j;\n"
    return (text, f"{text}#ifdef {switch}\n      continue;\n#endif\n")


# K2 and K2s: the checkpoint stores switched off by GSL_NO_CKPT
CKPT_HEAD = ("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
#ifdef GSL_NO_CKPT
#define GSL_STORE_CKPT false
#else
#define GSL_STORE_CKPT true
#endif
""")
CKPT = ("checkpoints != nullptr", "GSL_STORE_CKPT && checkpoints != nullptr")

K2_CURRENT = [
    constant("kBatch", 64, "GSL_BATCH"), constant("kPix", 2, "GSL_PIX"),
    constant("kMaxRegs", 64, "GSL_REGS"), scalar_call(6 * " ", "kLoad"),
    ("        const float w = alpha * T[k];\n",
     "        const float w = alpha * T[k];\n#ifndef GSL_NO_CHANNELS\n"),
    ("        }\n        T[k] = next_t;\n",
     "        }\n#endif\n        T[k] = next_t;\n"),
    # the kept pairs counted into T, nothing else
    ("        if (sigma < 0.0f || alpha < threshold) continue;\n",
     "        if (sigma < 0.0f || alpha < threshold) continue;\n"
     "#ifdef GSL_TEST_ONLY\n        T[k] += 1.0f;\n        continue;\n"
     "#endif\n"),
    # every pair to the exact test
    ("        if (sigma > r[kSkip]) continue;  // alpha < 1/255 for certain\n",
     "#ifndef GSL_NO_SKIP\n"
     "        if (sigma > r[kSkip]) continue;  // alpha < 1/255 for certain\n"
     "#endif\n"),
    # the block walks every batch: no thread reports itself done
    ("    return all_done();\n",
     "#ifdef GSL_NO_COUNT_EXIT\n    return false;\n#else\n"
     "    return all_done();\n#endif\n")]
K2S_CURRENT = [
    CKPT_HEAD, CKPT, constant("kBatch", 64, "GSL_BATCH"),
    scalar_call(8 * " ", "kLoad"),
    # every window as in order; the test and the live mask stay in T
    ("      if (ordered) continue;\n",
     "#ifdef GSL_NO_SLOW\n"
     "      if (!ordered) T += static_cast<float>(live) * 1e-30f;\n"
     "      continue;\n#endif\n      if (ordered) continue;\n"),
    # every entry to the exact test
    ("        if (sigma > r[kSkip]) continue;\n",
     "#ifndef GSL_NO_SKIP\n        if (sigma > r[kSkip]) continue;\n"
     "#endif\n"),
    # the out-of-order path evaluates a again where pass 1 stored it
    ("        const float a = column[l * bs].y;\n",
     "#ifdef GSL_RECOMPUTE\n        float rr[kLoad];\n"
     "        gsl::load_record(s_win + l * RS, rr);\n"
     "        const float a = stp::pair_terms(rr, 1, 0, px, py).a;\n"
     "#else\n        const float a = column[l * bs].y;\n#endif\n")]

CURRENT = {
    K2: (K2_CURRENT,
         {"whole": [], "no_channel_sums": ["GSL_NO_CHANNELS"],
          "alpha_test_only": ["GSL_TEST_ONLY"], "no_skip": ["GSL_NO_SKIP"],
          "no_block_exit": ["GSL_NO_COUNT_EXIT"],
          "registers_40": ["GSL_REGS=40"],
          "one_pixel_a_thread": ["GSL_PIX=1"],
          "four_pixels_a_thread": ["GSL_PIX=4"],
          "one_pixel_registers_32": ["GSL_PIX=1", "GSL_REGS=32"],
          "one_pixel_test_only_registers_32": ["GSL_PIX=1", "GSL_REGS=32",
                                               "GSL_TEST_ONLY"],
          "one_pixel_no_skip_registers_32": ["GSL_PIX=1", "GSL_REGS=32",
                                             "GSL_NO_SKIP"],
          "batch_32": ["GSL_BATCH=32"], "batch_128": ["GSL_BATCH=128"],
          "scalar_loads": ["GSL_SCALAR_LOADS"]}),
    K2S: (K2S_CURRENT,
          {"whole": [], "no_checkpoint_stores": ["GSL_NO_CKPT"],
           "no_out_of_order_path": ["GSL_NO_SLOW"],
           "no_skip": ["GSL_NO_SKIP"], "a_recomputed": ["GSL_RECOMPUTE"],
           "batch_16": ["GSL_BATCH=16"], "batch_32": ["GSL_BATCH=32"],
           "batch_128": ["GSL_BATCH=128"],
           "scalar_loads": ["GSL_SCALAR_LOADS"]}),
    K3: ([SUM, CUR_HEAD, cur_bounds(K3), scalar_loads("N"), batch(64),
          after_vote("GSL_TEST_ONLY"),
          ("__fdividef(T, one_minus)", "GSL_DIV(T, one_minus)"),
          ("__fdividef(S, fmaxf(one_minus, min_one_minus))",
           "GSL_DIV(S, fmaxf(one_minus, min_one_minus))")],
         {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
          "composite_test_only": ["GSL_TEST_ONLY"],
          "ieee_divisions": ["GSL_IEEE_DIV"],
          "batch_32": ["GSL_BATCH=32"],
          "scalar_loads": ["GSL_SCALAR_LOADS"]}),
    K6: ([CUR_HEAD, cur_bounds(K6), scalar_loads("kLoad"), batch(64),
          ("      const float w = t.alpha * T;\n",
           "#ifdef GSL_SOLVE_ONLY\n      T = next_t;\n      return;\n"
           "#endif\n      const float w = t.alpha * T;\n"),
          # one slot a step
          ("    for (int j = 0; j < count; j += 2) {\n",
           "#ifdef GSL_ONE_SOLVE\n    for (int j = 0; j < count; ++j) {\n"
           "      if (__all_sync(kFullMask, done)) break;\n"
           "      const float* rec = s_rec + j * RS;\n"
           "      float sg[kLoad];\n      load_record(rec, sg);\n"
           "      composite(surfel::solve(sg, 1, px, py), sg, rec, j);\n"
           "    }\n    for (int j = count; j < count; j += 2) {\n#else\n"
           "    for (int j = 0; j < count; j += 2) {\n#endif\n")],
         {"whole": [], "solve_and_stop_only": ["GSL_SOLVE_ONLY"],
          "one_solve_a_step": ["GSL_ONE_SOLVE"],
          "scalar_loads": ["GSL_SCALAR_LOADS"],
          "batch_32": ["GSL_BATCH=32"], "batch_128": ["GSL_BATCH=128"]}),
    K3S: ([SUM, CUR_HEAD, cur_bounds(K3S),
           ("#pragma unroll 1\n    for (int l = kW - 1; l >= 0; --l) {",
            "#ifdef GSL_UNROLL_PASS2\n#pragma unroll\n#else\n"
            "#pragma unroll 1\n#endif\n"
            "    for (int l = kW - 1; l >= 0; --l) {"),
           ("    if (!ordered) {",
            "\n#ifdef GSL_NO_SLOW\n    ordered = true;\n#endif\n"
            "    if (!ordered) {"),
           ("      if (!__any_sync(kFullMask, comp)) continue;",
            "\n#ifdef GSL_NO_PASS2\n      continue;\n#endif\n"
            "      if (!__any_sync(kFullMask, comp)) continue;")],
          {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
           "no_out_of_order_path": ["GSL_NO_SLOW"],
           "no_pass2": ["GSL_NO_PASS2"],
           "no_pass2_no_out_of_order_path": ["GSL_NO_SLOW", "GSL_NO_PASS2"],
           "pass2_unrolled": ["GSL_UNROLL_PASS2"],
           "three_blocks_per_sm": ["GSL_BLOCKS=3"]}),
    K7: ([SUM, CUR_HEAD, cur_bounds(K7), after_vote("GSL_SOLVE_KEPT"),
          ("      if (!__any_sync(kFullMask, comp)) continue;  // uniform over "
           "the warp\n",
           "      if (!__any_sync(kFullMask, comp)) continue;\n"
           "#ifdef GSL_SOLVE_ONLY\n      continue;\n#endif\n"),
          # the six IEEE divisions by cz and Tw.z in place of the reciprocals
          ("      const float icz = 1.0f / t.cz;\n",
           "#ifdef GSL_DIVIDE\n#define GSL_BY_CZ(x) ((x) / t.cz)\n"
           "#define GSL_BY_TWZ(x) ((x) / surfel::safe_twz(sg[8]))\n"
           "#define GSL_BY_TWZ2(x) ((x) / (surfel::safe_twz(sg[8]) * "
           "surfel::safe_twz(sg[8])))\n#else\n"
           "#define GSL_BY_CZ(x) ((x) * icz)\n#define GSL_BY_TWZ(x) "
           "((x) * itwz)\n#define GSL_BY_TWZ2(x) ((x) * (itwz * itwz))\n"
           "#endif\n      const float icz = 1.0f / t.cz;\n"),
          ("du * icz;", "GSL_BY_CZ(du);"), ("dv * icz;", "GSL_BY_CZ(dv);"),
          ("-(du * t.u + dv * t.v) * icz;",
           "GSL_BY_CZ(-(du * t.u + dv * t.v));"),
          ("dcxp * itwz,", "GSL_BY_TWZ(dcxp),"),
          ("dcyp * itwz,", "GSL_BY_TWZ(dcyp),"),
          ("(dcxp * sg[6] + dcyp * sg[7]) * (itwz * itwz),",
           "GSL_BY_TWZ2(dcxp * sg[6] + dcyp * sg[7]),")],
         {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
          "solve_only": ["GSL_SOLVE_ONLY"],
          "solve_only_vote_kept": ["GSL_SOLVE_KEPT"],
          "six_divisions": ["GSL_DIVIDE"],
          "three_blocks_per_sm": ["GSL_BLOCKS=3"]}),
}

# K2 and K2s before their redesign (commit 48a8ffb)
OLD_HEAD = ("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
#ifndef GSL_BATCH
#define GSL_BATCH bs
#endif
#ifdef GSL_ONE_RECORD
#define GSL_WORDS 12
#else
#define GSL_WORDS 6
#endif
#ifdef GSL_NO_CKPT
#define GSL_STORE_CKPT false
#else
#define GSL_STORE_CKPT true
#endif
""")
OLD_ATTRS = """
extern "C" int gsl_parts_attributes(int C, int ts, int* out) {
  const int bs = ts * ts;
  const size_t words = %(words)s;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, %(fn)s<%(ct)d>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, %(fn)s<%(ct)d>, bs, words * 4);
  out[0] = attr.numRegs; out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(words * 4); out[3] = blocks;
  return (int)err;
}
"""
OLD_K2 = [
    OLD_HEAD,
    ("      for (int c = 0; c < CG; ++c) acc[c] += w * s_col[c * bs + j];\n",
     "#ifndef GSL_NO_CHANNELS\n"
     "      for (int c = 0; c < CG; ++c) acc[c] += w * s_col[c * bs + j];\n"
     "#endif\n"),
    ("      if (sigma < 0.0f || alpha < threshold) continue;\n",
     "      if (sigma < 0.0f || alpha < threshold) continue;\n"
     "#ifdef GSL_TEST_ONLY\n      stop += 1;\n      continue;\n#endif\n"),
    # the six fields as one record of 8 floats, read by two 16-byte loads
    ("  float* s_col = s_op + bs;  // [CG, bs]\n",
     "#ifdef GSL_ONE_RECORD\n  float* s_rec = smem;\n"
     "  float* s_col = smem + 8 * bs;\n#else\n"
     "  float* s_col = s_op + bs;  // [CG, bs]\n#endif\n"),
    ("      s_mx[tid] = means2d[2 * g + 0];\n"
     "      s_my[tid] = means2d[2 * g + 1];\n"
     "      s_ca[tid] = conics[3 * g + 0];\n"
     "      s_cb[tid] = conics[3 * g + 1];\n"
     "      s_cc[tid] = conics[3 * g + 2];\n"
     "      s_op[tid] = opacities[g];\n",
     "#ifdef GSL_ONE_RECORD\n"
     "      s_rec[8 * tid + 0] = means2d[2 * g + 0];\n"
     "      s_rec[8 * tid + 1] = means2d[2 * g + 1];\n"
     "      s_rec[8 * tid + 2] = conics[3 * g + 0];\n"
     "      s_rec[8 * tid + 3] = conics[3 * g + 1];\n"
     "      s_rec[8 * tid + 4] = conics[3 * g + 2];\n"
     "      s_rec[8 * tid + 5] = opacities[g];\n#else\n"
     "      s_mx[tid] = means2d[2 * g + 0];\n"
     "      s_my[tid] = means2d[2 * g + 1];\n"
     "      s_ca[tid] = conics[3 * g + 0];\n"
     "      s_cb[tid] = conics[3 * g + 1];\n"
     "      s_cc[tid] = conics[3 * g + 2];\n"
     "      s_op[tid] = opacities[g];\n#endif\n"),
    ("      const float dx = s_mx[j] - px;\n"
     "      const float dy = s_my[j] - py;\n"
     "      const float sigma = 0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) +\n"
     "                          s_cb[j] * dx * dy;\n"
     "      const float alpha = fminf(max_alpha, s_op[j] * expf(-sigma));\n",
     "#ifdef GSL_ONE_RECORD\n"
     "      const float4 ra = reinterpret_cast<const float4*>(s_rec)[2 * j];\n"
     "      const float4 rb = reinterpret_cast<const float4*>(s_rec)[2 * j + 1];\n"
     "      const float dx = ra.x - px;\n"
     "      const float dy = ra.y - py;\n"
     "      const float sigma = 0.5f * (ra.z * dx * dx + rb.x * dy * dy) +\n"
     "                          ra.w * dx * dy;\n"
     "      const float alpha = fminf(max_alpha, rb.y * expf(-sigma));\n"
     "#else\n"
     "      const float dx = s_mx[j] - px;\n"
     "      const float dy = s_my[j] - py;\n"
     "      const float sigma = 0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) +\n"
     "                          s_cb[j] * dx * dy;\n"
     "      const float alpha = fminf(max_alpha, s_op[j] * expf(-sigma));\n"
     "#endif\n"),
    ("static_cast<size_t>(6 + CG) * bs", "static_cast<size_t>(GSL_WORDS + CG) * bs"),
    # the first batch gathered and no other, the barrier after the gather
    # passed only then; batches of GSL_BATCH slots
    ("    const int64_t idx = base + tid;\n    if (idx < end) {\n",
     "    const int64_t idx = base + tid;\n#ifdef GSL_GATHER_ONCE\n"
     "    const bool gather = base == start;\n#else\n"
     "    const bool gather = true;\n#endif\n"
     "    if (gather && tid < GSL_BATCH && idx < end) {\n"),
    ("    __syncthreads();\n    const int count = static_cast<int>("
     "end - base < bs ? end - base : bs);\n",
     "    if (gather) __syncthreads();\n    const int count = static_cast<int>("
     "end - base < GSL_BATCH ? end - base : GSL_BATCH);\n"),
    ("base < end; base += bs) {", "base < end; base += GSL_BATCH) {"),
    ("    if (__syncthreads_count(done) == bs) break;\n",
     "#ifdef GSL_NO_COUNT_EXIT\n    __syncthreads();\n#else\n"
     "    if (__syncthreads_count(done) == bs) break;\n#endif\n")]
OLD_K2S = [
    OLD_HEAD, CKPT,
    ("      if (stp::in_order(a, d)) {",
     "#ifdef GSL_NO_SLOW\n      if (!stp::in_order(a, d)) T += 1e-30f;\n"
     "      if (true) {\n#else\n      if (stp::in_order(a, d)) {\n#endif"),
    ("        const uint64_t ranks = stp::count_ranks(d);\n",
     "#ifdef GSL_NO_RANKS\n        const uint64_t ranks = stp::kIdentity;\n"
     "#else\n        const uint64_t ranks = stp::count_ranks(d);\n#endif\n"),
    # the nine fields as one record of 12 floats, read by three 16-byte
    # loads
    ("  float* s_col = s_geom + stp::kFields * bs;   // [CG, bs]\n",
     "  float* s_col = s_geom + (GSL_WORDS == 12 ? 12 : stp::kFields) * bs;\n"),
    ("      s_geom[f * bs + tid] =\n",
     "      s_geom[GSL_WORDS == 12 ? tid * 12 + f : f * bs + tid] =\n"),
    ("        const stp::Pair p = stp::pair_terms(s_geom, bs, first + l, px, "
     "py);\n",
     "#ifdef GSL_ONE_RECORD\n        float rr[12];\n"
     "        const float4* r4 = reinterpret_cast<const float4*>(s_geom) + "
     "3 * (first + l);\n"
     "        for (int i = 0; i < 3; ++i) {\n"
     "          rr[4 * i] = r4[i].x; rr[4 * i + 1] = r4[i].y;\n"
     "          rr[4 * i + 2] = r4[i].z; rr[4 * i + 3] = r4[i].w;\n        }\n"
     "        const stp::Pair p = stp::pair_terms(rr, 1, 0, px, py);\n#else\n"
     "        const stp::Pair p = stp::pair_terms(s_geom, bs, first + l, px, "
     "py);\n#endif\n"),
    ("static_cast<size_t>(stp::kFields + CG + stp::kWindow)",
     "static_cast<size_t>((GSL_WORDS == 12 ? 12 : stp::kFields) + CG + "
     "stp::kWindow)"),
    # the first batch gathered and no other, its two barriers passed only
    # then
    ("    __syncthreads();  // the previous batch has been composited\n",
     "#ifdef GSL_GATHER_ONCE\n    if (base == start - start % stp::kWindow) "
     "{\n#else\n    {\n#endif\n"
     "    __syncthreads();  // the previous batch has been composited\n"),
    ("    for (int c = 0; c < CG; ++c) s_col[c * bs + tid] = in_range ? "
     "col[c] : 0.0f;\n    __syncthreads();\n",
     "    for (int c = 0; c < CG; ++c) s_col[c * bs + tid] = in_range ? "
     "col[c] : 0.0f;\n    __syncthreads();\n    }\n")]
PREVIOUS = {
    K2: (OLD_K2,
         {"whole": [], "no_channel_sums": ["GSL_NO_CHANNELS"],
          "alpha_test_only": ["GSL_TEST_ONLY"],
          "one_record": ["GSL_ONE_RECORD"],
          "gather_once": ["GSL_GATHER_ONCE"],
          "no_block_exit": ["GSL_NO_COUNT_EXIT"],
          "batch_64": ["GSL_BATCH=64"]}),
    K2S: (OLD_K2S,
          {"whole": [], "no_checkpoint_stores": ["GSL_NO_CKPT"],
           "no_out_of_order_path": ["GSL_NO_SLOW"],
           "no_rank_count": ["GSL_NO_RANKS"],
           "one_record": ["GSL_ONE_RECORD"],
           "gather_once": ["GSL_GATHER_ONCE"]}),
}
OLD_WORDS = {
    K2: dict(ct=3, fn=KERNEL_FN[K2],
             words="(size_t)(GSL_WORDS + C) * bs"),
    K2S: dict(ct=3, fn=KERNEL_FN[K2S],
              words="(size_t)((GSL_WORDS == 12 ? 12 : stp::kFields) + C + "
                    "stp::kWindow) * bs"),
}
ATTRS = {K2: "gsl_rasterize_fwd_attributes",
         K2S: "gsl_rasterize_fwd_stp_attributes",
         K3: "gsl_rasterize_bwd_attributes",
         K6: "gsl_rasterize_surfels_fwd_attributes",
         K3S: "gsl_rasterize_bwd_stp_attributes",
         K7: "gsl_rasterize_surfels_bwd_attributes"}


def table(design, name):
    return (CURRENT if design == "current" else PREVIOUS).get(name)


def write_copy(design, name, csrc):
    """The kernel's source with the design's switches, and an entry point
    for its attributes."""
    patches = table(design, name)[0]
    text = open(os.path.join(csrc, f"{name}.cu")).read()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{design} {name}.cu: the text to switch was "
                             f"not found once: {old!r}")
        text = text.replace(old, new)
    if design == "current":
        text += ('\nextern "C" int gsl_parts_attributes(int C, int ts, int* '
                 f'out) {{\n  return {ATTRS[name]}(C, ts, out);\n}}\n')
    else:
        text += OLD_ATTRS % OLD_WORDS[name]
    path = os.path.join(OUT, f"{design}_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(designs, names):
    """Every variant, one nvcc each, all started together."""
    nvcc = cuda_build._nvcc()
    jobs = {}
    os.makedirs(OUT, exist_ok=True)
    for design, csrc in designs.items():
        for name in names:
            if table(design, name) is None:
                continue
            src = write_copy(design, name, csrc)
            for variant, defines in table(design, name)[1].items():
                lib = os.path.join(OUT, f"{design}_{name}_{variant}.so")
                cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-I", csrc,
                       *(f"-D{d}" for d in defines), "-o", lib, src]
                jobs[(design, name, variant)] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{text}")
        used = [line.split(":", 1)[-1].strip() for line in text.splitlines()
                if "Used" in line or "bytes spill" in line]
        print(f"{' '.join(key)}: ptxas {' | '.join(used)}", flush=True)
        libs[key] = ctypes.CDLL(lib)
        libs[key].gsl_error_string.argtypes = [ctypes.c_int]
        libs[key].gsl_error_string.restype = ctypes.c_char_p
    return libs


def attributes(lib, C):
    lib.gsl_parts_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    cuda_build.check(lib, lib.gsl_parts_attributes(C, CS.TILE, out),
                     "attributes")
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2], "blocks_per_sm": out[3]}


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def bench_projection(arrays):
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = tile_renderer.TileRendererConfig().instantiate()
    cam = CS.camera(np.eye(4))
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, CS.W, CS.H)
    opac = renderer.get_opacities(state, proj).contiguous()
    ch = CS.channels_for(state, renderer, proj, cam, 3)
    return proj, opac, ch


def k2_inputs(arrays):
    """The bench pose at C = 3, as chip_smoke.phase_kernels builds it: K2's
    wrapper's arguments."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    proj, opac, ch = bench_projection(arrays)
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    isects = R.isect_encode(proj, H, W, TILE)
    keys, gids = R.expand(isects, m2d, con, opac, proj.depths.contiguous(),
                          tiles_x, tiles_y, TILE, True)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    gs = gs[:int(bounds[-1])].contiguous()
    return (m2d, con, opac, ch, gs, bounds, H, W, TILE)


def k3_inputs(arrays):
    """K3's wrapper's arguments at K2's inputs, after K2."""
    fwd = k2_inputs(arrays)
    H, W = fwd[6:8]
    _, t_fin, stop = R.rasterize_fwd(*fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_out = torch.randn((H, W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    return fwd[:6] + (g_out, g_alpha, t_fin, stop, fwd[8])


def k2s_inputs(arrays):
    """The bench pose at C = 3, as chip_smoke.check_stp_kernels builds it:
    K2s's wrapper's arguments."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    proj, opac, ch = bench_projection(arrays)
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
    isects = R.isect_encode(proj, H, W, TILE)
    keys, gids = R.expand(isects, m2d, con, opac, depths, tiles_x, tiles_y,
                          TILE, True, True, kz)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    return (m2d, con, opac, ch, depths, kz, gs, bounds, H, W, TILE)


def k3s_inputs(arrays):
    """K3s's wrapper's arguments at K2s's inputs, after K2s."""
    fwd = k2s_inputs(arrays)
    H, W, TILE = fwd[8:]
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    g_out = torch.randn((H, W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    return fwd[:8] + (g_out, g_alpha, t_fin, ckpt, TILE)


def k6_inputs(arrays):
    """The bench pose at C = 6, as chip_smoke.check_surfel_kernels builds
    it: the wrapper's arguments."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    state = state_from_raw_arrays(CS.surfel_arrays(arrays), device="cuda")
    proj, geom, ch = CS.surfel_inputs(state, CS.camera(np.eye(4)), 6)
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    H, W, TILE)
    keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(), tiles_x,
                                  tiles_y)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    return (geom, ch, gs, bounds, H, W, TILE)


def k7_inputs(arrays):
    """The bench pose at C = 6, as chip_smoke.check_surfel_kernels builds
    it: the wrapper's arguments."""
    H, W = CS.H, CS.W
    geom, ch, gs, bounds, _, _, TILE = k6_inputs(arrays)
    _, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TILE)
    gen = torch.Generator(device="cuda").manual_seed(10)
    g_out = torch.randn((H, W, 6), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    return (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)


def launcher(name, lib, args, outs):
    """A call of the copy's C entry point on the wrapper's arguments,
    writing into `outs`."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    H, W = CS.H, CS.W
    tiles_x, tiles_y = -(-W // CS.TILE), -(-H // CS.TILE)
    grid = (tiles_x * tiles_y, tiles_x, CS.TILE, H, W)
    if name == K2:
        fn = lib.gsl_rasterize_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4)
        C = args[3].shape[1]
        call = (*map(ptr, args[:4]), C, 0, C, ptr(args[4]), ptr(args[5]),
                *grid, *map(ptr, outs), stream)
    elif name == K2S:
        fn = lib.gsl_rasterize_fwd_stp
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        C = args[3].shape[1]
        call = (*map(ptr, args[:6]), C, 0, C, ptr(args[6]), ptr(args[7]),
                *grid, *map(ptr, outs), stream)
    elif name == K3:
        fn = lib.gsl_rasterize_bwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 6)
        call = (*map(ptr, args[:4]), args[3].shape[1], ptr(args[4]),
                ptr(args[5]), *grid, *map(ptr, args[6:10]), ptr(outs[0]),
                stream)
    elif name == K6:
        fn = lib.gsl_rasterize_surfels_fwd
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4)
        C = args[1].shape[1]
        call = (ptr(args[0]), ptr(args[1]), C, 0, C, ptr(args[2]),
                ptr(args[3]), *grid, *map(ptr, outs), stream)
    elif name == K3S:
        fn = lib.gsl_rasterize_bwd_stp
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 6)
        call = (*map(ptr, args[:6]), args[3].shape[1], ptr(args[6]),
                ptr(args[7]), *grid, *map(ptr, args[8:12]), ptr(outs[0]),
                stream)
    else:
        fn = lib.gsl_rasterize_surfels_bwd
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        call = (ptr(args[0]), ptr(args[1]), args[1].shape[1], ptr(args[2]),
                ptr(args[3]), *grid, *map(ptr, args[4:8]), ptr(outs[0]),
                stream)
    return lambda: cuda_build.check(lib, fn(*call), name)


WRAPPERS = {K2: R.rasterize_fwd,
            K2S: lambda *a: STP.rasterize_fwd_stp(*a, checkpoints=True),
            K3: R.rasterize_bwd, K6: SR.rasterize_surfels_fwd,
            K3S: STP.rasterize_bwd_stp, K7: SR.rasterize_surfels_bwd}
INPUTS = {K2: k2_inputs, K2S: k2s_inputs, K3: k3_inputs, K6: k6_inputs,
          K3S: k3s_inputs, K7: k7_inputs}


def rows_read(bounds, n_rows):
    """The checkpoint rows K3s reads: those of the windows of the tiles
    with slots (window k of tile t at row bounds[t] // 16 + k + t)."""
    st, en = bounds[:-1], bounds[1:]
    tl = torch.arange(st.numel(), device=bounds.device)
    keep = en > st
    mark = torch.zeros(n_rows + 1, dtype=torch.int64, device=bounds.device)
    mark.index_add_(0, (st // STP.STP_WINDOW + tl)[keep],
                    torch.ones_like(st[keep]))
    mark.index_add_(0, ((en - 1) // STP.STP_WINDOW + tl + 1)[keep],
                    -torch.ones_like(st[keep]))
    return mark.cumsum(0)[:-1] > 0


def same_outputs(name, outs, want, args):
    """Per output, whether a copy's equals the package's kernel's; K2s's
    checkpoints on the rows the backward reads (the others are never
    written)."""
    if name != K2S:
        return [torch.equal(o, w) for o, w in zip(outs, want)]
    rows = rows_read(args[7], want[3].shape[0])
    return [*(torch.equal(o, w) for o, w in zip(outs[:3], want[:3])),
            torch.equal(outs[3][rows], want[3][rows])]


def time_kernel(name, libs, designs, args):
    wrapper = WRAPPERS[name]
    want = wrapper(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = [torch.zeros_like(t) for t in want]
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    result = {"wrapper_ms": CS.cuda_ms(lambda: wrapper(*args), 20),
              "identical_in_two_runs": same_outputs(name, again, want,
                                                    args)}
    print(f"{name} package's kernel: {result['wrapper_ms']:.4f} ms through "
          f"its wrapper; outputs identical in two runs: "
          f"{result['identical_in_two_runs']}", flush=True)
    for design in designs:
        if table(design, name) is None:
            continue
        for variant in [*table(design, name)[1], "whole"]:
            lib = libs[(design, name, variant)]
            run = launcher(name, lib, args, outs)
            run()
            torch.cuda.synchronize()
            ms = CS.cuda_ms(run, 20)
            same = (same_outputs(name, outs, want, args)
                    if variant == "whole" else None)
            attrs = attributes(lib, CHANNELS[name])
            entry = result.setdefault(design, {}).setdefault(variant, {
                "ms": [], **attrs})
            entry["ms"].append(ms)
            if same is not None:
                entry["equals_package_kernel"] = same
            print(f"{name} {design} {variant}: {ms:.4f} ms {attrs}"
                  + ("" if same is None else
                     f"; output equals the package's kernel's: {same}"),
                  flush=True)
    return result


def k2_counts(args):
    """K2's tiles' list lengths, the waves of resident blocks of the
    package's kernel, and the (warp, slot) steps of warps of 32 pixels
    and of 32 threads of two pixels each (pixels p and p + 128 of a 16 x 16
    tile), a warp walking its list until all its pixels have stopped."""
    gs, bounds, H, W, TILE = args[4:]
    tiles_x = -(-W // TILE)
    _, _, stop = R.rasterize_fwd(*args)
    lengths = (bounds[1:] - bounds[:-1]).float()
    blocks = R.rasterize_fwd_attributes(3, TILE)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"tiles": lengths.numel(), "longest_list": int(lengths.max()),
           "mean_list": float(lengths.mean()),
           "median_list": float(lengths.median()),
           "waves": lengths.numel() / (sms * blocks),
           **CS.warp_steps(stop, bounds, tiles_x)}
    tile = (torch.arange(H, device=stop.device)[:, None] // TILE * tiles_x
            + torch.arange(W, device=stop.device)[None, :] // TILE)
    start, end = bounds[tile], bounds[tile + 1]
    s64 = stop.to(torch.int64)
    visited = torch.where(s64 < R.NEVER_STOPPED, s64 + 1, end) - start
    lanes = R._image_to_tiles(visited[..., None], tiles_x, -(-H // TILE),
                              TILE)[..., 0]
    P = TILE * TILE
    if P % 64 == 0:
        pairs = lanes.reshape(lanes.shape[0], 2, P // 64, 32)
        out["two_pixel_warp_steps"] = int(pairs.amax((1, 3)).sum())
    return out


def counts(name, args):
    """What the plain versions count at these inputs (the backward kernels'
    (slot, warp)s with a composited pixel; K2s's out-of-order windows and
    live entries), K2's lists and warp steps, or K6's warp steps."""
    stats = {}
    if name == K2:
        return k2_counts(args)
    if name == K2S:
        STP.rasterize_fwd_stp_plain(*args, stats=stats)
        return stats
    if name == K6:
        _, _, stop = SR.rasterize_surfels_fwd(*args)
        return CS.warp_steps(stop, args[3], -(-CS.W // CS.TILE))
    plain = {K3: R.rasterize_bwd_plain, K3S: STP.rasterize_bwd_stp_plain,
             K7: SR.rasterize_surfels_bwd_plain}[name]
    plain(*args, stats=stats)
    return stats


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default="K2,K2s,K3,K6,K3s,K7",
                        help="which kernels, comma-separated")
    parser.add_argument("--previous", help="a directory holding "
                        "gsl_tpu_torch/csrc of K2 and K2s before their "
                        "redesign")
    opts = parser.parse_args()
    names = [SHORT[k] for k in opts.kernels.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    designs = {"current": str(cuda_build.CSRC)}
    if opts.previous:
        designs["previous"] = os.path.join(opts.previous, "gsl_tpu_torch",
                                           "csrc")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(build, designs, names)
        arrays = CS.scene_arrays(CS.N_GAUSSIANS)
        libs = pending.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": smi}
    with torch.no_grad():
        for name in names:
            args = INPUTS[name](arrays)
            report[name] = time_kernel(name, libs, designs, args)
            report[name]["stats"] = counts(name, args)
            print(f"{name} counts: {report[name]['stats']}", flush=True)
            del args
            torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_parts.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
