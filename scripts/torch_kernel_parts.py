"""Cost of each part of the nine hand-written kernels of the PyTorch port,
on one CUDA card: the slot kernels K1 (csrc/expand.cu), K4
(csrc/reduce_grads.cu) and K5 (csrc/surfel_expand.cu), the forward kernels K2 (csrc/rasterize_fwd.cu), K2s
(csrc/rasterize_fwd_stp.cu) and K6 (csrc/surfel_fwd.cu), and the backward
kernels K3 (csrc/rasterize_bwd.cu), K3s (csrc/rasterize_bwd_stp.cu) and K7
(csrc/surfel_bwd.cu).

    python3 scripts/torch_kernel_parts.py [--kernels K1,K4,K5,K4surfel,...]
                                          [--previous DIR]

Each part is removed in turn by a preprocessor switch that this script
writes into a copy of the kernel's source under gsl_tpu_torch/build/parts/
(the package's sources stay as they are), and every copy is timed with CUDA
events at chip_smoke.py's bench scene (1M Gaussians or surfels, 1088x1920,
bench pose; K2, K2s, K3 and K3s at C = 3, K5, K6 and K7 at C = 6) beside the
copy with nothing removed, which is timed first and last. K1 is timed with
depth keys (K1) and StopThePop keys (K1stp), K4 on the rows of K3 (K4, R =
9 with two absolute columns), K3s (K4stp) and K7 (K4surfel, R = 19). A copy
with a part removed computes wrong results: only its time is read. Where a
part decides something (a test, a vote, an order), its result stays in
what the kernel writes, so the compiler cannot delete the work before it.
The parts of the kernels as they are:

- K1: the peak-alpha cull (every slot kept); the key stores (the keys
  computed, one in 2^32 stored); the dummy slots' keys; the binary search
  (the slot's Gaussian guessed from its share of the run); and choices
  undone: runs of 64 or 256 Gaussians in place of 128, a build for 16
  blocks per SM (32 registers);
- K5: the key stores (the keys computed, one in 2^32 stored); the key and
  id stores; the binary search (the slot's surfel guessed from its share
  of the run); and runs of 64, 256 or 512 surfels in place of 128;
- K4: the row gather (the sorted position staged in place of the row); the
  inv_order load (positions hashed from the slot, all valid); the absolute
  columns; the sums over a Gaussian's slots (one staged value taken); and
  choices undone: runs of 32, 64, 128 or 256 Gaussians in place of the
  host's choice, stages of 2048, 3072, 6144 or 8192 floats in place of
  4096, the rows loaded into registers, eight a thread, in place of
  cp.async;
- K2: the channel sums; everything after the alpha test (the kept pairs
  counted into T); the skip cut (every pair to the exact test); the
  block's early exit (every batch walked); and choices undone: one or
  four pixels a thread in place of two, a register cap of 40 (and of 32
  with one pixel a thread, also with the alpha test alone or without the
  skip cut), batches of 32 or 128 slots in place of 64, the records read
  with 4-byte loads;
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

With --previous DIR, also K5 as it was before its redesign, from
DIR/gsl_tpu_torch/csrc (`git archive 1bc8fc5 gsl_tpu_torch/csrc | tar -x
-C DIR`, e.g. into .scratch/prev of the checkout, which git ignores): one
thread a surfel looping over its slots; without its key and id stores,
and with its rectangle read in one 16-byte load in place of four 4-byte
ones. The "whole" copy's keys and ids are compared with the package's
kernel's. (The version of this script in commit 1bc8fc5 timed K1 and K4 of
commit a7fa1ac the same way, the one in commit a7fa1ac K2 and K2s of
commit 48a8ffb, the one in commit 48a8ffb K3 and K6 of commit 1eebc16, the
one in commit 173d447 K3s and K7 of commit daa6548.)

Prints ptxas's registers and spills, the registers, spills, shared bytes
and resident blocks per SM that the card's runtime reports, every time;
for K1, K4 and K5 the slots per Gaussian or surfel, the warp iterations
of the design before (one thread a Gaussian, surfel or (Gaussian,
column)) and their useful share, the runs' slots and passes, and for K4 the bytes of the valid rows
and of the 32-byte sectors they span; for K2 the tiles' list lengths, the
waves of resident blocks and the (warp, slot) steps of warps of 32 pixels
and of 32 threads of two pixels each; for K2s the (pixel, window)s and
their live entries, those out of order and the (window, warp)s with one;
for K3, K3s and K7 the (slot, warp)s with a composited pixel that the
plain versions count; for K6 the (warp, slot) steps, those in which some
lanes of the warp have already stopped, and the lane steps that idle;
writes chiprun_out/kernel_parts.json.
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
K1, K2, K2S, K3, K4, K5, K6, K3S, K7 = (
    "expand", "rasterize_fwd", "rasterize_fwd_stp", "rasterize_bwd",
    "reduce_grads", "surfel_expand", "surfel_fwd", "rasterize_bwd_stp",
    "surfel_bwd")
# what is timed -> its source: K1 with either key kind, K4 on the rows of
# K3, K3s and K7
SHORT = {"K1": K1, "K1stp": K1, "K2": K2, "K2s": K2S, "K3": K3, "K4": K4,
         "K4stp": K4, "K4surfel": K4, "K5": K5, "K6": K6, "K3s": K3S,
         "K7": K7}
KERNEL_FN = {K2: "rasterize_fwd_kernel", K2S: "rasterize_fwd_stp_kernel",
             K3: "rasterize_bwd_kernel", K6: "rasterize_surfels_fwd_kernel",
             K3S: "rasterize_bwd_stp_kernel",
             K7: "rasterize_surfels_bwd_kernel"}
# the arguments of the attributes entry: (C, tile size); K4's (R, n_abs)
ATTR_ARGS = {"K1": (0, 0), "K1stp": (0, 0), "K2": (3, 16), "K2s": (3, 16),
             "K3": (3, 16), "K4": (9, 2), "K4stp": (9, 2),
             "K4surfel": (19, 0), "K5": (0, 0), "K6": (6, 16),
             "K3s": (3, 16),
             "K7": (6, 16)}

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

# K1: every slot kept, the cull never run
K1_NO_CULL = ("    if (culling) {\n",
              "#ifdef GSL_NO_CULL\n    if (false) {\n#else\n"
              "    if (culling) {\n#endif\n")


def min_blocks(fn):
    """__launch_bounds__(kThreads) of kernel `fn`, with GSL_BLOCKS resident
    blocks per SM asked of the compiler where it is set."""
    return (f"__global__ void __launch_bounds__(kThreads) {fn}(",
            "\n#ifdef GSL_BLOCKS\n#define GSL_LB __launch_bounds__(kThreads, "
            "GSL_BLOCKS)\n#else\n#define GSL_LB __launch_bounds__(kThreads)"
            f"\n#endif\n__global__ void GSL_LB {fn}(")


def hashed_pos(slot):
    """A sorted position computed from the slot, in place of inv_order's:
    spread over the valid rows as the real ones are, all valid."""
    return (f"static_cast<int>((static_cast<uint64_t>({slot}) * "
            "2654435761ull) % static_cast<uint64_t>(n_valid))")


def no_abs(indent):
    """K4's absolute columns summed as plain ones."""
    line = f"{indent}const bool absolute = v >= kGeom && v < kGeom + n_abs;\n"
    return (line, f"#ifdef GSL_NO_ABS\n{indent}const bool absolute = false;"
            f"\n#else\n{line}#endif\n")


# the slot's Gaussian or surfel taken from its share of the run's slots
NO_SEARCH = (
    "    const int i = gsl::slot_owner(s_off, run.count, s);\n",
    "#ifdef GSL_NO_SEARCH\n    const int i = static_cast<int>(\n"
    "        static_cast<int64_t>(s) * run.count / run.slots);\n#else\n"
    "    const int i = gsl::slot_owner(s_off, run.count, s);\n#endif\n")
K1_CURRENT = [
    K1_NO_CULL, constant("kThreads", 128, "GSL_THREADS"),
    min_blocks("expand_kernel"),
    ("    keys[at] = valid ? ((tile << 32) | dbits) : INT64_MAX;\n",
     "#ifdef GSL_NO_KEYS\n    if (valid && dbits == 1) keys[at] = tile;\n"
     "#else\n    keys[at] = valid ? ((tile << 32) | dbits) : INT64_MAX;\n"
     "#endif\n"),
    ("    if (hits == 0) {  // culled by projection: one invalid dummy slot\n",
     "#ifdef GSL_NO_DUMMY\n    if (hits == 0) continue;\n#endif\n"
     "    if (hits == 0) {  // culled by projection: one invalid dummy slot\n"),
    NO_SEARCH]
K5_CURRENT = [
    constant("kThreads", 128, "GSL_THREADS"), NO_SEARCH,
    ("    gids[at] = run.g0 + i;\n",
     "#ifndef GSL_NO_STORES\n    gids[at] = run.g0 + i;\n#endif\n"),
    ("    keys[at] = (tile << 32) | dbits;\n",
     "#if defined(GSL_NO_STORES) || defined(GSL_NO_KEYS)\n"
     "    if (dbits == 1) keys[at] = tile;\n#else\n"
     "    keys[at] = (tile << 32) | dbits;\n#endif\n")]
K4_CURRENT = [
    # runs of GSL_RUN Gaussians in place of run_length's choice
    ("  return run;\n}\n",
     "#ifdef GSL_RUN\n  return GSL_RUN + 0 * run;\n#else\n  return run;\n"
     "#endif\n}\n"),
    constant("kStageFloats", 4096, "GSL_STAGE"),
    min_blocks("reduce_grads_kernel"),
    ("      const int pos = inv_order[run.s0 + b + j];\n",
     "#ifdef GSL_NO_INV\n      const int pos = " + hashed_pos("run.s0 + b + j")
     + ";\n#else\n      const int pos = inv_order[run.s0 + b + j];\n"
     "#endif\n"),
    ("        __pipeline_memcpy_async(\n"
     "            s_row + idx, rows + static_cast<int64_t>(pos) * n_cols + c,\n"
     "            sizeof(float));\n",
     "#ifdef GSL_NO_GATHER\n        s_row[idx] = static_cast<float>(pos);\n"
     "#else\n        __pipeline_memcpy_async(\n"
     "            s_row + idx, rows + static_cast<int64_t>(pos) * n_cols + c,\n"
     "            sizeof(float));\n#endif\n"),
    # the rows loaded into registers, eight a thread in flight, and stored
    # to shared memory, in place of cp.async
    ("    for (int idx = t; idx < cnt * n_cols; idx += kThreads) {\n",
     "#ifdef GSL_REGISTER_GATHER\n"
     "    for (int base = t; base < cnt * n_cols; base += 8 * kThreads) {\n"
     "      float x[8];\n      int at[8];\n#pragma unroll\n"
     "      for (int u = 0; u < 8; ++u) {\n        at[u] = -1;\n"
     "        if (base + u * kThreads < cnt * n_cols && s_pos[j] >= 0) {\n"
     "          x[u] = rows[static_cast<int64_t>(s_pos[j]) * n_cols + c];\n"
     "          at[u] = base + u * kThreads;\n        }\n"
     "        j += row_step;\n        c += col_step;\n"
     "        if (c >= n_cols) {\n          c -= n_cols;\n          ++j;\n"
     "        }\n      }\n#pragma unroll\n"
     "      for (int u = 0; u < 8; ++u) {\n"
     "        if (at[u] >= 0) s_row[at[u]] = x[u];\n      }\n    }\n"
     "    for (int idx = cnt * n_cols; idx < cnt * n_cols; idx += kThreads) {"
     "\n#else\n"
     "    for (int idx = t; idx < cnt * n_cols; idx += kThreads) {\n#endif\n"),
    no_abs("      "),
    # one staged value a (Gaussian, column), not the sum over its slots
    ("        for (int k = max(lo, 0); k < min(hi, cnt); ++k) {\n",
     "#ifdef GSL_NO_SUMS\n        if (max(lo, 0) < min(hi, cnt)) sum += "
     "s_row[max(lo, 0) * n_cols + src];\n"
     "        for (int k = cnt; k < cnt; ++k) {\n#else\n"
     "        for (int k = max(lo, 0); k < min(hi, cnt); ++k) {\n#endif\n")]

CURRENT = {
    K1: (K1_CURRENT,
         {"whole": [], "no_cull": ["GSL_NO_CULL"],
          "no_key_stores": ["GSL_NO_KEYS"], "no_dummy_slots": ["GSL_NO_DUMMY"],
          "no_binary_search": ["GSL_NO_SEARCH"],
          "runs_of_64": ["GSL_THREADS=64"],
          "runs_of_256": ["GSL_THREADS=256"],
          "sixteen_blocks_per_sm": ["GSL_BLOCKS=16"]}),
    K5: (K5_CURRENT,
         {"whole": [], "no_key_stores": ["GSL_NO_KEYS"],
          "no_stores": ["GSL_NO_STORES"],
          "no_binary_search": ["GSL_NO_SEARCH"],
          "runs_of_64": ["GSL_THREADS=64"],
          "runs_of_256": ["GSL_THREADS=256"],
          "runs_of_512": ["GSL_THREADS=512"]}),
    K4: (K4_CURRENT,
         {"whole": [], "no_row_gather": ["GSL_NO_GATHER"],
          "no_inv_order_load": ["GSL_NO_INV"],
          "no_absolute_columns": ["GSL_NO_ABS"],
          "no_slot_sums": ["GSL_NO_SUMS"],
          "runs_of_32": ["GSL_RUN=32"], "runs_of_64": ["GSL_RUN=64"],
          "runs_of_128": ["GSL_RUN=128"], "runs_of_256": ["GSL_RUN=256"],
          "stage_2048": ["GSL_STAGE=2048"], "stage_3072": ["GSL_STAGE=3072"],
          "stage_6144": ["GSL_STAGE=6144"], "stage_8192": ["GSL_STAGE=8192"],
          "register_gather": ["GSL_REGISTER_GATHER"]}),
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

# K5 before its redesign (commit 1bc8fc5): one thread a surfel looping over
# its slots, its rectangle read in four 4-byte loads
PREVIOUS = {
    K5: ([("  const int min_x = rect[4 * g + 0];\n"
           "  const int min_y = rect[4 * g + 1];\n"
           "  const int w = rect[4 * g + 2];\n"
           "  const int h = rect[4 * g + 3];\n",
           "#ifdef GSL_INT4_RECT\n"
           "  const int4 r = reinterpret_cast<const int4*>(rect)[g];\n"
           "  const int min_x = r.x;\n  const int min_y = r.y;\n"
           "  const int w = r.z;\n  const int h = r.w;\n#else\n"
           "  const int min_x = rect[4 * g + 0];\n"
           "  const int min_y = rect[4 * g + 1];\n"
           "  const int w = rect[4 * g + 2];\n"
           "  const int h = rect[4 * g + 3];\n#endif\n"),
          ("    keys[off + local] = (tile << 32) | dbits;\n"
           "    gids[off + local] = g;\n",
           "#ifdef GSL_NO_STORES\n    if (dbits == 1) keys[off + local] = tile;"
           "\n#else\n    keys[off + local] = (tile << 32) | dbits;\n"
           "    gids[off + local] = g;\n#endif\n")],
         {"whole": [], "no_stores": ["GSL_NO_STORES"],
          "int4_rect": ["GSL_INT4_RECT"]}),
}
# the resources of the kernels as they were, which had no entry for them
OLD_ATTRS = {K5: ("expand_surfel_kernel", "256", "0")}
OLD_ATTRS_ENTRY = """
extern "C" int gsl_parts_attributes(int, int, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, %s);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, %s, %s, %s);
  out[0] = attr.numRegs; out[1] = (int)attr.localSizeBytes;
  out[2] = %s; out[3] = blocks;
  return (int)err;
}
"""
# the call of the kernel's attributes entry in a copy of it as it is: the
# raster kernels' take (C, tile size); K4's (R, n_abs)
ATTRS = {K2: "gsl_rasterize_fwd_attributes(C, ts, out)",
         K2S: "gsl_rasterize_fwd_stp_attributes(C, ts, out)",
         K3: "gsl_rasterize_bwd_attributes(C, ts, out)",
         K6: "gsl_rasterize_surfels_fwd_attributes(C, ts, out)",
         K3S: "gsl_rasterize_bwd_stp_attributes(C, ts, out)",
         K7: "gsl_rasterize_surfels_bwd_attributes(C, ts, out)",
         K1: "gsl_expand_attributes(out)",
         K5: "gsl_expand_surfel_attributes(out)",
         K4: "gsl_reduce_grads_attributes(C, ts, out)"}


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
                 f'out) {{\n  return {ATTRS[name]};\n}}\n')
    else:
        fn, threads, smem = OLD_ATTRS[name]
        text += OLD_ATTRS_ENTRY % (fn, fn, threads, smem, smem)
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
                cmd = [nvcc, *cuda_build._flags(name), "-I", csrc,
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


def attributes(lib, short):
    lib.gsl_parts_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    cuda_build.check(lib, lib.gsl_parts_attributes(*ATTR_ARGS[short], out),
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
    opac = renderer.get_opacities(state, cam, proj).contiguous()
    ch = CS.channels_for(state, renderer, proj, cam, 3)
    return proj, opac, ch


def bench_sorted(arrays, stp=False):
    """The bench pose at C = 3 through K1 and the sort, as
    chip_smoke.phase_kernels (and check_stp_kernels with `stp`) builds it:
    (K1's wrapper's arguments, channels, sorted ids, order, tile bounds)."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    proj, opac, ch = bench_projection(arrays)
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    args = (R.isect_encode(proj, H, W, TILE), m2d, con, opac,
            proj.depths.contiguous(), tiles_x, tiles_y, TILE, True, stp,
            proj.depth_grads.contiguous() if stp else None)
    keys, gids = R.expand(*args)
    sk, gs, order = R.sort_slots(keys, gids)
    return args, ch, gs, order, R.tile_bounds(sk, tiles_x * tiles_y)


def k1_inputs(arrays):
    return bench_sorted(arrays)[0]


def k1stp_inputs(arrays):
    return bench_sorted(arrays, stp=True)[0]


def k2_inputs(arrays):
    """The bench pose at C = 3: K2's wrapper's arguments."""
    args, ch, gs, _, bounds = bench_sorted(arrays)
    gs = gs[:int(bounds[-1])].contiguous()
    return (*args[1:4], ch, gs, bounds, CS.H, CS.W, CS.TILE)


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
    """The bench pose at C = 3 with StopThePop keys: K2s's wrapper's
    arguments."""
    args, ch, gs, _, bounds = bench_sorted(arrays, stp=True)
    return (*args[1:4], ch, args[4], args[10], gs, bounds, CS.H, CS.W,
            CS.TILE)


def k3s_inputs(arrays):
    """K3s's wrapper's arguments at K2s's inputs, after K2s."""
    fwd = k2s_inputs(arrays)
    H, W, TILE = fwd[8:]
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    g_out = torch.randn((H, W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    return fwd[:8] + (g_out, g_alpha, t_fin, ckpt, TILE)


def bench_surfels(arrays):
    """The bench pose at C = 6 through K5 and the sort, as
    chip_smoke.check_surfel_kernels builds it: (K5's wrapper's arguments,
    geom, channels, sorted ids, order, tile bounds)."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    state = state_from_raw_arrays(CS.surfel_arrays(arrays), device="cuda")
    proj, geom, ch = CS.surfel_inputs(state, CS.camera(np.eye(4)), 6)
    args = (SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii, H,
                                   W, TILE),
            proj.depths.contiguous(), tiles_x, tiles_y)
    sk, gs, order = R.sort_slots(*SR.surfel_expand(*args))
    return args, geom, ch, gs, order, R.tile_bounds(sk, tiles_x * tiles_y)


def k5_inputs(arrays):
    return bench_surfels(arrays)[0]


def k6_inputs(arrays):
    """The bench pose at C = 6: K6's wrapper's arguments."""
    _, geom, ch, gs, _, bounds = bench_surfels(arrays)
    return (geom, ch, gs, bounds, CS.H, CS.W, CS.TILE)


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


def k4_inputs(arrays):
    """K4's wrapper's arguments on K3's rows at the bench pose (C = 3),
    as chip_smoke.check_backward builds them."""
    args, ch, gs, order, bounds = bench_sorted(arrays)
    gs = gs[:int(bounds[-1])].contiguous()
    fwd = (*args[1:4], ch, gs, bounds, CS.H, CS.W, CS.TILE)
    _, t_fin, stop = R.rasterize_fwd(*fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_out = torch.randn((CS.H, CS.W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((CS.H, CS.W), generator=gen, device="cuda")
    rows = R.rasterize_bwd(*fwd[:6], g_out, g_alpha, t_fin, stop, CS.TILE)
    return (rows, gs, args[0].offsets, R.invert_order(order), bounds[-1:],
            args[1].shape[0], 2)


def k4stp_inputs(arrays):
    """K4's wrapper's arguments on K3s's rows at the bench pose (C = 3),
    as chip_smoke.check_stp_kernels builds them."""
    args, ch, gs, order, bounds = bench_sorted(arrays, stp=True)
    fwd = (*args[1:4], ch, args[4], args[10], gs, bounds, CS.H, CS.W,
           CS.TILE)
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    g_out = torch.randn((CS.H, CS.W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((CS.H, CS.W), generator=gen, device="cuda")
    rows = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, t_fin, ckpt,
                                 CS.TILE)
    return (rows, gs, args[0].offsets, R.invert_order(order), bounds[-1:],
            args[1].shape[0], 2)


def k4surfel_inputs(arrays):
    """K4's wrapper's arguments on K7's rows at the bench pose (C = 6), as
    chip_smoke.check_surfel_kernels builds them."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    args, geom, ch, gs, order, bounds = bench_surfels(arrays)
    isects = args[0]
    _, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TILE)
    gen = torch.Generator(device="cuda").manual_seed(10)
    g_out = torch.randn((H, W, 6), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    rows = SR.rasterize_surfels_bwd(geom, ch, gs, bounds, g_out, g_aux, aux,
                                    stop, TILE)
    return (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:],
            geom.shape[0], 0)


def launcher(name, lib, args, outs):
    """A call of the copy's C entry point on the wrapper's arguments,
    writing into `outs`."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    H, W = CS.H, CS.W
    tiles_x, tiles_y = -(-W // CS.TILE), -(-H // CS.TILE)
    grid = (tiles_x * tiles_y, tiles_x, CS.TILE, H, W)
    if name == K1:
        fn = lib.gsl_expand
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3)
        isects, stp, kz = args[0], args[9], args[10]
        call = (ptr(isects.offsets), ptr(isects.rect), ptr(args[4]),
                *map(ptr, args[1:4]), ptr(kz) if stp else None,
                args[1].shape[0], args[7], args[5], args[6], int(args[8]),
                int(stp), *map(ptr, outs), stream)
    elif name == K5:
        fn = lib.gsl_expand_surfel
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3)
        isects, depths, tiles_x, tiles_y = args
        call = (ptr(isects.offsets), ptr(isects.rect), ptr(depths),
                depths.shape[0], tiles_x, tiles_y, *map(ptr, outs), stream)
    elif name == K4:
        fn = lib.gsl_reduce_grads
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        rows, _, offsets, inv, n_valid, n, n_abs = args
        call = (ptr(rows), rows.shape[1], n_abs, ptr(offsets), inv.numel(),
                ptr(inv), ptr(n_valid), n, ptr(outs[0]), stream)
    elif name == K2:
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


WRAPPERS = {"K1": R.expand, "K1stp": R.expand, "K2": R.rasterize_fwd,
            "K2s": lambda *a: STP.rasterize_fwd_stp(*a, checkpoints=True),
            "K3": R.rasterize_bwd, "K4": R.reduce_grads,
            "K4stp": R.reduce_grads, "K4surfel": R.reduce_grads,
            "K5": SR.surfel_expand, "K6": SR.rasterize_surfels_fwd, "K3s": STP.rasterize_bwd_stp,
            "K7": SR.rasterize_surfels_bwd}
INPUTS = {"K1": k1_inputs, "K1stp": k1stp_inputs, "K2": k2_inputs,
          "K2s": k2s_inputs, "K3": k3_inputs, "K4": k4_inputs,
          "K4stp": k4stp_inputs, "K4surfel": k4surfel_inputs,
          "K5": k5_inputs, "K6": k6_inputs, "K3s": k3s_inputs, "K7": k7_inputs}


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


def time_kernel(short, libs, designs, args):
    name = SHORT[short]
    wrapper = WRAPPERS[short]
    want = wrapper(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = [torch.zeros_like(t) for t in want]
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    result = {"wrapper_ms": CS.cuda_ms(lambda: wrapper(*args), 20),
              "identical_in_two_runs": same_outputs(name, again, want,
                                                    args)}
    print(f"{short} package's kernel: {result['wrapper_ms']:.4f} ms through "
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
            attrs = attributes(lib, short)
            entry = result.setdefault(design, {}).setdefault(variant, {
                "ms": [], **attrs})
            entry["ms"].append(ms)
            if same is not None:
                entry["equals_package_kernel"] = same
            print(f"{short} {design} {variant}: {ms:.4f} ms {attrs}"
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


def slot_stats(offsets, total, per_gaussian):
    """Slots per Gaussian, and the mean warp iterations of the design
    before (K1 and K4 of a7fa1ac, K5 of 1bc8fc5) in which `per_gaussian`
    consecutive threads each loop over the slots of one Gaussian (K1, K5:
    1; K4: one a column), beside the share of lane iterations that do
    work."""
    slots = torch.diff(offsets, append=offsets.new_tensor([total])).float()
    q = torch.quantile(slots[:1 << 24], torch.tensor(
        [0.5, 0.9, 0.99], device=slots.device)).tolist()
    lanes = slots.repeat_interleave(per_gaussian)
    lanes = torch.nn.functional.pad(lanes, (0, -lanes.numel() % 32))
    most = lanes.reshape(-1, 32).amax(1)
    return {"gaussians": slots.numel(), "slots": total,
            "slots_per_gaussian_mean": float(slots.mean()), "median": q[0],
            "p90": q[1], "p99": q[2], "max": int(slots.max()),
            "warp_iterations_before": float(most.mean()),
            "useful_lane_share_before": float(lanes.sum())
            / float(32 * most.sum())}


def run_stats(offsets, total, run, per_pass):
    """Slots of each run of `run` Gaussians and the passes of `per_pass`
    slots that walk them."""
    ends = torch.cat([offsets[run::run], offsets.new_tensor([total])])
    slots = torch.diff(ends, prepend=offsets[:1]).float()
    passes = torch.ceil(slots / per_pass)
    return {"run": run, "runs": slots.numel(),
            "run_slots_mean": float(slots.mean()),
            "run_slots_max": int(slots.max()), "passes": int(passes.sum()),
            "busy_share": float(slots.sum() / (passes.sum() * per_pass))}


def k4_run_length(n_cols, total, n):
    """The Gaussians a block of K4 owns: csrc/reduce_grads.cu's
    run_length."""
    per_gaussian = total / n if n > 0 and total > n else 1.0
    run = 256
    while run > 32 and 1.25 * run * per_gaussian > max(1, 4096 // n_cols):
        run //= 2
    return run


def sector_bytes(inv_order, n_valid, n_cols):
    """The 32-byte sectors that the valid rows of n_cols floats span, as
    bytes: each row read at a random 4-byte offset."""
    pos = inv_order[inv_order < n_valid].long()
    first = pos * n_cols * 4 // 32
    last = (pos * n_cols * 4 + n_cols * 4 - 1) // 32
    return int((last - first + 1).sum()) * 32


def counts(short, args):
    """What the plain versions count at these inputs (the backward kernels'
    (slot, warp)s with a composited pixel; K2s's out-of-order windows and
    live entries), K2's lists and warp steps, K6's warp steps, or the slots
    per Gaussian and per run of K1, K4 and K5 with K4's row sectors (K5:
    per run of 64 to 512 surfels)."""
    name = SHORT[short]
    stats = {}
    if name in (K1, K5):
        isects = args[0]
        out = {**slot_stats(isects.offsets, isects.total, 1),
               "empty_rectangles": int(
                   (isects.rect[:, 2] * isects.rect[:, 3] == 0).sum()),
               **run_stats(isects.offsets, isects.total, 128, 128)}
        if name == K5:
            out["runs"] = [run_stats(isects.offsets, isects.total, r, r)
                           for r in (64, 256, 512)]
        return out
    if name == K4:
        rows, _, offsets, inv, n_valid, _, n_abs = args
        n_cols, nv = rows.shape[1], int(n_valid)
        return {**slot_stats(offsets, inv.numel(), n_cols + n_abs),
                "valid_rows": nv, "row_bytes": 4 * n_cols * nv,
                "row_sector_bytes": sector_bytes(inv, nv, n_cols),
                **run_stats(offsets, inv.numel(),
                            k4_run_length(n_cols, inv.numel(), len(offsets)),
                            max(1, 4096 // n_cols))}
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
    parser.add_argument("--kernels", default=",".join(SHORT),
                        help="which kernels, comma-separated, of "
                        + ", ".join(SHORT))
    parser.add_argument("--previous", help="a directory holding "
                        "gsl_tpu_torch/csrc of K5 before its redesign")
    opts = parser.parse_args()
    shorts = opts.kernels.split(",")
    names = sorted({SHORT[k] for k in shorts})
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
        for short in shorts:
            args = INPUTS[short](arrays)
            report[short] = time_kernel(short, libs, designs, args)
            report[short]["stats"] = counts(short, args)
            print(f"{short} counts: {report[short]['stats']}", flush=True)
            del args
            torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_parts.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
