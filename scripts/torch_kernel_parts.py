"""Cost of each part of four hand-written kernels of the PyTorch port, on one
CUDA card: the backward kernels K3 (csrc/rasterize_bwd.cu), K3s
(csrc/rasterize_bwd_stp.cu) and K7 (csrc/surfel_bwd.cu), and the surfel
forward K6 (csrc/surfel_fwd.cu).

    python3 scripts/torch_kernel_parts.py [--kernels K3,K6,K3s,K7]
                                          [--previous DIR]

Each part is removed in turn by a preprocessor switch that this script
writes into a copy of the kernel's source under gsl_tpu_torch/build/parts/
(the package's sources stay as they are), and every copy is timed with CUDA
events at chip_smoke.py's bench scene (1M Gaussians or surfels, 1088x1920,
bench pose; K3 and K3s at C = 3, K6 and K7 at C = 6) beside the copy with
nothing removed, which is timed first and last. A copy with a part removed
computes wrong results: only its time is read. The parts of the kernels as
they are:

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

With --previous DIR, also K3 and K6 as they were before their redesign,
from DIR/gsl_tpu_torch/csrc (`git archive 1eebc16 gsl_tpu_torch/csrc | tar
-x -C DIR`): K3 without its five-step warp sums, with the batch gathered
once (and its two barriers) where each batch was gathered, without the
cross-warp sum, with the tile's last stop taken by a warp max in place of
the shared-memory atomic, with approximate divisions, and built for 4
blocks per SM; K6 with everything after the solve but the transmittance and
the stop removed, with the batch gathered once (its two divisions per slot
too), without the barrier after the gather, and with batches of 32 or 64
slots in place of 256. (The version of this script in commit 173d447 timed
K3s and K7 of commit daa6548 the same way.)

Prints ptxas's registers and spills, the registers, spills, shared bytes
and resident blocks per SM that the card's runtime reports, every time;
for K3, K3s and K7 the (slot, warp)s with a composited pixel that the plain
versions count, and for K6 the (warp, slot) steps, those in which some
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
K3, K6, K3S, K7 = "rasterize_bwd", "surfel_fwd", "rasterize_bwd_stp", \
    "surfel_bwd"
SHORT = {"K3": K3, "K6": K6, "K3s": K3S, "K7": K7}
KERNEL_FN = {K3: "rasterize_bwd_kernel", K6: "rasterize_surfels_fwd_kernel",
             K3S: "rasterize_bwd_stp_kernel",
             K7: "rasterize_surfels_bwd_kernel"}
CHANNELS = {K3: 3, K6: 6, K3S: 3, K7: 6}

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


def batch(n):
    """kBatch (n in the kernel) set by GSL_BATCH."""
    return (f"constexpr int kBatch = {n};\n",
            "#ifdef GSL_BATCH\nconstexpr int kBatch = GSL_BATCH;\n#else\n"
            f"constexpr int kBatch = {n};\n#endif\n")


# the rest of a (slot, warp) dropped once its vote is recorded in the warp's
# mask: the mask is read by the cross-warp sum, so the vote and what it
# depends on stay in the build (a copy that drops them right after an
# unused vote lets the compiler delete the test or the solve as well)
def after_vote(switch):
    text = "      warp_mask |= Mask{1} << j;\n"
    return (text, f"{text}#ifdef {switch}\n      continue;\n#endif\n")


CURRENT = {
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

# K3 and K6 before their redesign (commit 1eebc16)
OLD_SUM = ("  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, "
           "v, o);\n",
           "#ifndef GSL_NO_SUMS\n  for (int o = 16; o > 0; o >>= 1) "
           "v += __shfl_down_sync(kFullMask, v, o);\n#endif\n")
OLD_CROSS = ("for (int wp = 0; wp < n_warps; ++wp) {",
             "for (int wp = 0; wp < GSL_CROSS_WARPS; ++wp) {")
OLD_HEAD = ("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
#ifdef GSL_NO_CROSS
#define GSL_CROSS_WARPS 1
#else
#define GSL_CROSS_WARPS n_warps
#endif
#ifdef GSL_BLOCKS
#define GSL_LB __launch_bounds__(256, GSL_BLOCKS)
#else
#define GSL_LB
#endif
#ifdef GSL_FAST_DIV
#define GSL_DIV(a, b) __fdividef(a, b)
#else
#define GSL_DIV(a, b) ((a) / (b))
#endif
#ifndef GSL_BATCH
#define GSL_BATCH bs
#endif
""")
OLD_ATTRS = """
extern "C" int gsl_parts_attributes(int C, int ts, int* out) {
  const int bs = ts * ts, nw = bs / 32, R = %(geom)s + C;
  (void)nw; (void)R;
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
# K3: gather the first batch (the tile's last) and no other, and pass the
# barriers around the gather only there
OLD_K3_GATHER = [
    ("    __syncthreads();  // the previous batch's sums have been written "
     "out\n    if (tid < count) {\n      const int gid = gids[base + tid];",
     "#ifdef GSL_GATHER_ONCE\n    const bool gather = b == n_batches - 1;\n"
     "#else\n    const bool gather = true;\n#endif\n"
     "    if (gather) __syncthreads();\n"
     "    if (gather && tid < kBatch) {\n"
     "      const int gid = gids[base + (tid < count ? tid : 0)];"),
    ("    }\n    __syncthreads();\n    for (int j = count - 1; j >= 0; --j) {",
     "    }\n    if (gather) __syncthreads();\n"
     "    for (int j = count - 1; j >= 0; --j) {"),
]
# K3: the tile's last stop by a max over each warp, then over the warps
OLD_K3_STOP = ("  atomicMax(&s_last, stop < end ? stop : end);\n",
               "#ifdef GSL_NO_ATOMIC\n  __shared__ int s_wmax[32];\n"
               "  {\n    const int m = __reduce_max_sync(kFullMask, "
               "stop < end ? stop : end);\n    if (lane == 0) s_wmax[warp] = m;"
               "\n  }\n  __syncthreads();\n  if (tid == 0) {\n"
               "    int mx = start;\n    for (int wp = 0; wp < n_warps; ++wp)"
               " mx = s_wmax[wp] > mx ? s_wmax[wp] : mx;\n    s_last = mx;\n"
               "  }\n#else\n  atomicMax(&s_last, stop < end ? stop : end);\n"
               "#endif\n")
PREVIOUS = {
    K3: ([OLD_SUM, OLD_CROSS, OLD_HEAD, OLD_K3_STOP, *OLD_K3_GATHER,
          ("const float t_exc = T / one_minus;",
           "const float t_exc = GSL_DIV(T, one_minus);"),
          ("S / fmaxf(one_minus, min_one_minus)",
           "GSL_DIV(S, fmaxf(one_minus, min_one_minus))"),
          ("__global__ void rasterize_bwd_kernel(",
           "__global__ void GSL_LB rasterize_bwd_kernel(")],
         {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
          "gather_once": ["GSL_GATHER_ONCE"],
          "no_cross_warp_sum": ["GSL_NO_CROSS"],
          "no_atomic_stop": ["GSL_NO_ATOMIC"],
          "approximate_divisions": ["GSL_FAST_DIV"],
          "four_blocks_per_sm": ["GSL_BLOCKS=4"]}),
    K6: ([OLD_HEAD,
          ("__global__ void rasterize_surfels_fwd_kernel(",
           "__global__ void GSL_LB rasterize_surfels_fwd_kernel("),
          ("base < end; base += bs) {", "base < end; base += GSL_BATCH) {"),
          ("    if (idx < end) {\n",
           "#ifdef GSL_GATHER_ONCE\n    const bool gather = base == start;\n"
           "#else\n    const bool gather = true;\n#endif\n"
           "    if (gather && tid < GSL_BATCH && idx < end) {\n"),
          ("    }\n    __syncthreads();\n    const int count",
           "    }\n#ifndef GSL_NO_BARRIER2\n    __syncthreads();\n#endif\n"
           "    const int count"),
          ("end - base < bs ? end - base : bs);",
           "end - base < GSL_BATCH ? end - base : GSL_BATCH);"),
          ("      const float w = t.alpha * T;\n",
           "#ifdef GSL_SOLVE_ONLY\n      T = next_t;\n      continue;\n"
           "#endif\n      const float w = t.alpha * T;\n")],
         {"whole": [], "solve_and_stop_only": ["GSL_SOLVE_ONLY"],
          "gather_once": ["GSL_GATHER_ONCE"],
          "no_second_barrier": ["GSL_NO_BARRIER2"],
          "batch_32": ["GSL_BATCH=32"], "batch_64": ["GSL_BATCH=64"]}),
}
OLD_WORDS = {
    K3: dict(geom="6", ct=3, fn=KERNEL_FN[K3],
             words="(size_t)(6 + C) * kBatch + (size_t)nw * kBatch * R"
                   " + (size_t)nw * kBatch"),
    K6: dict(geom="0", ct=6, fn=KERNEL_FN[K6],
             words="(size_t)(surfel::kSplat + C) * bs"),
}
ATTRS = {K3: "gsl_rasterize_bwd_attributes",
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


def k3_inputs(arrays):
    """The bench pose at C = 3, as chip_smoke.phase_kernels builds it: the
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
    _, t_fin, stop = R.rasterize_fwd(m2d, con, opac, ch, gs, bounds, H, W,
                                     TILE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_out = torch.randn((H, W, 3), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    return (m2d, con, opac, ch, gs, bounds, g_out, g_alpha, t_fin, stop,
            TILE)


def k3s_inputs(arrays):
    """The bench pose at C = 3, as chip_smoke.check_stp_kernels builds it:
    the wrapper's arguments."""
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
    fwd = (m2d, con, opac, ch, depths, kz, gs, bounds, H, W, TILE)
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
    if name == K3:
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


WRAPPERS = {K3: R.rasterize_bwd, K6: SR.rasterize_surfels_fwd,
            K3S: STP.rasterize_bwd_stp, K7: SR.rasterize_surfels_bwd}
INPUTS = {K3: k3_inputs, K6: k6_inputs, K3S: k3s_inputs, K7: k7_inputs}


def time_kernel(name, libs, designs, args):
    wrapper = WRAPPERS[name]
    want = wrapper(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = [torch.zeros_like(t) for t in want]
    result = {"wrapper_ms": CS.cuda_ms(lambda: wrapper(*args), 20)}
    for design in designs:
        if table(design, name) is None:
            continue
        for variant in [*table(design, name)[1], "whole"]:
            lib = libs[(design, name, variant)]
            run = launcher(name, lib, args, outs)
            run()
            torch.cuda.synchronize()
            ms = CS.cuda_ms(run, 20)
            same = (all(torch.equal(o, w) for o, w in zip(outs, want))
                    if design == "current" and variant == "whole" else None)
            attrs = attributes(lib, CHANNELS[name])
            result.setdefault(design, {}).setdefault(variant, {
                "ms": [], **attrs})["ms"].append(ms)
            print(f"{name} {design} {variant}: {ms:.4f} ms {attrs}"
                  + ("" if same is None else
                     f"; output equals the package's kernel's: {same}"),
                  flush=True)
    return result


def counts(name, args):
    """What the plain versions count at these inputs (the backward kernels'
    (slot, warp)s with a composited pixel), or K6's warp steps."""
    stats = {}
    if name == K6:
        _, _, stop = SR.rasterize_surfels_fwd(*args)
        return CS.warp_steps(stop, args[3], -(-CS.W // CS.TILE))
    plain = {K3: R.rasterize_bwd_plain, K3S: STP.rasterize_bwd_stp_plain,
             K7: SR.rasterize_surfels_bwd_plain}[name]
    plain(*args, stats=stats)
    return stats


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default="K3,K6,K3s,K7",
                        help="which kernels, comma-separated")
    parser.add_argument("--previous", help="a directory holding "
                        "gsl_tpu_torch/csrc of K3 and K6 before their "
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
