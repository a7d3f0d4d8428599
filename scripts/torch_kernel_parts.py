"""Cost of each part of the backward kernels K3s (csrc/rasterize_bwd_stp.cu)
and K7 (csrc/surfel_bwd.cu) of the PyTorch port, on one CUDA card.

    python3 scripts/torch_kernel_parts.py [--previous DIR]

Each part is removed in turn by a preprocessor switch that this script
writes into a copy of the kernel's source under gsl_tpu_torch/build/parts/
(the package's sources stay as they are), and every copy is timed with CUDA
events at chip_smoke.py's bench scene (1M Gaussians or surfels, 1088x1920,
bench pose; K3s at C = 3, K7 at C = 6) beside the copy with nothing
removed, which is timed first and last. A copy with a part removed computes
wrong rows: only its time is read. The parts:

- K3s: the transposed warp sums (each lane adds up its own values
  instead), the out-of-order lanes' path (every window taken as in order),
  pass 2 (the gradient), and both; and two choices undone: pass 2
  unrolled, and a build for 3 blocks per SM (more registers a thread);
- K7: the transposed warp sums, and everything after the solve (the
  gradient and its sums); and two choices undone: the six IEEE divisions
  by cz and Tw.z in place of the two reciprocals, and a build for 3 blocks
  per SM.

With --previous DIR, also the kernels as they were before the transposed
sums, from DIR/gsl_tpu_torch/csrc (`git archive daa6548 gsl_tpu_torch/csrc
| tar -x -C DIR`): K3s without its five-step warp sums, with every slot's
fields read from the tile's first slot (which also changes what
composites), without the rank count, without the cross-warp sum, all four,
and built for 3 blocks per SM; K7 the same but for the rank count, and
built for 5 blocks per SM.

Prints ptxas's registers and spills, the registers, spills, shared bytes
and resident blocks per SM that the card's runtime reports, every time,
and the (slot, warp)s with a composited pixel that the plain versions
count; writes chiprun_out/kernel_parts.json.
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
K3S, K7 = "rasterize_bwd_stp", "surfel_bwd"
KERNEL_FN = {K3S: "rasterize_bwd_stp_kernel",
             K7: "rasterize_surfels_bwd_kernel"}

# one more block per SM where the kernel is built for 4 of 256 threads
CUR_HEAD = ("#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
#ifdef GSL_BLOCKS
#define GSL_LB __launch_bounds__(256, GSL_BLOCKS)
#else
#define GSL_LB __launch_bounds__(kMaxThreads)
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
CURRENT = {
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
    K7: ([SUM, CUR_HEAD, cur_bounds(K7),
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
          "six_divisions": ["GSL_DIVIDE"],
          "three_blocks_per_sm": ["GSL_BLOCKS=3"]}),
}

# the kernels before the transposed sums
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
""")
OLD_ATTRS = """
extern "C" int gsl_parts_attributes(int C, int ts, int* out) {
  const int bs = ts * ts, nw = bs / 32, R = %(geom)s + C;
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
PREVIOUS = {
    K3S: ([OLD_SUM, OLD_CROSS, OLD_HEAD,
           ("const int gid = gids[idx];",
            "\n#ifdef GSL_NO_GATHER\nconst int gid = gids[start];\n#else\n"
            "const int gid = gids[idx];\n#endif\n"),
           ("const uint64_t ranks = stp::window_ranks(a, d);",
            "\n#ifdef GSL_NO_RANK\nconst uint64_t ranks = stp::kIdentity;"
            " (void)d;\n#else\nconst uint64_t ranks = stp::window_ranks(a, d);"
            "\n#endif\n"),
           ("__global__ void rasterize_bwd_stp_kernel(",
            "__global__ void GSL_LB rasterize_bwd_stp_kernel(")],
          {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
           "first_slot_fields": ["GSL_NO_GATHER"],
           "no_rank_count": ["GSL_NO_RANK"],
           "no_cross_warp_sum": ["GSL_NO_CROSS"],
           "none_of_the_four": ["GSL_NO_SUMS", "GSL_NO_GATHER", "GSL_NO_RANK",
                                "GSL_NO_CROSS"],
           "three_blocks_per_sm": ["GSL_BLOCKS=3"]}),
    K7: ([OLD_SUM, OLD_CROSS, OLD_HEAD,
          ("const int gid = gids[base + tid];",
           "\n#ifdef GSL_NO_GATHER\nconst int gid = gids[start];\n#else\n"
           "const int gid = gids[base + tid];\n#endif\n"),
          ("__global__ void rasterize_surfels_bwd_kernel(",
           "__global__ void GSL_LB rasterize_surfels_bwd_kernel(")],
         {"whole": [], "no_warp_sums": ["GSL_NO_SUMS"],
          "first_slot_fields": ["GSL_NO_GATHER"],
          "no_cross_warp_sum": ["GSL_NO_CROSS"],
          "none_of_the_three": ["GSL_NO_SUMS", "GSL_NO_GATHER",
                                "GSL_NO_CROSS"],
          "five_blocks_per_sm": ["GSL_BLOCKS=5"]}),
}
OLD_WORDS = {
    K3S: dict(geom="6", ct=3, fn=KERNEL_FN[K3S],
              words="(size_t)(stp::kFields + C) * kW + (size_t)nw * kW * R"
                    " + (size_t)nw * kW + 2 * (size_t)kW * bs"),
    K7: dict(geom="surfel::kGeom", ct=6, fn=KERNEL_FN[K7],
             words="(size_t)(surfel::kSplat + C) * kBatch + (size_t)nw * "
                   "kBatch * R + (size_t)nw * kBatch"),
}
ATTRS = {K3S: "gsl_rasterize_bwd_stp_attributes",
         K7: "gsl_rasterize_surfels_bwd_attributes"}


def write_copy(design, name, csrc):
    """The kernel's source with the design's switches, and an entry point
    for its attributes."""
    patches = (CURRENT if design == "current" else PREVIOUS)[name][0]
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


def build(designs):
    """Every variant, one nvcc each, all started together."""
    nvcc = cuda_build._nvcc()
    jobs = {}
    os.makedirs(OUT, exist_ok=True)
    for design, csrc in designs.items():
        table = CURRENT if design == "current" else PREVIOUS
        for name, (_, variants) in table.items():
            src = write_copy(design, name, csrc)
            for variant, defines in variants.items():
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


def k3s_inputs(arrays):
    """The bench pose at C = 3, as chip_smoke.check_stp_kernels builds it:
    the wrapper's arguments."""
    H, W, TILE = CS.H, CS.W, CS.TILE
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = tile_renderer.TileRendererConfig().instantiate()
    cam = CS.camera(np.eye(4))
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    opac = renderer.get_opacities(state, proj).contiguous()
    ch = CS.channels_for(state, renderer, proj, cam, 3)
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


def k7_inputs(arrays):
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
    _, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TILE)
    gen = torch.Generator(device="cuda").manual_seed(10)
    g_out = torch.randn((H, W, 6), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    return (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)


def launcher(name, lib, args, rows):
    """A call of the copy's C entry point on the wrapper's arguments."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    H, W = CS.H, CS.W
    tiles_x, tiles_y = -(-W // CS.TILE), -(-H // CS.TILE)
    if name == K3S:
        fn = lib.gsl_rasterize_bwd_stp
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 6)
        call = (*map(ptr, args[:6]), args[3].shape[1], ptr(args[6]),
                ptr(args[7]), tiles_x * tiles_y, tiles_x, CS.TILE, H, W,
                *map(ptr, args[8:12]), ptr(rows), stream)
    else:
        fn = lib.gsl_rasterize_surfels_bwd
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        call = (ptr(args[0]), ptr(args[1]), args[1].shape[1], ptr(args[2]),
                ptr(args[3]), tiles_x * tiles_y, tiles_x, CS.TILE, H, W,
                *map(ptr, args[4:8]), ptr(rows), stream)
    return lambda: cuda_build.check(lib, fn(*call), name)


def time_kernel(name, libs, designs, args, wrapper):
    C = args[3].shape[1] if name == K3S else args[1].shape[1]
    want = wrapper(*args)
    rows = torch.zeros_like(want)
    result = {"wrapper_ms": CS.cuda_ms(lambda: wrapper(*args), 20)}
    for design in designs:
        variants = (CURRENT if design == "current" else PREVIOUS)[name][1]
        for variant in [*variants, "whole"]:
            lib = libs[(design, name, variant)]
            run = launcher(name, lib, args, rows)
            run()
            torch.cuda.synchronize()
            ms = CS.cuda_ms(run, 20)
            same = (bool(torch.equal(rows, want))
                    if design == "current" and variant == "whole" else None)
            attrs = attributes(lib, C)
            result.setdefault(design, {}).setdefault(variant, {
                "ms": [], **attrs})["ms"].append(ms)
            print(f"{name} {design} {variant}: {ms:.4f} ms {attrs}"
                  + ("" if same is None else
                     f"; rows equal the package's kernel's: {same}"),
                  flush=True)
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--previous", help="a directory holding "
                        "gsl_tpu_torch/csrc of the kernels before the "
                        "transposed sums")
    opts = parser.parse_args()
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
        pending = pool.submit(build, designs)
        arrays = CS.scene_arrays(CS.N_GAUSSIANS)
        libs = pending.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": smi}
    with torch.no_grad():
        args = k3s_inputs(arrays)
        report[K3S] = time_kernel(K3S, libs, designs, args,
                                  STP.rasterize_bwd_stp)
        stats = {}
        STP.rasterize_bwd_stp_plain(*args, stats=stats)
        report[K3S]["stats"] = stats
        print(f"{K3S} plain version's counts: {stats}", flush=True)
        del args
        torch.cuda.empty_cache()
        args = k7_inputs(arrays)
        report[K7] = time_kernel(K7, libs, designs, args,
                                 SR.rasterize_surfels_bwd)
        stats = {}
        SR.rasterize_surfels_bwd_plain(*args, stats=stats)
        report[K7]["stats"] = stats
        print(f"{K7} plain version's counts: {stats}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_parts.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
