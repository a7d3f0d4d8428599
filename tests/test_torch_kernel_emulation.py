"""The forward kernels K2 (`csrc/rasterize_fwd.cu`) and K2s
(`csrc/rasterize_fwd_stp.cu`) and the StopThePop backward K3s
(`csrc/rasterize_bwd_stp.cu`), their CUDA sources run on the CPU.

Each source is compiled with the host's C++ compiler against a stand-in
for the CUDA runtime in which every CUDA thread is a host thread and the
blocks run one after another: `__syncthreads` and the warp votes and
shuffles are barriers, and cp.async copies at once. The stand-in keeps the
kernels' control flow (batches, double buffers, the warp's and the block's
exits, the windows' order) and rounds as the plain versions do (no
multiply-add contraction), so the kernels' outputs must agree with the
plain versions at the card tests' shares: i_stop at every pixel but those
whose exponential rounds apart between the C library and PyTorch. What it
cannot show is the card's own behaviour: timing, races between real
threads, the compiler for sm_90a. Those the card tests and chip_smoke.py
check."""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops.projection import project_gaussians
from gsl_tpu_torch.utils.convert import state_from_raw_arrays

CSRC = pathlib.Path(__file__).resolve().parent.parent / "gsl_tpu_torch" / "csrc"
SHARE = 0.999

RUNTIME = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes*, F) {
  return 1; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int*, F, int, size_t) { return 1; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct Dim { unsigned x, y, z; };
inline thread_local Dim threadIdx, blockIdx;
inline Dim blockDim;
namespace emu {
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::atomic<int> count{0};
  int votes[1024];
  float exchange[1024];
};
inline Block* block;
alignas(16) inline float smem[64 * 1024];
inline void launch(int grid, int threads, size_t, void*,
                   std::function<void()> kernel) {
  blockDim = Dim{static_cast<unsigned>(threads), 1, 1};
  for (int b = 0; b < grid; ++b) {
    Block blk;
    blk.bar = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk.warps.push_back(std::make_unique<std::barrier<>>(32));
    block = &blk;
    std::memset(smem, 0xff, sizeof(smem));  // what a block finds: garbage
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t, b] {
        threadIdx = Dim{static_cast<unsigned>(t), 0, 0};
        blockIdx = Dim{static_cast<unsigned>(b), 0, 0};
        kernel();
      });
    }
    for (auto& t : ts) t.join();
  }
}
inline bool vote(bool pred, bool all) {
  const int t = threadIdx.x;
  auto& bar = *block->warps[t / 32];
  block->votes[t] = pred;
  bar.arrive_and_wait();
  bool r = all;
  for (int l = t & ~31; l < (t & ~31) + 32; ++l)
    r = all ? r && block->votes[l] : r || block->votes[l];
  bar.arrive_and_wait();
  return r;
}
}  // namespace emu
inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }
inline int __syncthreads_count(int pred) {
  if (pred) emu::block->count++;
  __syncthreads();
  const int r = emu::block->count.load();
  __syncthreads();
  if (threadIdx.x == 0) emu::block->count = 0;
  __syncthreads();
  return r;
}
inline bool __all_sync(unsigned, bool p) { return emu::vote(p, true); }
inline bool __any_sync(unsigned, bool p) { return emu::vote(p, false); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x;
  auto& bar = *emu::block->warps[t / 32];
  emu::block->exchange[t] = v;
  bar.arrive_and_wait();
  const float r = emu::block->exchange[(t & ~31) | ((t & 31) ^ o)];
  bar.arrive_and_wait();
  return r;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
"""


def _host_source(name):
    """The kernel's source as host C++: shared memory from the stand-in,
    each launch a call of emu::launch."""
    text = (CSRC / f"{name}.cu").read_text()
    text = re.sub(r"extern __shared__ (__align__\(16\) )?float smem\[\];",
                  "float* smem = emu::smem;", text)
    text = re.sub(
        r"(\w+<\w+>)<<<([^>]*)>>>\(([^;]*)\);",
        lambda m: (f"(emu::launch({m.group(2)}, [&] {{ "
                   f"{m.group(1)}({m.group(3)}); }}), 0);"), text, flags=re.S)
    assert "emu::launch" in text and "<<<" not in text
    return text.replace("#include <cuda_runtime.h>", "")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("emulated")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    (out / "cuda_pipeline.h").write_text("#pragma once\n")
    procs = {}
    for name in ("rasterize_fwd", "rasterize_fwd_stp", "rasterize_bwd_stp"):
        src = out / f"{name}.cc"
        src.write_text('#include "cuda_runtime.h"\n' + _host_source(name))
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             "-ffp-contract=off", "-I", str(out), "-I", str(CSRC), "-o",
             str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _inputs(n, C, ts, width, height, stp, cut=None, seed=0):
    rng = np.random.RandomState(seed)
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(2, 6, (n, 1))], 1)
    arrays = {k: v.astype(np.float32) for k, v in dict(
        means=means, scales=rng.uniform(-3.5, -1.5, (n, 3)),
        rotations=rng.normal(size=(n, 4)),
        opacities=rng.uniform(-1, 2, (n, 1)),
        shs_dc=rng.normal(size=(n, 1, 3)) * 0.3,
        shs_rest=np.zeros((n, 15, 3))).items()}
    state = state_from_raw_arrays(arrays, device="cpu")
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fx=0.9 * width,
                      fy=0.9 * width, cx=width / 2, cy=height / 2,
                      width=width, height=height, device="cpu")
    proj = project_gaussians(state.get_means(), state.get_scales(),
                             state.get_rotations(), cam.world_to_camera,
                             cam.fx, cam.fy, cam.cx, cam.cy, width, height)
    op = state.get_opacities().contiguous()
    ch = torch.from_numpy(rng.rand(n, C).astype(np.float32))
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    kz = proj.depth_grads.contiguous()
    keys, gids = R.expand_plain(
        R.isect_encode(proj, height, width, ts), proj.means2d, proj.conics,
        op, proj.depths, tiles_x, tiles_y, ts, True, stp, kz if stp else None)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    gs = gs[:int(bounds[-1])].contiguous()
    if cut:
        counts = (bounds[1:] - bounds[:-1])
        keep = torch.minimum(counts, torch.tensor(cut)[
            torch.arange(counts.numel()) % len(cut)])
        gs = torch.cat([gs[int(s):int(s) + int(k)]
                        for s, k in zip(bounds[:-1], keep)])
        bounds = torch.cat([torch.zeros(1, dtype=torch.int64),
                            torch.cumsum(keep, 0)])
    return (proj.means2d.contiguous(), proj.conics.contiguous(), op, ch,
            proj.depths.contiguous(), kz, gs, bounds)


def _close_share(got, want, atol=2e-4):
    bad = (got - want).abs() > atol + 1e-3 * want.abs()
    return 1.0 - float(bad.float().mean())


# (channels, tile size, image width and height, cut lists): C = 11 takes
# two launches of channel groups; tile size 8 is one warp of two pixels a
# thread; 40 x 30 at tile size 5 leaves K2's last warp a thread past the
# tile's pixels and the last row and column of tiles partly outside; the
# cut lists end one past a window and one past a batch of 64
FWD_CASES = [pytest.param(*c, id=i) for i, c in (
    ("3", (3, 16, 64, 48, None)), ("11", (11, 16, 32, 32, None)),
    ("3-tile8", (3, 8, 32, 32, None)),
    ("3-cut", (3, 16, 96, 64, (1, 17, 65, 0, 47, 2, 129))))]


@pytest.mark.parametrize("n_channels,ts,width,height,cut", FWD_CASES + [
    pytest.param(3, 5, 40, 30, None, id="3-tile5")])
def test_k2_source_matches_plain(host_libs, n_channels, ts, width, height,
                                 cut):
    m2d, con, op, ch, _, _, gs, bounds = _inputs(
        1200, n_channels, ts, width, height, stp=False, cut=cut)
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    out = torch.full((height, width, n_channels), float("nan"))
    t_fin = torch.full((height, width), float("nan"))
    stop = torch.full((height, width), -1, dtype=torch.int32)
    fn = host_libs["rasterize_fwd"].gsl_rasterize_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4)
    for c0 in range(0, n_channels, 8):
        assert fn(_p(m2d), _p(con), _p(op), _p(ch), n_channels, c0,
                  min(8, n_channels - c0), _p(gs), _p(bounds),
                  tiles_x * tiles_y, tiles_x, ts, height, width, _p(out),
                  _p(t_fin), _p(stop), None) == 0
    out_p, t_p, stop_p = R.rasterize_fwd_plain(m2d, con, op, ch, gs, bounds,
                                               height, width, ts)
    assert float((stop == stop_p).float().mean()) >= SHARE
    assert bool((stop < R.NEVER_STOPPED).any())
    assert _close_share(out, out_p) >= SHARE
    assert _close_share(t_fin, t_p) >= SHARE


@pytest.mark.parametrize("n_channels,ts,width,height,cut", FWD_CASES)
def test_k2s_and_k3s_sources_match_plain(host_libs, n_channels, ts, width,
                                         height, cut):
    fwd = _inputs(1200, n_channels, ts, width, height, stp=True, cut=cut)
    m2d, con, op, ch, depths, kz, gs, bounds = fwd
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    n_tiles = tiles_x * tiles_y
    out = torch.full((height, width, n_channels), float("nan"))
    t_fin = torch.full((height, width), float("nan"))
    stop = torch.full((height, width), -1, dtype=torch.int32)
    ckpt = torch.full((STP.checkpoint_rows(gs.numel(), n_tiles), ts * ts),
                      float("nan"))
    fn = host_libs["rasterize_fwd_stp"].gsl_rasterize_fwd_stp
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    for c0 in range(0, n_channels, 8):
        assert fn(*map(_p, fwd[:6]), n_channels, c0, min(8, n_channels - c0),
                  _p(gs), _p(bounds), n_tiles, tiles_x, ts, height, width,
                  _p(out), _p(t_fin), _p(stop), _p(ckpt) if c0 == 0 else None,
                  None) == 0
    stats = {}
    out_p, t_p, _, ckpt_p = STP.rasterize_fwd_stp_plain(
        *fwd, height, width, ts, checkpoints=True, stats=stats)
    assert stats["unordered_windows"] > 0
    assert bool((stop == R.NEVER_STOPPED).all())
    assert _close_share(out, out_p) >= SHARE
    assert _close_share(t_fin, t_p) >= SHARE
    # the rows the backward reads: every window of every tile with slots
    st, en = bounds[:-1].tolist(), bounds[1:].tolist()
    rows = torch.zeros(ckpt.shape[0], dtype=torch.bool)
    for t, (a, b) in enumerate(zip(st, en)):
        if b > a:
            rows[a // STP.STP_WINDOW + t:(b - 1) // STP.STP_WINDOW + t + 1] = (
                True)
    assert _close_share(ckpt[rows], ckpt_p[rows]) >= SHARE

    gen = torch.Generator().manual_seed(3)
    g_out = torch.randn((height, width, n_channels), generator=gen)
    g_alpha = torch.randn((height, width), generator=gen)
    got = torch.zeros((gs.numel(), 6 + n_channels))
    bwd = host_libs["rasterize_bwd_stp"].gsl_rasterize_bwd_stp
    bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 6)
    assert bwd(*map(_p, fwd[:6]), n_channels, _p(gs), _p(bounds), n_tiles,
               tiles_x, ts, height, width, _p(g_out), _p(g_alpha), _p(t_fin),
               _p(ckpt), _p(got), None) == 0
    want = STP.rasterize_bwd_stp_plain(*fwd, g_out, g_alpha, t_p, ckpt_p, ts)
    assert float(want.abs().max()) > 1.0
    assert _close_share(got, want, atol=1e-3) >= SHARE
