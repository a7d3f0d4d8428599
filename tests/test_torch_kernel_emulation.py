"""The forward kernels K2 (`csrc/rasterize_fwd.cu`) and K2s
(`csrc/rasterize_fwd_stp.cu`), the StopThePop backward K3s
(`csrc/rasterize_bwd_stp.cu`) and the SH colour pair (`csrc/sh_fwd.cu`,
`csrc/sh_bwd.cu`), their CUDA sources run on the CPU.

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
check. The SH kernels round every operation as their plain versions do
(both sources are built without contraction on the card too), so they are
held to them bit for bit."""
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
from gsl_tpu_torch.ops import sh as SH
from gsl_tpu_torch.ops.projection import project_gaussians
from gsl_tpu_torch.utils.convert import state_from_raw_arrays

CSRC = pathlib.Path(__file__).resolve().parent.parent / "gsl_tpu_torch" / "csrc"
SHARE = 0.999

RUNTIME = r"""
#pragma once
#include <algorithm>
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
using std::max;
using std::min;
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof(u));
  return u;
}
struct int4 { int x, y, z, w; };
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
        r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\(([^;]*)\);",
        lambda m: (f"(emu::launch({m.group(2)}, [&] {{ "
                   f"{m.group(1)}({m.group(3)}); }}), 0);"), text, flags=re.S)
    assert "emu::launch" in text and "<<<" not in text
    return text.replace("#include <cuda_runtime.h>", "")


def build_host_libs(names, out):
    """{name: ctypes library} of the sources `names`, compiled for the host
    into the directory `out`, one compiler process each, all started
    together."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    (out / "cuda_pipeline.h").write_text("#pragma once\n")
    procs = {}
    for name in names:
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


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(
        ("rasterize_fwd", "rasterize_fwd_stp", "rasterize_bwd_stp"),
        tmp_path_factory.mktemp("emulated"))


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


# ---- the backward kernels' channel groups -----------------------------------

def _assert_groups_equal_one_pass(got, want, n_geom, calls, C, group):
    """The group split's rows against one pass over all channels: the
    calls one per group of `group` (the last the rest); every column
    within 1e-5 of its largest value (the geometry columns sum the
    groups' terms, each group rounding its own partial sums, and the
    plain version's vectorised pixel sums round by the channel count)."""
    assert calls == [group] * (C // group) + [C % group] * (C % group > 0)
    assert got.shape == want.shape
    scale = want.abs().amax(0)
    assert bool((scale > 0).all())
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("n_channels", [37, 64, 128])
def test_k3_channel_groups_equal_one_plain_pass(n_channels):
    """`backward_by_channel_groups` over K3's plain version in groups of
    36 (K3's largest at tile 16), alpha's cotangent with the first group
    only, equals one plain pass over all C channels."""
    C, ts, width, height = n_channels, 16, 48, 32
    m2d, con, op, ch, _, _, gs, bounds = _inputs(300, C, ts, width, height,
                                                 stp=False, seed=C)
    _, t_fin, stop = R.rasterize_fwd_plain(m2d, con, op, ch, gs, bounds,
                                           height, width, ts)
    gen = torch.Generator().manual_seed(C)
    g_out = torch.randn((height, width, C), generator=gen)
    g_alpha = torch.randn((height, width), generator=gen)
    want = R.rasterize_bwd_plain(m2d, con, op, ch, gs, bounds, g_out,
                                 g_alpha, t_fin, stop, ts)
    calls = []

    def one(c, g, ga):
        calls.append(c.shape[1])
        assert c.is_contiguous() and g.is_contiguous()
        if len(calls) > 1:
            assert float(ga.abs().max()) == 0.0
        return R.rasterize_bwd_plain(m2d, con, op, c, gs, bounds, g, ga,
                                     t_fin, stop, ts)

    got = R.backward_by_channel_groups(one, ch, g_out, R.N_GEOM, 36,
                                       (g_alpha,))
    _assert_groups_equal_one_pass(got, want, R.N_GEOM, calls, C, 36)


def test_k7_channel_groups_equal_one_plain_pass():
    """The same over K7's plain version at C = 64 in groups of 60 (K7's
    largest at tile 16), alpha, depth and distortion cotangents with the
    first group only."""
    from gsl_tpu_torch.ops import surfel_rasterize as SR
    from gsl_tpu_torch.ops.surfel import project_surfels
    C, ts, width, height, n = 64, 16, 48, 32, 60
    rng = np.random.RandomState(5)
    w2c = torch.eye(4)
    w2c[2, 3] = 4.0
    proj = project_surfels(
        torch.from_numpy((rng.randn(n, 3) * 0.7).astype(np.float32)),
        torch.from_numpy((rng.rand(n, 2) * 0.3 + 0.05).astype(np.float32)),
        torch.from_numpy(rng.randn(n, 4).astype(np.float32)), w2c, 40.0,
        40.0, width / 2, height / 2, width, height)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           torch.from_numpy((rng.rand(n) * 0.7 + 0.2
                                             ).astype(np.float32)))
    ch = torch.from_numpy(rng.rand(n, C).astype(np.float32))
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    height, width, ts)
    keys, gids = SR.surfel_expand_plain(isects, proj.depths, tiles_x,
                                        tiles_y)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    gs = gs[:int(bounds[-1])].contiguous()
    _, aux, stop = SR.rasterize_surfels_fwd_plain(geom, ch, gs, bounds,
                                                  height, width, ts)
    gen = torch.Generator().manual_seed(7)
    g_out = torch.randn((height, width, C), generator=gen)
    g_aux = torch.randn((3, height, width), generator=gen) * 0.1
    want = SR.rasterize_surfels_bwd_plain(geom, ch, gs, bounds, g_out,
                                          g_aux, aux, stop, ts)
    calls = []

    def one(c, g, ga):
        calls.append(c.shape[1])
        return SR.rasterize_surfels_bwd_plain(geom, c, gs, bounds, g, ga,
                                              aux, stop, ts)

    got = R.backward_by_channel_groups(one, ch, g_out, SR.N_GEOM_S, 60,
                                       (g_aux,))
    _assert_groups_equal_one_pass(got, want, SR.N_GEOM_S, calls, C, 60)


def test_k3s_source_in_channel_groups_matches_plain(host_libs):
    """K3s's CUDA source, emulated, past its group: C = 12 in launches of
    5 channels (5, 5, 2) through `backward_by_channel_groups`, against
    the plain version's one pass, at tile size 8 (blocks of 64 host
    threads); and the source's largest group at tile 16, from its
    shared-memory formula, is 88."""
    n_channels, ts, width, height = 12, 8, 24, 24
    fwd = _inputs(300, n_channels, ts, width, height, stp=True, seed=4)
    m2d, con, op, ch, depths, kz, gs, bounds = fwd
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    n_tiles = tiles_x * tiles_y
    _, t_p, _, ckpt_p = STP.rasterize_fwd_stp_plain(
        *fwd, height, width, ts, checkpoints=True)
    gen = torch.Generator().manual_seed(3)
    g_out = torch.randn((height, width, n_channels), generator=gen)
    g_alpha = torch.randn((height, width), generator=gen)
    lib = host_libs["rasterize_bwd_stp"]
    assert lib.gsl_rasterize_bwd_stp_max_group(16) == 88
    bwd = lib.gsl_rasterize_bwd_stp
    bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 6)
    calls = []

    def one(c, g, ga):
        calls.append(c.shape[1])
        rows = torch.zeros((gs.numel(), 6 + c.shape[1]))
        assert bwd(_p(m2d), _p(con), _p(op), _p(c), _p(depths), _p(kz),
                   c.shape[1], _p(gs), _p(bounds), n_tiles, tiles_x, ts,
                   height, width, _p(g), _p(ga), _p(t_p), _p(ckpt_p),
                   _p(rows), None) == 0
        return rows

    got = R.backward_by_channel_groups(one, ch, g_out, R.N_GEOM, 5,
                                       (g_alpha,))
    assert calls == [5, 5, 2]
    want = STP.rasterize_bwd_stp_plain(*fwd, g_out, g_alpha, t_p, ckpt_p,
                                       ts)
    assert float(want.abs().max()) > 1.0
    assert _close_share(got, want, atol=1e-3) >= SHARE


# ---- the SH colour kernels ---------------------------------------------------

@pytest.fixture(scope="module")
def sh_libs(tmp_path_factory):
    libs = build_host_libs(("sh_fwd", "sh_bwd"),
                           tmp_path_factory.mktemp("emulated_sh"))
    libs["sh_fwd"].gsl_sh_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 3)
    libs["sh_bwd"].gsl_sh_bwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 3)
    return libs


# the DC coefficient whose term C0 * dc is exactly -0.5 in float32
# (rgb_to_sh0 of black): SH + 0.5 == 0, where torch.clamp's gradient passes
DC_AT_ZERO = -1.772453784942627


def _placed(a, offset):
    """A float32 tensor holding `a`, `offset` floats past a 16-byte
    boundary (the kernels' 16-byte copies take an aligned span only)."""
    buf = torch.zeros(a.size + 4)
    out = buf[offset:offset + a.size].view(a.shape)
    out.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))
    return out


def _sh_inputs(n, n_rest, seed, offset=0):
    """(means, centre, shs_dc, shs_rest): coefficients wide enough that a
    fifth or more of the channels clamp at 0, and rows 0-4 exactly at 0."""
    rng = np.random.RandomState(seed)
    dc = rng.normal(size=(n, 1, 3)) * 2.0
    rest = rng.normal(size=(n, n_rest, 3)) * 0.3
    dc[:5], rest[:5] = DC_AT_ZERO, 0.0
    means = rng.normal(size=(n, 3)) * 2.0
    means[5] = [0.5, -1.0, 2.0]   # the centre itself: a zero direction
    return (_placed(means, offset), _placed(np.array([0.5, -1.0, 2.0]), 0),
            _placed(dc, offset), _placed(rest, offset))


def _sh_kernels(libs, means, centre, dc, rest, degree, grad):
    """The emulated pair: (rgb, mask) and (grad shs_dc, grad shs_rest),
    their outputs filled with NaN (and the mask with 0xAA) first."""
    n, n_rest = means.shape[0], rest.shape[1]
    rgb = torch.full((n, 3), float("nan"))
    mask = torch.full((n,), 0xAA, dtype=torch.uint8)
    assert libs["sh_fwd"].gsl_sh_fwd(
        _p(means), _p(centre), _p(dc), _p(rest), n_rest, degree, n, _p(rgb),
        _p(mask), None) == 0
    g_dc = torch.full((n, 1, 3), float("nan"))
    g_rest = torch.full((n, n_rest, 3), float("nan"))
    assert libs["sh_bwd"].gsl_sh_bwd(
        _p(grad), grad.stride(0), _p(means), _p(centre), _p(mask), n_rest,
        degree, n, _p(g_dc), _p(g_rest), None) == 0
    return rgb, mask, g_dc, g_rest


def _bits(t):
    return t.view(torch.int32)


SH_CASES = [pytest.param(d, r, id=f"degree{d}-rest{r}")
            for d in range(4) for r in (0, 3, 8, 15)
            if (d + 1) ** 2 <= 1 + r]


@pytest.mark.parametrize("degree,n_rest", SH_CASES)
def test_sh_sources_equal_plain(sh_libs, degree, n_rest):
    """The SH pair against its plain versions at every degree and K - 1 of
    {0, 3, 8, 15} it takes, 300 rows (two blocks of 128 and a part), the
    gradient read at a row stride of 11 (the rasterizer's rows): colours,
    mask and both gradients bit for bit, the bands above the degree 0;
    rows exactly at 0 pass their gradient, as torch.clamp's do."""
    n = 300
    means, centre, dc, rest = _sh_inputs(n, n_rest, seed=degree + n_rest)
    wide = torch.from_numpy(np.random.RandomState(1).normal(
        size=(n, 11)).astype(np.float32))
    grad = wide[:, 8:]
    rgb, mask, g_dc, g_rest = _sh_kernels(sh_libs, means, centre, dc, rest,
                                          degree, grad)
    want_rgb, want_mask = SH.sh_colors_fwd_plain(means, centre, dc, rest,
                                                 degree)
    assert torch.equal(_bits(rgb), _bits(want_rgb))
    assert torch.equal(mask, want_mask)
    assert bool((mask[:5] == 7).all()) and bool((rgb[:5] == 0).all())
    assert 0.1 < float((want_rgb == 0).float().mean()) < 0.6
    want_dc, want_rest = SH.sh_colors_bwd_plain(grad, means, centre, mask,
                                                degree, n_rest)
    assert torch.equal(_bits(g_dc), _bits(want_dc))
    assert torch.equal(_bits(g_rest), _bits(want_rest))
    assert bool((g_dc[:5] != 0).all())
    assert bool((g_rest[:, (degree + 1) ** 2 - 1:] == 0).all())


def test_sh_sources_take_unaligned_rows(sh_libs):
    """Every tensor one float past a 16-byte boundary: the blocks copy
    their spans a float at a time, with the same results."""
    n, n_rest = 260, 15
    grad = torch.from_numpy(np.random.RandomState(2).normal(
        size=(n, 3)).astype(np.float32))
    outs = []
    for offset in (0, 1):
        args = _sh_inputs(n, n_rest, seed=7, offset=offset)
        assert (args[3].data_ptr() % 16 == 0) == (offset == 0)
        outs.append(_sh_kernels(sh_libs, *args, 3, _placed(grad.numpy(),
                                                           offset)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
