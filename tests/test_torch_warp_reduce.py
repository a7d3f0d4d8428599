"""`gsl_tpu_torch/csrc/warp_reduce.cuh`, the transposed warp sum of the
backward kernels K3s and K7, on the CPU: the header is compiled with the
host's C++ compiler against a stand-in for the CUDA runtime in which 32
threads are the lanes of a warp and `__shfl_xor_sync` trades values through
a barrier. For every count of values from 1 to 32 every lane's sum must be
the sum over the lanes of the value `transpose_index` names, and each value
must have exactly one lane for which `transpose_writer` holds."""
import pathlib
import shutil
import subprocess

import pytest

CSRC = pathlib.Path(__file__).resolve().parent.parent / "gsl_tpu_torch" / "csrc"

LANES = r"""
#pragma once
#include <barrier>
#define __device__
#define __host__
#define __forceinline__ inline
extern thread_local int lane_id;
extern std::barrier<>* warp_barrier;
extern float exchange[32];
inline float __shfl_xor_sync(unsigned, float v, int o) {
  exchange[lane_id] = v;
  warp_barrier->arrive_and_wait();
  const float r = exchange[lane_id ^ o];
  warp_barrier->arrive_and_wait();
  return r;
}
"""

CHECK = r"""
#include <cmath>
#include <cstdio>
#include <random>
#include <thread>
#include <utility>
#include <vector>
#include "cuda_runtime.h"
#include "warp_reduce.cuh"
thread_local int lane_id;
std::barrier<>* warp_barrier;
float exchange[32];

template <int L> int check() {
  std::mt19937 rng(L);
  std::uniform_real_distribution<float> uniform(-1.0f, 1.0f);
  float in[32][L];
  double want[L] = {};
  for (int l = 0; l < 32; ++l)
    for (int k = 0; k < L; ++k) want[k] += in[l][k] = uniform(rng);
  float out[32];
  std::barrier<> barrier(32);
  warp_barrier = &barrier;
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l) {
    lanes.emplace_back([&, l] {
      lane_id = l;
      float v[L];
      for (int k = 0; k < L; ++k) v[k] = in[l][k];
      out[l] = gsl::warp_transpose_sum<L>(v, l);
    });
  }
  for (auto& t : lanes) t.join();
  int bad = 0, writers[L] = {};
  for (int l = 0; l < 32; ++l) {
    const int k = gsl::transpose_index<L>(l);
    if (k >= L || (k >= 0 && std::fabs(out[l] - want[k]) > 1e-4)) ++bad;
    if (gsl::transpose_writer<L>(l)) {
      if (k < 0) ++bad; else ++writers[k];
    }
  }
  for (int k = 0; k < L; ++k) bad += writers[k] != 1;
  if (bad) std::printf("L = %d: %d wrong\n", L, bad);
  return bad;
}

template <int... Ls> int check_all(std::integer_sequence<int, Ls...>) {
  return (check<Ls + 1>() + ...);
}

int main() { return check_all(std::make_integer_sequence<int, 32>{}) != 0; }
"""


def test_transposed_warp_sum_on_an_emulated_warp(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "cuda_runtime.h").write_text(LANES)
    (tmp_path / "check.cpp").write_text(CHECK)
    exe = tmp_path / "check"
    build = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", "-I", str(tmp_path), "-I",
         str(CSRC), str(tmp_path / "check.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-3000:]
