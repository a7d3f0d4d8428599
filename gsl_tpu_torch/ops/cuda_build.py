"""Build the CUDA kernels under ``gsl_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into ``gsl_tpu_torch/build/lib<name>-<digest>.so``, a shared
library with a plain C interface, and loaded with ``ctypes``. The digest
covers the source, the headers (``csrc/*.cuh``) and the flags, so an
edited source builds anew, and a build with extra flags (`NO_CONTRACTION`,
for holding a kernel's arithmetic against its plain version) lies beside
the usual one. The build never includes PyTorch's headers, which keeps it
to seconds.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; `check` raises on a nonzero
code. `check_cuda`, `ptr`, `stream` and `kernel_attributes` are what the
wrappers share to call them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("expand", "rasterize_fwd", "rasterize_bwd", "reduce_grads",
           "surfel_expand", "surfel_fwd", "surfel_bwd", "rasterize_fwd_stp",
           "rasterize_bwd_stp", "sh_fwd", "sh_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# expand.cu and the SH kernels must round exactly as PyTorch's elementwise
# ops do (their plain versions are held to them bit for bit), so no
# multiply-add contraction there
NO_CONTRACTION = ("-fmad=false",)
EXTRA_FLAGS = {"expand": NO_CONTRACTION, "sh_fwd": NO_CONTRACTION,
               "sh_bwd": NO_CONTRACTION}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _flags(name: str, extra: tuple = ()) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ()) + extra


def library_path(name: str, extra: tuple = ()) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers
        + " ".join(_flags(name, extra)).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names=SOURCES, extra: tuple = ()) -> dict:
    """Compile every missing library of `names` (with the `extra` flags
    added), one nvcc per source, all started together. Returns
    {name: compiler log} (ptxas prints each kernel's registers and shared
    memory). Raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name, extra)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name, extra), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)  # atomic: readers never see half a library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str, extra: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    build((name,), extra)
    lib = ctypes.CDLL(str(library_path(name, extra)))
    lib.gsl_error_string.argtypes = [ctypes.c_int]
    lib.gsl_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.gsl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_cuda(what, *tensors):
    """The device of `tensors`; raises unless all are contiguous and on
    the first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous and "
                             f"on {dev}")
    return dev


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """The current CUDA stream of `dev`, for an entry point's last
    argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def kernel_attributes(lib, entry: str, *args: int):
    """What the card's runtime reports for the kernel of C entry point
    `entry` that `args` select (for the raster kernels the channel count
    and the tile size): registers per thread, local (spill) bytes per thread
    (cudaFuncGetAttributes), dynamic shared bytes per block, and resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Needs a
    card."""
    out = (ctypes.c_int * 4)()
    code = getattr(lib, entry)(*args, out)
    check(lib, code, entry)
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2], "blocks_per_sm": out[3]}
