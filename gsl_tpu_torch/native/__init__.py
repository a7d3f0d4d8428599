"""Host-side C++ for the port: the COLMAP ``points3D.bin`` reader.

``native/colmap_reader.cpp`` is compiled on first use with ``g++ -O3
-shared -fPIC`` into ``gsl_tpu_torch/build/libcolmap_reader-<digest>.so``
(the digest covers the source and the flags; the directory is
git-ignored, as for the CUDA kernels of ``ops/cuda_build.py``) and loaded
with ``ctypes``. A build or read that fails raises, with the compiler's
message: nothing falls back to the Python reader on its own (gsl_tpu's
does, silently).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "colmap_reader.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libcolmap_reader-{digest}.so"


def build() -> Path:
    """Compile the reader unless its library exists; -> its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native reader build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native reader build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: readers never see half a library
    return out


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.colmap_count_points3d.restype = ctypes.c_int64
    lib.colmap_count_points3d.argtypes = [ctypes.c_char_p]
    lib.colmap_read_points3d.restype = ctypes.c_int64
    lib.colmap_read_points3d.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    return lib


def load() -> ctypes.CDLL:
    """The loaded reader library, built if missing."""
    with _LOCK:
        return _load(str(build()))


def read_points3d_native(path: str
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points3D.bin -> (xyz [n, 3] float64, rgb [n, 3] uint8, err [n]
    float64). Raises if the file cannot be read or ends early."""
    lib = load()
    n = lib.colmap_count_points3d(os.fsencode(path))
    if n < 0:
        raise OSError(f"cannot read {path}")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.colmap_read_points3d(os.fsencode(path), xyz, rgb, err)
    if got != n:
        raise ValueError(f"{path}: {n} points in the header, but the file "
                         "ends early")
    return xyz, rgb, err
