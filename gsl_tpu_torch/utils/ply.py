"""Gaussian PLY I/O in the Inria layout (binary PLY, no plyfile).

A copy of ``gsl_tpu/utils/ply.py``, so either package reads the other's
files: properties x, y, z, nx, ny, nz, f_dc_{0..2}, f_rest_{..}, opacity,
scale_{0..2}, rot_{0..3}; f_rest stored channel-major like Inria; raw
(pre-activation) values.
"""
from __future__ import annotations

import io
import os

import numpy as np


def save_gaussian_ply(path: str, means: np.ndarray, scales: np.ndarray,
                      rotations: np.ndarray, opacities: np.ndarray,
                      shs_dc: np.ndarray, shs_rest: np.ndarray):
    """Raw parameters: means [N,3], scales [N,3] log-space, rotations
    [N,4] wxyz, opacities [N,1] logit, shs_dc [N,1,3], shs_rest [N,K-1,3]."""
    n = means.shape[0]
    f_dc = shs_dc.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    f_rest = shs_rest.transpose(0, 2, 1).reshape(n, -1)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scales.shape[1])]
             + [f"rot_{i}" for i in range(4)])
    cols = np.concatenate([
        means, np.zeros((n, 3), np.float32), f_dc, f_rest,
        opacities.reshape(n, 1), scales, rotations,
    ], axis=1).astype("<f4")
    if cols.shape[1] != len(names):
        raise ValueError(f"{cols.shape[1]} columns for {len(names)} names")

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(cols).tobytes())


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def load_gaussian_ply(path: str) -> dict:
    """Returns a dict of raw numpy arrays (means, scales, rotations,
    opacities, shs_dc, shs_rest). Accepts ascii or binary files, mixed
    property types, any SH degree 0..3, missing normals, unknown extra
    properties, and 2-scale (2DGS) exports, whose missing third scale is
    padded with log(1e-6)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    n = None
    props = []          # (name, numpy dtype str)
    fmt = "binary_little_endian"
    in_vertex = False
    for line in header:
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "format":
            fmt = toks[1]
        elif toks[0] == "element":
            in_vertex = toks[1] == "vertex"
            if in_vertex:
                n = int(toks[2])
        elif toks[0] == "property" and in_vertex:
            if toks[1] == "list":
                raise ValueError("list properties unsupported in "
                                 "gaussian plys")
            props.append((toks[2], _PLY_TYPES[toks[1]]))
    if n is None:
        raise ValueError(f"no vertex element in the header of {path}")
    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = np.loadtxt(io.StringIO(
            data[head_end:].decode("ascii")), ndmin=2)[:n]
        col = {nm: rows[:, i].astype(np.float32)
               for i, nm in enumerate(names)}
    else:
        if fmt == "binary_big_endian":
            props = [(nm, dt.replace("<", ">")) for nm, dt in props]
        rec = np.frombuffer(data[head_end:],
                            dtype=np.dtype(props), count=n)
        col = {nm: rec[nm].astype(np.float32) for nm in names}

    means = np.stack([col["x"], col["y"], col["z"]], axis=-1)
    n_dc = sum(1 for nm in names if nm.startswith("f_dc_"))
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    f_dc = np.stack([col[f"f_dc_{i}"] for i in range(n_dc)], axis=-1)
    shs_dc = f_dc.reshape(n, 3, -1).transpose(0, 2, 1)
    if n_rest:
        f_rest = np.stack([col[f"f_rest_{i}"] for i in range(n_rest)],
                          axis=-1)
        shs_rest = f_rest.reshape(n, 3, -1).transpose(0, 2, 1)
    else:
        shs_rest = np.zeros((n, 0, 3), np.float32)
    n_scale = sum(1 for nm in names if nm.startswith("scale_"))
    scales = np.stack([col[f"scale_{i}"] for i in range(n_scale)], axis=-1)
    if n_scale == 2:
        scales = np.concatenate(
            [scales, np.full((n, 1), np.log(1e-6), np.float32)], axis=-1)
    rotations = np.stack([col[f"rot_{i}"] for i in range(4)], axis=-1)
    opacities = col["opacity"].reshape(n, 1)
    return dict(means=means, scales=scales, rotations=rotations,
                opacities=opacities, shs_dc=shs_dc, shs_rest=shs_rest)


def save_state_ply(path: str, state) -> int:
    """Save a GaussianState (alive rows only). Returns the row count."""
    alive = state.alive.cpu().numpy().astype(bool)
    p = state.params

    def rows(t):
        return t.detach().cpu().numpy()[alive]

    save_gaussian_ply(path, rows(p.means), rows(p.scales),
                      rows(p.rotations), rows(p.opacities), rows(p.shs_dc),
                      rows(p.shs_rest))
    return int(alive.sum())
