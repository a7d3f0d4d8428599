"""Rigid and similarity transforms of a Gaussian model that keep its
spherical harmonics right.

Port of ``gsl_tpu/utils/gaussian_transforms.py``: rotate, translate and
uniformly scale a state, rotating the SH coefficients of bands 1..3 with
the rotation. Each band's matrix is the least-squares solution of
B_j(R^-1 d) = sum_i B_i(d) M[i, j] over 256 seeded unit directions, with
the basis of ``ops/sh.py`` in float64 (the JAX package evaluates it in
float32). The matrices are applied on the state's device, one einsum a
band, so the coefficients never leave it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.colmap_io import rotmat_to_qvec
from ..models.gaussian import GaussianState
from ..ops.sh import sh_basis
from .device import float32_math

_DEGREE_OF_REST = {0: 0, 3: 1, 8: 2, 15: 3}


def sh_rotation_matrices(R: np.ndarray, max_degree: int = 3):
    """[3x3, 5x5, 7x7][:max_degree] float64 matrices rotating real-SH
    coefficient vectors of bands 1.. in the basis order of ``ops/sh.py``."""
    R = np.asarray(R, np.float64)
    rng = np.random.RandomState(12345)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    A = sh_basis(torch.from_numpy(d), max_degree).numpy()
    Bm = sh_basis(torch.from_numpy(d @ R), max_degree).numpy()
    mats = []
    start = 1
    for l in range(1, max_degree + 1):
        size = 2 * l + 1
        M, *_ = np.linalg.lstsq(A[:, start:start + size],
                                Bm[:, start:start + size], rcond=None)
        mats.append(M)
        start += size
    return mats


def rotate_shs(shs_rest: torch.Tensor, R: np.ndarray) -> torch.Tensor:
    """shs_rest [N, K-1, 3] -> the same coefficients rotated by R."""
    max_degree = _DEGREE_OF_REST[shs_rest.shape[1]]
    if max_degree == 0:
        return shs_rest
    out = []
    start = 0
    with float32_math():
        for l, M in enumerate(sh_rotation_matrices(R, max_degree), start=1):
            size = 2 * l + 1
            m = torch.as_tensor(M, dtype=torch.float32,
                                device=shs_rest.device)
            out.append(torch.einsum("ij,njc->nic", m,
                                    shs_rest[:, start:start + size, :]))
            start += size
    return torch.cat(out, dim=1)


def _quat_multiply(q1, q2: torch.Tensor) -> torch.Tensor:
    """wxyz Hamilton product of one quaternion (numbers) and a batch."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _with_params(state: GaussianState, **changed) -> GaussianState:
    return GaussianState(params=dataclasses.replace(state.params, **changed),
                         alive=state.alive, extra=state.extra)


def rotate_state(state: GaussianState, R: np.ndarray) -> GaussianState:
    """means' = R @ means; rotations' = q_R * q; SH bands rotated."""
    p = state.params
    qR = rotmat_to_qvec(np.asarray(R, np.float64))
    Rt = torch.as_tensor(np.asarray(R), dtype=torch.float32,
                         device=p.means.device)
    with float32_math():
        means = p.means @ Rt.T
    return _with_params(
        state, means=means,
        rotations=_quat_multiply(tuple(float(x) for x in qR), p.rotations),
        shs_rest=rotate_shs(p.shs_rest, R))


def translate_state(state: GaussianState, t) -> GaussianState:
    p = state.params
    return _with_params(state, means=p.means + torch.as_tensor(
        np.asarray(t), dtype=torch.float32, device=p.means.device))


def scale_state(state: GaussianState, s: float) -> GaussianState:
    """Uniform similarity scale about the origin."""
    p = state.params
    return _with_params(state, means=p.means * s,
                        scales=p.scales + float(np.log(s)))
