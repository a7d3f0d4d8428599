"""TSDF fusion and isosurface extraction on the device, with no mesh
library.

Port of ``gsl_tpu/utils/mesh.py``:

- `TSDFVolume`: an axis-aligned grid of truncated signed distances and
  weights, torch tensors on the volume's device. `integrate` projects every
  voxel centre into one view's depth map and updates the weighted running
  mean of the truncated SDF (the KinectFusion update; open3d's
  `integrate` with voxel_size / sdf_trunc / depth_trunc).
- `marching_tetrahedra`: the isosurface from 6 tetrahedra per cell, whose
  16-case table is derived, not written out; neighbouring cells share the
  tetrahedra's faces, so the surface has no cracks. It runs in torch on
  the grid's device and gives gsl_tpu's vertices in gsl_tpu's order and
  its faces.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device


class TSDFVolume:
    """Axis-aligned TSDF grid with weighted-average integration."""

    def __init__(self, origin, resolution, voxel_size, sdf_trunc=None,
                 device=None):
        dev = resolve_device(device)
        self.origin = np.asarray(origin, np.float32)          # [3]
        self.resolution = tuple(int(r) for r in resolution)   # (X, Y, Z)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc if sdf_trunc is not None
                               else 5.0 * voxel_size)
        n = int(np.prod(self.resolution))
        self.tsdf = torch.ones((n,), dtype=torch.float32, device=dev)
        self.weight = torch.zeros((n,), dtype=torch.float32, device=dev)
        # centres in float64, then float32, as gsl_tpu computes them
        axes = [(torch.arange(r, dtype=torch.float64, device=dev) + 0.5)
                * self.voxel_size + float(o)
                for r, o in zip(self.resolution, self.origin)]
        self._centers = torch.stack(
            torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3).to(
                torch.float32)

    @property
    def device(self) -> torch.device:
        return self.tsdf.device

    def integrate(self, depth, w2c, K, alpha: Optional[torch.Tensor] = None,
                  depth_trunc: float = np.inf, alpha_thres: float = 0.5):
        """depth [H, W] metric z; w2c [4, 4]; K [3, 3]; alpha [H, W]: only
        pixels above `alpha_thres` count."""
        def on_device(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device)

        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight, self._centers, on_device(depth),
            on_device(w2c), on_device(K),
            None if alpha is None else on_device(alpha),
            self.sdf_trunc, float(depth_trunc), float(alpha_thres))

    def sdf_grid(self) -> torch.Tensor:
        """[X, Y, Z]; NaN where no view observed the voxel."""
        sdf = self.tsdf.reshape(self.resolution).clone()
        sdf[self.weight.reshape(self.resolution) <= 0] = float("nan")
        return sdf

    def extract_mesh(self, min_weight: float = 1.0):
        """-> (verts [V, 3] float32 in world units, faces [F, 3] int64),
        on the volume's device; voxels of weight below `min_weight` carry
        no surface."""
        sdf = self.tsdf.reshape(self.resolution).clone()
        sdf[self.weight.reshape(self.resolution) < min_weight] = float("nan")
        verts, faces = marching_tetrahedra(sdf, level=0.0)
        origin = torch.from_numpy(self.origin).to(verts.device)
        verts = verts * self.voxel_size + origin + 0.5 * self.voxel_size
        return verts, faces


def _integrate(tsdf, weight, centers, depth, w2c, K, alpha, sdf_trunc,
               depth_trunc, alpha_thres):
    H, W = depth.shape
    R, t = w2c[:3, :3], w2c[:3, 3]
    # p_cam = R c + t, summed elementwise: a matmul could take TF32 on the
    # card
    p_cam = [centers[:, 0] * R[k, 0] + centers[:, 1] * R[k, 1]
             + centers[:, 2] * R[k, 2] + t[k] for k in range(3)]
    z = p_cam[2]
    z_safe = torch.clamp(z, min=1e-6)
    u = K[0, 0] * p_cam[0] / z_safe + K[0, 2]
    v = K[1, 1] * p_cam[1] / z_safe + K[1, 2]
    # clamped before the conversion, which is undefined out of range; an
    # out-of-range u or v is not valid anyway
    ui = torch.clamp(torch.round(u), 0, W - 1).to(torch.int64)
    vi = torch.clamp(torch.round(v), 0, H - 1).to(torch.int64)
    d = depth[vi, ui]
    valid = ((z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
             & (d > 1e-4) & (d < depth_trunc))
    if alpha is not None:
        valid = valid & (alpha[vi, ui] > alpha_thres)
    sdf = (d - z) / sdf_trunc
    valid = valid & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    w_new = valid.to(torch.float32)
    wsum = weight + w_new
    tsdf = torch.where(
        wsum > 0,
        (tsdf * weight + sdf * w_new) / torch.clamp(wsum, min=1e-9), tsdf)
    return tsdf, wsum


# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------

# cube corner offsets (x, y, z)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)
# 6-tet decomposition of the cube around the 0-6 diagonal (consistent
# across neighbouring cells -> crack-free shared faces)
_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                  [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int64)


def _tet_cases():
    """case (4-bit inside mask) -> list of triangles, each triangle a list
    of 3 edges, each edge a (corner_i, corner_j) pair."""
    cases = []
    for mask in range(16):
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if not (mask >> i) & 1]
        if len(inside) in (0, 4):
            cases.append([])
        elif len(inside) == 1:
            i = inside[0]
            cases.append([[(i, outside[0]), (i, outside[1]),
                           (i, outside[2])]])
        elif len(inside) == 3:
            o = outside[0]
            cases.append([[(inside[0], o), (inside[2], o), (inside[1], o)]])
        else:  # two inside: quad from the 4 crossing edges, cyclic order
            i1, i2 = inside
            o1, o2 = outside
            e = [(i1, o1), (i1, o2), (i2, o2), (i2, o1)]
            cases.append([[e[0], e[1], e[2]], [e[0], e[2], e[3]]])
    return cases


_CASES = _tet_cases()


def marching_tetrahedra(sdf: torch.Tensor, level: float = 0.0):
    """sdf [X, Y, Z] (NaN = unobserved, skipped) -> (verts [V, 3] float32
    in voxel coordinates, faces [F, 3] int64), on the grid's device. A
    vertex is shared by every face that crosses its edge. The faces come
    in gsl_tpu's order: by tetrahedron, case, triangle of the case, cell."""
    X, Y, Z = sdf.shape
    dev = sdf.device
    n_vox = X * Y * Z
    flat = sdf.reshape(-1)
    # cell = its (0, 0, 0) corner; cells in x-major order
    cell = ((torch.arange(X - 1, device=dev)[:, None, None] * Y
             + torch.arange(Y - 1, device=dev)[None, :, None]) * Z
            + torch.arange(Z - 1, device=dev)[None, None, :]).reshape(-1)
    corner_off = torch.from_numpy(
        (_CORNERS[:, 0] * Y + _CORNERS[:, 1]) * Z + _CORNERS[:, 2]).to(dev)
    ok = torch.ones_like(cell, dtype=torch.bool)
    for off in corner_off:
        ok &= ~torch.isnan(flat[cell + off])
    cell = cell[ok]
    inside = torch.stack([flat[cell + off] < level for off in corner_off],
                         1)                                  # [C, 8]

    edge_a, edge_b = [], []     # per triangle: its 3 edges' end corners
    for tet in _TETS:
        case = (inside[:, torch.from_numpy(tet).to(dev)].to(torch.int64)
                * torch.tensor([1, 2, 4, 8], device=dev)).sum(1)
        tgid = cell[:, None] + corner_off[torch.from_numpy(tet).to(dev)]               # [C, 4]
        for cnum in range(1, 15):
            rows = torch.nonzero(case == cnum)[:, 0]
            if rows.numel() == 0:
                continue
            for tri in _CASES[cnum]:
                edge_a.append(tgid[rows][:, [i for i, _ in tri]])
                edge_b.append(tgid[rows][:, [j for _, j in tri]])

    if not edge_a:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    ea, eb = torch.cat(edge_a), torch.cat(edge_b)            # [F, 3]
    keys = torch.minimum(ea, eb) * n_vox + torch.maximum(ea, eb)
    uniq, inv = torch.unique(keys.reshape(-1), sorted=True,
                             return_inverse=True)
    faces = inv.reshape(-1, 3)

    # the vertex of each edge, interpolated at the level
    ulo, uhi = uniq // n_vox, uniq % n_vox

    def unflat(g):
        return torch.stack([g // (Z * Y), (g // Z) % Y, g % Z], -1)

    plo = unflat(ulo).to(torch.float32)
    phi = unflat(uhi).to(torch.float32)
    vlo, vhi = flat[ulo], flat[uhi]
    diff = vhi - vlo
    t = (level - vlo) / torch.where(torch.abs(diff) > 1e-12, diff,
                                    torch.ones_like(diff))
    t = torch.clamp(t, 0.0, 1.0)[:, None]
    verts = plo + t * (phi - plo)

    # drop degenerate faces (repeated vertices)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def save_mesh_ply(path: str, verts, faces):
    """Binary little-endian PLY of float vertices and triangle faces;
    `verts` and `faces` are tensors (on any device) or arrays."""
    verts = np.asarray(torch.as_tensor(verts).cpu())
    faces = np.asarray(torch.as_tensor(faces).cpu())
    with open(path, "wb") as f:
        head = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
        f.write(head.encode())
        f.write(verts.astype("<f4").tobytes())
        rec = np.empty(len(faces),
                       dtype=[("n", "u1"), ("v", "<i4", (3,))])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())
