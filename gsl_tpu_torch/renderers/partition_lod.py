"""Partition level-of-detail renderer: a city-scale scene served from
per-partition models at several levels of detail.

Port of ``gsl_tpu/renderers/partition_lod.py``:

- each frame, each partition's level is chosen by the 2D distance from the
  camera centre to the partition's box in the reoriented ground plane
  (level i where the distance is below ``lod_distances[i] *
  partition_size``, finest first; past the last threshold the coarsest);
- with ``visibility_filter``, a partition whose box (from its finest
  level's means) misses the camera's frustum is left out, the closest one
  never. The test is a separating-axis test of two convex polytopes in
  numpy on the host, exact for the boolean the upstream renderer takes
  from its intersection volume;
- the visible partitions' rows at their levels are joined and rendered
  through `TileRenderer` (K1 + K2). A level a partition lacks falls back
  to the next coarser that it has, then the next finer.

Each level's rows stay on the device as loaded; a change of selection
joins them with one `torch.cat` a property on the device, and a frame
whose (levels, visibility) repeats the last one's renders the same joined
state. gsl_tpu instead joins on the host and pads to a fixed capacity
with an alive mask, so one jitted render serves every selection; the
port's renderers take any row count. `capacity` stays a field: an
assembly larger than it raises.

As in gsl_tpu, every alive row of a partition's level is assembled, also
the rows that lie outside its cell.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.gaussian import PARAM_FIELDS, GaussianParams, GaussianState
from ..utils.device import resolve_device
from ..utils.partitioning import PartitionedScene, _project_xy
from .tile_renderer import TileRendererConfig


def _polytope_axes(corners: np.ndarray):
    """Face normals and edge directions of an 8-corner box-like convex
    polytope (the unit box's corner order)."""
    e0 = corners[1] - corners[0]
    e1 = corners[3] - corners[0]
    e2 = corners[4] - corners[0]
    edges = np.stack([e0, e1, e2])
    normals = np.stack([np.cross(e0, e1), np.cross(e0, e2),
                        np.cross(e1, e2)])
    return normals, edges


def convex_boxes_intersect(corners_a: np.ndarray,
                           corners_b: np.ndarray) -> np.ndarray:
    """Separating-axis test of polytope A [8, 3] against N boxes [N, 8, 3]
    -> [N] bool. A separating axis of two convex polytopes is a face
    normal of one of them or a cross product of an edge of each."""
    na, ea = _polytope_axes(corners_a)
    n = corners_b.shape[0]
    nb_eb = [_polytope_axes(corners_b[i]) for i in range(n)]
    nb = np.stack([x[0] for x in nb_eb])                     # [N, 3, 3]
    eb = np.stack([x[1] for x in nb_eb])                     # [N, 3, 3]
    cross = np.cross(ea[None, :, None, :], eb[:, None, :, :]
                     ).reshape(n, -1, 3)                     # [N, 9, 3]
    axes = np.concatenate([np.broadcast_to(na[None], (n, 3, 3)), nb, cross],
                          axis=1)                            # [N, 15, 3]
    norms = np.linalg.norm(axes, axis=-1, keepdims=True)
    axes = np.where(norms > 1e-9, axes / np.maximum(norms, 1e-9), 0.0)
    pa = np.einsum("nkd,cd->nkc", axes, corners_a)           # [N, 15, 8]
    pb = np.einsum("nkd,ncd->nkc", axes, corners_b)
    sep = ((pa.max(-1) < pb.min(-1) - 1e-9)
           | (pb.max(-1) < pa.min(-1) - 1e-9))               # [N, 15]
    live = np.linalg.norm(axes, axis=-1) > 1e-9
    return ~np.any(sep & live, axis=1)


@dataclasses.dataclass
class PartitionLoDConfig:
    data: str = ""
    """directory holding partitions.npz and one subdirectory per level"""
    names: Sequence[str] = ()
    """the levels' subdirectories, FINEST first; each holds a
    partition_%03d run (checkpoint or PLY) per partition"""
    lod_distances: Sequence[float] = ()
    """len(names) - 1 multiples of partition_size: a partition closer than
    lod_distances[i] * size renders at level i"""
    visibility_filter: bool = False
    renderer: TileRendererConfig = dataclasses.field(
        default_factory=TileRendererConfig)
    capacity: Optional[int] = None
    """the most rows an assembly may hold; by default the finest level's
    total rounded up to a multiple of 1024, as in gsl_tpu"""

    def instantiate(self) -> "PartitionLoDRenderer":
        return PartitionLoDRenderer(self)


class PartitionLoDRenderer:
    def __init__(self, config: PartitionLoDConfig):
        self.config = config
        self.renderer = config.renderer.instantiate()
        self._loaded = False
        self._cached_key = None
        self._cached_state = None
        self._n_gaussians = 0

    # ---- loading ----
    def setup(self, device=None) -> "PartitionLoDRenderer":
        """Load every level of every partition onto `device` (default
        cuda)."""
        from ..utils.gaussian_model_loader import GaussianModelLoader

        cfg = self.config
        dev = resolve_device(device)
        scene = PartitionedScene.load(os.path.join(cfg.data,
                                                   "partitions.npz"))
        self.scene = scene
        self.rotation = np.asarray(scene.rotation, np.float32)
        self.partition_size = float(scene.config.partition_size)

        # lods[level][pi]: {property: [n, ...] alive rows on dev} or None
        self.lods: List[List[Optional[dict]]] = []
        self.sh_degree = 3
        for name in cfg.names:
            level = []
            for pi in range(len(scene.partitions)):
                run = os.path.join(cfg.data, name, f"partition_{pi:03d}")
                try:
                    state, _, shd = GaussianModelLoader.load(run, dev)
                except FileNotFoundError:
                    level.append(None)
                    continue
                self.sh_degree = shd
                level.append({k: getattr(state.params, k)[state.alive]
                              for k in PARAM_FIELDS})
            self.lods.append(level)
        kept = [pi for pi in range(len(scene.partitions))
                if self.lods[0][pi] is not None]
        if not kept:
            raise FileNotFoundError(
                f"no trained partitions found under {cfg.data}")
        self.partition_idx = np.asarray(kept)
        self.bbox_min = np.stack(
            [scene.partitions[pi].xy_min for pi in kept]).astype(np.float32)
        self.bbox_max = np.stack(
            [scene.partitions[pi].xy_max for pi in kept]).astype(np.float32)
        # each partition's 3D bounds, from its finest level's means, for
        # the frustum test
        corners = []
        for pi in kept:
            m = self.lods[0][pi]["means"]
            lo = m.min(0).values.cpu().numpy()
            hi = m.max(0).values.cpu().numpy()
            corners.append(np.array(
                [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                 [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                 [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                 [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], np.float32))
        self.box_corners = np.stack(corners)      # [P, 8, 3]

        self.capacity = cfg.capacity
        if self.capacity is None:
            total = sum(self.lods[0][pi]["means"].shape[0] for pi in kept)
            self.capacity = max(-(-total // 1024) * 1024, 1024)
        self.thresholds = np.asarray(
            [d * self.partition_size for d in cfg.lod_distances], np.float32)
        self._loaded = True
        return self

    # ---- selection ----
    def partition_distances(self, camera_center: np.ndarray) -> np.ndarray:
        """2D distance from the camera centre to each partition's box in
        the reoriented ground plane."""
        p = _project_xy(np.asarray(camera_center, np.float32)[None],
                        self.rotation, self.scene.up_axis)[0]
        d = np.maximum(self.bbox_min - p, p - self.bbox_max)
        return np.sqrt((np.maximum(d, 0.0) ** 2).sum(-1))

    def select(self, camera):
        """-> (level [P] int32, visible [P] bool) of the loaded
        partitions for `camera`."""
        dist = self.partition_distances(
            camera.camera_center.detach().cpu().numpy())
        n_lod = len(self.lods)
        lods = np.full(dist.shape, n_lod - 1, np.int32)
        for i in range(n_lod - 2, -1, -1):
            lods[dist < self.thresholds[i]] = i

        visible = np.ones(dist.shape, bool)
        if self.config.visibility_filter:
            visible = self._frustum_visibility(camera, dist)
            visible[int(np.argmin(dist))] = True  # the closest always
        return lods, visible

    def _frustum_visibility(self, camera, dist):
        W = int(camera.width)
        H = int(camera.height)
        K = np.array([[float(camera.fx), 0, float(camera.cx)],
                      [0, float(camera.fy), float(camera.cy)],
                      [0, 0, 1]], np.float32)
        px = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]],
                      np.float32)
        rays = px @ np.linalg.inv(K).T
        far = 10.0 * max(float(dist.max()), self.partition_size)
        frustum = np.concatenate([rays * 0.1, rays * far], axis=0)
        w2c = camera.world_to_camera.detach().cpu().numpy().astype(
            np.float32)
        boxes_cam = self.box_corners @ w2c[:3, :3].T + w2c[:3, 3]
        return convex_boxes_intersect(frustum, boxes_cam)

    # ---- assembly ----
    def level_rows(self, j: int, level: int) -> Optional[dict]:
        """The rows loaded partition j renders at `level`: that level's,
        else the next coarser level it has, else the next finer."""
        pi = self.partition_idx[j]
        level = min(int(level), len(self.lods) - 1)
        for lv in [level] + list(range(level + 1, len(self.lods))) \
                + list(range(level - 1, -1, -1)):
            if self.lods[lv][pi] is not None:
                return self.lods[lv][pi]
        return None

    def _assemble(self, lods, visible):
        parts = [self.level_rows(j, lods[j])
                 for j in range(len(self.partition_idx)) if visible[j]]
        parts = [p for p in parts if p is not None]
        n = sum(p["means"].shape[0] for p in parts)
        if n > self.capacity:
            raise ValueError(
                f"assembly overflow: {n} gaussians > capacity "
                f"{self.capacity}; raise PartitionLoDConfig.capacity")
        params = GaussianParams(**{
            k: torch.cat([p[k] for p in parts], dim=0) for k in PARAM_FIELDS})
        alive = torch.ones(n, dtype=torch.bool, device=params.means.device)
        return GaussianState(params=params, alive=alive), n

    # ---- render ----
    def forward(self, camera, img_height, img_width, bg_color,
                render_types=frozenset({"rgb"})):
        """-> (render outputs, {"n_gaussians", "partition_lods",
        "visible"})."""
        assert self._loaded, "call setup() first"
        lods, visible = self.select(camera)
        key = (tuple(lods.tolist()), tuple(visible.tolist()))
        if key != self._cached_key:
            self._cached_state = None     # free the last assembly first
            self._cached_state, self._n_gaussians = self._assemble(
                lods, visible)
            self._cached_key = key
        out = self.renderer.forward(
            self._cached_state, camera, img_height, img_width, bg_color,
            self.sh_degree, render_types=render_types)
        return out, {"n_gaussians": self._n_gaussians,
                     "partition_lods": lods, "visible": visible}
