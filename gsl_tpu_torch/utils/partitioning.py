"""City-scale scene partitioning (numpy, on the host).

A copy of ``gsl_tpu/utils/partitioning.py``, which the port never
imports: grid the scene by camera centres, assign cameras to each cell by
location (its box enlarged) and by visibility of the cell's sparse points,
and keep the layout in ``partitions.npz``, which the partition tools, the
partition store and the LoD renderer read. The file holds the same keys
as the JAX package's, so either package reads the other's, plus
``up_axis``, which ``gsl_tpu``'s ``save`` leaves out and its ``load``
ignores (it rebuilds the axis as 1); this ``load`` reads it and falls
back to 1 without it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SceneConfig:
    origin: np.ndarray = None               # [2] xz-plane origin
    partition_size: float = -1.0            # auto if <= 0
    location_based_enlarge: float = 0.1     # x partition_size
    visibility_based_distance: float = 0.9  # x partition_size
    visibility_threshold: float = 1.0 / 6.0
    visibility_mode: str = "points"
    """'points': fraction of the cell's sparse points inside the camera
    frustum (reference cameras_point_based_visibilities);
    'convex_hull': projected-hull area over image area (reference
    partitioning_utils.py:740-868 convex-hull variant — with a hull
    threshold like the reference's 1/9 in mind, set visibility_threshold
    accordingly)."""


@dataclasses.dataclass
class Partition:
    ij: np.ndarray            # [2] int grid coords
    xy_min: np.ndarray        # [2]
    xy_max: np.ndarray        # [2]
    camera_mask: np.ndarray   # [M] bool (assigned training cameras)


@dataclasses.dataclass
class PartitionedScene:
    config: SceneConfig
    partitions: list
    rotation: np.ndarray      # [3, 3] world reorientation (identity default)
    up_axis: int = 1

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(
            path,
            partition_size=self.config.partition_size,
            origin=self.config.origin,
            rotation=self.rotation,
            ijs=np.stack([p.ij for p in self.partitions]),
            xy_mins=np.stack([p.xy_min for p in self.partitions]),
            xy_maxs=np.stack([p.xy_max for p in self.partitions]),
            camera_masks=np.stack([p.camera_mask for p in self.partitions]),
            up_axis=self.up_axis,
        )

    @classmethod
    def load(cls, path: str) -> "PartitionedScene":
        d = np.load(path)
        cfg = SceneConfig(origin=d["origin"],
                          partition_size=float(d["partition_size"]))
        parts = [
            Partition(ij=d["ijs"][i], xy_min=d["xy_mins"][i],
                      xy_max=d["xy_maxs"][i],
                      camera_mask=d["camera_masks"][i])
            for i in range(d["ijs"].shape[0])
        ]
        up_axis = int(d["up_axis"]) if "up_axis" in d.files else 1
        return cls(config=cfg, partitions=parts, rotation=d["rotation"],
                   up_axis=up_axis)


def _project_xy(points3d: np.ndarray, rotation: np.ndarray,
                up_axis: int = 1) -> np.ndarray:
    """world -> reoriented ground-plane coords (drop the up axis)."""
    p = points3d @ rotation.T
    keep = [i for i in range(3) if i != up_axis]
    return p[:, keep]


def _clip_polygon(poly: np.ndarray, W: float, H: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon [K, 2] to
    [0, W] x [0, H]."""
    def clip_edge(pts, inside, intersect):
        out = []
        k = len(pts)
        for i in range(k):
            cur, nxt = pts[i], pts[(i + 1) % k]
            ci, ni = inside(cur), inside(nxt)
            if ci:
                out.append(cur)
                if not ni:
                    out.append(intersect(cur, nxt))
            elif ni:
                out.append(intersect(cur, nxt))
        return np.asarray(out) if out else np.zeros((0, 2))

    def x_cut(c, n, x0):
        t = (x0 - c[0]) / (n[0] - c[0])
        return np.array([x0, c[1] + t * (n[1] - c[1])])

    def y_cut(c, n, y0):
        t = (y0 - c[1]) / (n[1] - c[1])
        return np.array([c[0] + t * (n[0] - c[0]), y0])

    for inside, intersect in (
            (lambda p: p[0] >= 0, lambda c, n: x_cut(c, n, 0.0)),
            (lambda p: p[0] <= W, lambda c, n: x_cut(c, n, W)),
            (lambda p: p[1] >= 0, lambda c, n: y_cut(c, n, 0.0)),
            (lambda p: p[1] <= H, lambda c, n: y_cut(c, n, H))):
        poly = clip_edge(poly, inside, intersect)
        if len(poly) == 0:
            return poly
    return poly


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def _hull_visibility(u: np.ndarray, v: np.ndarray, W: int, H: int) -> float:
    """Convex-hull visibility (reference partitioning_utils.py convex-hull
    variant): area of (hull of projected points) clipped to the image,
    over the image area."""
    from scipy.spatial import ConvexHull, QhullError
    pts = np.stack([u, v], axis=-1)
    if len(pts) < 3:
        return 0.0
    try:
        hull = ConvexHull(pts)
    except QhullError:
        return 0.0
    poly = pts[hull.vertices]
    clipped = _clip_polygon(poly, float(W), float(H))
    return _poly_area(clipped) / float(W * H)


def build_partitions(
    camera_centers: np.ndarray,       # [M, 3]
    points: Optional[np.ndarray] = None,   # [N, 3] sparse points
    config: Optional[SceneConfig] = None,
    rotation: Optional[np.ndarray] = None,
    n_partitions_hint: int = 4,
    up_axis: int = 1,
    cameras=None,                     # optional Cameras batch (len M)
) -> PartitionedScene:
    """Grid by camera centers; assign cameras by enlarged-bbox location
    plus visibility. With full `cameras`, visibility is the reference's
    point-projection test (partitioning_utils.py:740-868): a camera joins
    a cell when >= visibility_threshold of the cell's sparse points
    project inside its image; otherwise a center-distance proxy. As in
    gsl_tpu, the derived `partition_size` and `origin` are written into
    the caller's `config`."""
    config = config or SceneConfig()
    rotation = rotation if rotation is not None else np.eye(3)
    xy = _project_xy(camera_centers, rotation, up_axis)

    lo, hi = xy.min(0), xy.max(0)
    if config.partition_size <= 0:
        # span-based sizing (area-based collapses for flat/linear layouts)
        span = float(np.max(hi - lo))
        per_axis = int(np.ceil(np.sqrt(max(n_partitions_hint, 1))))
        config.partition_size = max(span / max(per_axis, 1), 1e-6) + 1e-6
    size = config.partition_size
    if config.origin is None:
        config.origin = (lo + hi) / 2.0

    ij = np.floor((xy - config.origin) / size).astype(np.int64)
    unique_ij = np.unique(ij, axis=0)

    partitions = []
    enlarge = config.location_based_enlarge * size
    vis_dist = config.visibility_based_distance * size
    pts_xy = (_project_xy(points, rotation, up_axis)
              if points is not None else None)
    for cell in unique_ij:
        xy_min = config.origin + cell * size
        xy_max = xy_min + size
        in_box = np.all(
            (xy >= xy_min - enlarge) & (xy < xy_max + enlarge), axis=1)
        mask = in_box
        if pts_xy is not None:
            cell_pts = np.all((pts_xy >= xy_min) & (pts_xy < xy_max),
                              axis=1)
            if cell_pts.sum() > 0:
                if cameras is not None:
                    # point-projection visibility: fraction of the cell's
                    # points inside each camera's frustum
                    # (reference cameras_point_based_visibilities)
                    pts3d = points[cell_pts]
                    # only consider cameras within the visibility range
                    center = (xy_min + xy_max) / 2.0
                    near = np.linalg.norm(xy - center, axis=1) <= (
                        size / 2.0 + vis_dist)
                    vis_frac = np.zeros(xy.shape[0])
                    for m in np.nonzero(near)[0]:
                        cam = cameras[int(m)]
                        R = np.asarray(cam.R, np.float64)
                        T = np.asarray(cam.T, np.float64)
                        p_cam = pts3d @ R.T + T
                        z = p_cam[:, 2]
                        ok = z > 1e-3
                        if ok.sum() == 0:
                            continue
                        u = (float(cam.fx) * p_cam[ok, 0] / z[ok]
                             + float(cam.cx))
                        v = (float(cam.fy) * p_cam[ok, 1] / z[ok]
                             + float(cam.cy))
                        if config.visibility_mode == "convex_hull":
                            vis_frac[m] = _hull_visibility(
                                u, v, int(cam.width), int(cam.height))
                        else:
                            inb = ((u >= 0) & (u < int(cam.width))
                                   & (v >= 0) & (v < int(cam.height)))
                            vis_frac[m] = inb.sum() / pts3d.shape[0]
                    mask = mask | (vis_frac >= config.visibility_threshold)
                else:
                    # center-distance proxy (no intrinsics available)
                    center = (xy_min + xy_max) / 2.0
                    near = np.linalg.norm(xy - center, axis=1) <= (
                        size / 2.0 + vis_dist)
                    mask = mask | near
        partitions.append(Partition(ij=cell, xy_min=xy_min, xy_max=xy_max,
                                    camera_mask=mask))
    return PartitionedScene(config=config, partitions=partitions,
                            rotation=rotation, up_axis=up_axis)


def gaussians_in_partition(means: np.ndarray, partition: Partition,
                           rotation: np.ndarray, up_axis: int = 1,
                           margin: float = 0.0) -> np.ndarray:
    """Ownership mask for merging: gaussian centers inside the cell
    (reference merge_partitions_v2 semantics)."""
    xy = _project_xy(means, rotation, up_axis)
    return np.all((xy >= partition.xy_min - margin)
                  & (xy < partition.xy_max + margin), axis=1)


def auto_hyper_parameter(n_images: int, base: int = 300,
                         scale_mode: str = "linear",
                         max_steps: int = 30_000):
    """Scale-up of the densify/reset/step schedule by image count
    (reference utils/auto_hyper_parameter.py:30-60)."""
    import math

    if scale_mode == "linear":
        scale_up = max(n_images / base, 1.0)
    elif scale_mode == "sqrt":
        scale_up = max(math.sqrt(n_images / base), 1.0)
    else:
        scale_up = 1.0
    scale_up = math.ceil(scale_up * 100) / 100.0
    return {
        "max_steps": round(max_steps * scale_up),
        "means_lr_max_steps": round(max_steps * scale_up),
        "densification_interval": round(100 * scale_up),
        "opacity_reset_interval": round(3000 * scale_up),
        "densify_from_iter": round(500 * scale_up),
        "densify_until_iter": round(15000 * scale_up),
    }, scale_up
