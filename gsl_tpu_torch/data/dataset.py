"""Image loading and the in-RAM cached data loader.

Port of ``gsl_tpu/data/dataset.py``: images are decoded once, quantised
to uint8 as the JAX package does (``(img * 255 + 0.5).astype(uint8)``) and
cached on the host; the loader yields (camera, name, image, mask) with
per-epoch shuffling from ``RandomState(seed)``, a ``skip`` that
fast-forwards the index stream on resume, and a one-element lookahead
thread. The image comes out as the cached uint8 tensor: the fit loop
uploads it and converts it on the device (`image_to_float`), so one step
moves a quarter of the bytes a float32 image would. An image set with
estimated depth (``extra_data["depth"]``) also serves each image's scaled
inverse-depth map by name (`get_depth`), cached as float32.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .cameras import Cameras
from .dataparsers.dataparser import ImageSet, PointCloud
from .dataparsers.estimated_depth_colmap import load_depth


def load_image(path: str, background: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """Decode to float32 HWC in [0,1]; RGBA alpha-blended onto background
    (black when None)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:4]
        bg = background if background is not None else np.zeros(3, np.float32)
        arr = rgb * a + bg[None, None, :] * (1.0 - a)
    return arr[..., :3]


def image_to_float(img_u8: torch.Tensor) -> torch.Tensor:
    """Cached uint8 HWC -> float32 in [0, 1], the JAX package's values."""
    return img_u8.to(torch.float32) / 255.0


def _undistort(img: np.ndarray, K: np.ndarray, dist: np.ndarray, path: str
               ) -> np.ndarray:
    """Undistort with OpenCV; OPENCV_FISHEYE (dist[4] != 0) takes the
    equidistant model, the rest the radial-tangential one."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path} has lens distortion {dist[:4].tolist()} and OpenCV "
            "(cv2) is not installed to undistort it") from e
    u8 = (img * 255).astype(np.uint8)
    if dist.shape[0] >= 5 and dist[4] != 0:
        out = cv2.fisheye.undistortImage(
            u8, K, np.array(dist[0:4], np.float64), Knew=K)
    else:
        out = cv2.undistort(u8, K, np.array([dist[0], dist[1], dist[2],
                                             dist[3]]))
    return out.astype(np.float32) / 255.0


class CachedDataset:
    """uint8 in-RAM cache of an ImageSet."""

    def __init__(self, image_set: ImageSet,
                 background: Optional[np.ndarray] = None):
        self.image_set = image_set
        self.background = background
        self._cache = {}
        self._mask_cache = {}
        self._depth_cache = {}
        self._index = {n: i for i, n in enumerate(image_set.image_names)}

    def __len__(self):
        return len(self.image_set)

    def _distortion(self, i: int):
        extra = self.image_set.extra_data or {}
        d = extra.get("distortion")
        if d is None or d[i] is None:
            return None
        d = np.asarray(d[i])
        return d if np.any(d != 0) else None

    def get_mask(self, i: int) -> Optional[np.ndarray]:
        """Per-image mask [H, W] float32, 1 = keep, 0 = masked out (nonzero
        mask pixels are kept)."""
        paths = self.image_set.mask_paths
        if paths is None or paths[i] is None:
            return None
        if i not in self._mask_cache:
            from PIL import Image

            with Image.open(paths[i]) as im:
                m = np.asarray(im)
            if m.ndim == 3:
                m = m[..., 0]
            self._mask_cache[i] = (m != 0)
        return self._mask_cache[i].astype(np.float32)

    def get_uint8(self, i: int) -> np.ndarray:
        """The cached uint8 HWC image, decoded (and undistorted) on first
        use."""
        if i not in self._cache:
            path = self.image_set.image_paths[i]
            img = load_image(path, self.background)
            dist = self._distortion(i)
            if dist is not None:
                K = self.image_set.cameras[i].get_K().numpy().astype(
                    np.float64)
                img = _undistort(img, K, dist, path)
            self._cache[i] = (img * 255.0 + 0.5).astype(np.uint8)
        return self._cache[i]

    def get_depth(self, name: str, image_hw: Tuple[int, int]
                  ) -> Optional[torch.Tensor]:
        """The scaled inverse-depth map [H, W] float32 (on the host) of the
        image `name`, whose size is `image_hw`; None where the parser gave
        it no map. A map of another size raises, naming its file."""
        if name not in self._depth_cache:
            entries = (self.image_set.extra_data or {}).get("depth")
            entry = None if entries is None else entries[self._index[name]]
            d = load_depth(entry)
            if d is not None:
                if d.shape != tuple(image_hw):
                    raise ValueError(
                        f"{entry['path']}: depth map of shape {d.shape} "
                        f"for the {image_hw[0]}x{image_hw[1]} image {name}")
                d = torch.from_numpy(d)
            self._depth_cache[name] = d
        return self._depth_cache[name]

    def get(self, i: int) -> Tuple[Cameras, str, torch.Tensor,
                                   Optional[torch.Tensor]]:
        """-> (camera on the CPU, name, uint8 [H, W, 3], mask [H, W] float32
        or None). A mask of another resolution is nearest-resized to the
        image's."""
        img = self.get_uint8(i)
        mask = self.get_mask(i)
        if mask is not None and mask.shape[:2] != img.shape[:2]:
            ys = (np.arange(img.shape[0]) * mask.shape[0]
                  // img.shape[0]).clip(0, mask.shape[0] - 1)
            xs = (np.arange(img.shape[1]) * mask.shape[1]
                  // img.shape[1]).clip(0, mask.shape[1] - 1)
            mask = mask[np.ix_(ys, xs)]
        return (self.image_set.cameras[i], self.image_set.image_names[i],
                torch.from_numpy(img),
                None if mask is None else torch.from_numpy(mask))


class DataLoader:
    """Infinite shuffled iterator, with a one-image lookahead thread when
    `async_prefetch`. An error the thread meets reading an image is raised
    from `next`. With `world_size` > 1 the loader of `rank` draws from the
    images ``rank::world_size`` only, from ``RandomState(seed + rank)``
    (gsl_tpu's per-rank slices); `shuffle` False walks them in order.
    `skip` fast-forwards the index stream (training resume). `shuffle`,
    `async_prefetch`, `rank` and `world_size` are gsl_tpu's options, kept
    for API parity with its loader: the port's fits pass `seed` and `skip`
    only (the distributed fit's ranks read their own images)."""

    def __init__(self, dataset: CachedDataset, shuffle: bool = True,
                 seed: int = 0, async_prefetch: bool = True, rank: int = 0,
                 world_size: int = 1, skip: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed + rank)
        self.rank = rank
        self.world_size = world_size
        self.async_prefetch = async_prefetch
        self.skip = skip

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.world_size > 1:
            idx = idx[self.rank::self.world_size]
        while True:
            yield from (self.rng.permutation(idx) if self.shuffle else idx)

    def __iter__(self) -> Iterator[Tuple[Cameras, str, torch.Tensor,
                                         Optional[torch.Tensor]]]:
        gen = self._indices()
        for _ in range(self.skip):
            next(gen)
        if not self.async_prefetch:
            for i in gen:
                yield self.dataset.get(int(i))
            return

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def worker():
            for i in gen:
                try:
                    item = (self.dataset.get(int(i)), None)
                except BaseException as e:  # raised again from next()
                    item = (None, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if stop.is_set() or item[1] is not None:
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item, error = q.get()
                if error is not None:
                    raise error
                yield item
        finally:
            stop.set()
            t.join()


def add_background_sphere(point_cloud: PointCloud, camera_centers: np.ndarray,
                          distance: float = 2.2, n_points: int = 204_800,
                          seed: int = 7) -> PointCloud:
    """Append a sphere of random points around the scene so the sky /
    background has Gaussians to use."""
    center = camera_centers.mean(axis=0)
    radius = float(np.linalg.norm(camera_centers - center, axis=-1).max())
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n_points, 3))
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    xyz = center + d * radius * distance
    rgb = rng.uniform(0.0, 1.0, size=(n_points, 3)).astype(np.float32)
    return PointCloud(
        xyz=np.concatenate([point_cloud.xyz, xyz.astype(np.float32)]),
        rgb=np.concatenate([point_cloud.rgb, rgb]))
