"""COLMAP sparse model reader (bin + txt) and binary writer.

Port of ``gsl_tpu/data/colmap_io.py`` (numpy only). ``points3D.bin`` is
read by the C++ reader of ``gsl_tpu_torch/native`` (built on first use);
`read_points3d_bin_plain`, the Python loop, is its plain version.

Supported camera models: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL,
OPENCV, OPENCV_FISHEYE (params retained; undistortion handled downstream).
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return self.params[0]
        return self.params[1]

    @property
    def cx(self):
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return self.params[1]
        return self.params[2]

    @property
    def cy(self):
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return self.params[2]
        return self.params[3]

    @property
    def distortion(self) -> np.ndarray:
        """[k1, k2, p1, p2, fisheye_flag] (zeros if pinhole).

        OPENCV_FISHEYE's params are the equidistant coefficients
        [k1, k2, k3, k4] — NOT radial-tangential — so they are tagged with
        fisheye_flag=1 and undistorted downstream with
        cv2.fisheye.undistortImage. The remaining fisheye models have no
        OpenCV undistortion path and raise."""
        if self.model in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
                          "THIN_PRISM_FISHEYE", "FOV"):
            raise NotImplementedError(
                f"camera model {self.model} is not supported (no "
                "undistortion path); re-run COLMAP with a perspective or "
                "OPENCV_FISHEYE model")
        d = np.zeros(5)
        if self.model == "SIMPLE_RADIAL":
            d[0] = self.params[3]
        elif self.model == "RADIAL":
            d[0:2] = self.params[3:5]
        elif self.model == "OPENCV":
            d[0:4] = self.params[4:8]
        elif self.model == "OPENCV_FISHEYE":
            d[0:4] = self.params[4:8]   # equidistant k1..k4
            d[4] = 1.0
        return d


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str


@dataclasses.dataclass
class ColmapModel:
    cameras: Dict[int, ColmapCamera]
    images: Dict[int, ColmapImage]
    points_xyz: np.ndarray   # [N, 3] float64
    points_rgb: np.ndarray   # [N, 3] uint8
    points_err: np.ndarray   # [N]


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (stable branch selection)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
         R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


# ---------------- binary readers ----------------

def _read(fmt, f):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, w, h = _read("<iiQQ", f)
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{n_params}d", f))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            image_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            camera_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read("<Q", f)
            f.seek(n_pts * 24, os.SEEK_CUR)  # skip 2D points (x, y, id3d)
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                        name.decode("utf-8"))
    return out


def read_points3d_bin(path: str):
    """points3D.bin -> (xyz [n, 3] float64, rgb [n, 3] uint8, err [n]
    float64), by the native reader; raises if it cannot be built."""
    from ..native import read_points3d_native
    return read_points3d_native(path)


def read_points3d_bin_plain(path: str):
    """The same arrays as `read_points3d_bin`, read in Python."""
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        for i in range(n):
            _read("<q", f)  # point id
            xyz[i] = _read("<3d", f)
            rgb[i] = _read("<3B", f)
            err[i] = _read("<d", f)[0]
            (track_len,) = _read("<Q", f)
            f.seek(track_len * 8, os.SEEK_CUR)
    return xyz, rgb, err


# ---------------- text readers ----------------

def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            out[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(x) for x in parts[4:]]))
    return out


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        out[image_id] = ColmapImage(image_id, qvec, tvec, int(parts[8]),
                                    parts[9])
    return out


def read_points3d_txt(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(x) for x in parts[1:4]])
            rgb.append([int(x) for x in parts[4:7]])
            err.append(float(parts[7]))
    return (np.array(xyz, np.float64), np.array(rgb, np.uint8),
            np.array(err, np.float64))


def read_model(sparse_dir: str) -> ColmapModel:
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        xyz, rgb, err = read_points3d_bin(
            os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        xyz, rgb, err = read_points3d_txt(
            os.path.join(sparse_dir, "points3D.txt"))
    return ColmapModel(cams, imgs, xyz, rgb, err)


# ---------------- binary writers (for tests / tooling) ----------------

def write_model_bin(model: ColmapModel, sparse_dir: str):
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(model.cameras)))
        for cam in model.cameras.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid, cam.width,
                                cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(model.images)))
        for im in model.images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        n = model.points_xyz.shape[0]
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<q", i))
            f.write(struct.pack("<3d", *model.points_xyz[i]))
            f.write(struct.pack("<3B", *model.points_rgb[i]))
            f.write(struct.pack("<d", float(model.points_err[i])))
            f.write(struct.pack("<Q", 0))
