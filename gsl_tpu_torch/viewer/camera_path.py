"""Orbit cameras and keyframed camera paths (numpy), the two helpers of
``gsl_tpu/viewer/viewer.py`` (``orbit_c2w``) and
``gsl_tpu/viewer/panels.py`` (``CameraPath``) that rendering uses."""
from __future__ import annotations

import io
from typing import List, Tuple

import numpy as np


def orbit_c2w(yaw_deg: float, pitch_deg: float, dist: float,
              target=np.zeros(3)) -> np.ndarray:
    """Orbit camera-to-world [4, 4] (OpenCV convention: +z forward)."""
    yaw = np.deg2rad(yaw_deg)
    pitch = np.deg2rad(pitch_deg)
    pos = target + dist * np.array([
        np.sin(yaw) * np.cos(pitch), -np.sin(pitch),
        -np.cos(yaw) * np.cos(pitch)])
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
    return c2w


class CameraPath:
    """Keyframed orbit path -> interpolated (yaw, pitch, dist) poses -> an
    animated GIF."""

    def __init__(self):
        self.keyframes: List[Tuple[float, float, float]] = []

    def add(self, yaw: float, pitch: float, dist: float):
        self.keyframes.append((float(yaw), float(pitch), float(dist)))

    def clear(self):
        self.keyframes = []

    def interpolate(self, n_frames: int):
        if len(self.keyframes) < 2:
            return list(self.keyframes) * n_frames
        kf = np.asarray(self.keyframes, np.float64)
        t = np.linspace(0, len(kf) - 1, n_frames)
        i0 = np.clip(t.astype(int), 0, len(kf) - 2)
        frac = (t - i0)[:, None]
        return [tuple(v) for v in kf[i0] * (1 - frac) + kf[i0 + 1] * frac]

    def render_gif(self, render_fn, n_frames: int = 60,
                   duration_ms: int = 50) -> bytes:
        """render_fn(yaw, pitch, dist) -> uint8 HWC image."""
        from PIL import Image

        frames = [Image.fromarray(render_fn(*pose))
                  for pose in self.interpolate(n_frames)]
        buf = io.BytesIO()
        frames[0].save(buf, "GIF", save_all=True,
                       append_images=frames[1:], duration=duration_ms,
                       loop=0)
        return buf.getvalue()
