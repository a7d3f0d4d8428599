"""The benchmark's inputs: a scene of clustered Gaussians, an orbit rig,
training targets and viewer poses, all drawn on the device from a seed.

The scene is a frozen copy of the quality protocol's teacher
(``gsl_tpu_torch/tools/quality_benchmark.py::make_teacher``: blobs of
sigma 0.15, log scales in [-6.5, -4], normal quaternions, SH-3 colours,
logit opacities in [-2, 2]) drawn with a ``torch.Generator`` on the card
at the configuration's published count. As the count grows the layout
gains blobs, not density: 60 blobs and a box of half-side 1.5 per
million rows, the box's side growing with the cube root of the count.
The blob centres come from the configuration's fixed `layout_seed`, so
every run seed lays out the same scene and differs in its Gaussians: a
seed changes the draws, not the amount of work.

The rig is a frozen copy of ``orbit_cameras``: views evenly spaced in yaw
and jittered, pitched down 0.05-0.55 rad, looking at the origin from the
box's scaled radius, fx = fy = `focal_factor` x width. It too comes from
a fixed seed in the configuration.
"""
from __future__ import annotations

import numpy as np
import torch

K_SH = 16   # SH degree 3


def derived_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for each stream of draws of one run."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, stream))
    return g


def scale_of(cfg: dict) -> float:
    """The layout's linear scale: the cube root of millions of rows."""
    return (cfg["n_gaussians"] / 1e6) ** (1.0 / 3.0)


def draw_scene(cfg: dict, seed: int, device) -> dict:
    """Raw parameters of `cfg["n_gaussians"]` Gaussians, float32 on
    `device`, in a few large draws."""
    sc = cfg["scene"]
    n = cfg["n_gaussians"]
    s = scale_of(cfg)
    n_blobs = max(1, round(sc["blobs_per_million"] * n / 1e6))
    layout = torch.Generator(device=device)
    layout.manual_seed(sc["layout_seed"])
    half = sc["box_half_per_million"] * s
    centres = (torch.rand((n_blobs, 3), generator=layout, device=device)
               * 2.0 - 1.0) * half
    g = generator(seed, 0, device)
    which = torch.randint(0, n_blobs, (n,), generator=g, device=device)
    means = centres[which] + torch.randn((n, 3), generator=g,
                                         device=device) * sc["blob_sigma"]
    lo, hi = sc["log_scale"]
    scales = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    quats = torch.randn((n, 4), generator=g, device=device)
    shs = torch.randn((n, K_SH, 3), generator=g, device=device)
    shs[:, :1] *= sc["shs_dc_std"]
    shs[:, 1:] *= sc["shs_rest_std"]
    lo, hi = sc["logit_opacity"]
    opac = torch.rand((n, 1), generator=g, device=device) * (hi - lo) + lo
    return dict(means=means, scales=scales, rotations=quats,
                opacities=opac, shs_dc=shs[:, :1].contiguous(),
                shs_rest=shs[:, 1:].contiguous())


def perturb(arrays: dict, stds: dict, seed: int, device) -> dict:
    """The scene moved off its optimum, as a run from a trained state
    meets it: N(0, std) added to the named properties."""
    g = generator(seed, 1, device)
    out = dict(arrays)
    for k in sorted(stds):
        out[k] = arrays[k] + stds[k] * torch.randn(
            arrays[k].shape, generator=g, device=device)
    return out


def rig(cfg: dict) -> list:
    """The capture's cameras as dicts of numpy arrays: R, T (p_cam = R p +
    T), fx, fy, cx, cy, width, height."""
    r = cfg["rig"]
    W, H, n = cfg["width"], cfg["height"], cfg["views"]
    radius = r["radius_per_million"] * scale_of(cfg)
    rng = np.random.RandomState(r["seed"])
    f = r["focal_factor"] * W
    cams = []
    for i in range(n):
        yaw = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        pitch = rng.uniform(*r["pitch_rad"])
        c = radius * np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch),
                               np.cos(pitch) * np.cos(yaw)])
        fwd = -c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        R = np.stack([right, upv, fwd])
        cams.append(dict(R=R, T=-R @ c, fx=f, fy=f, cx=W / 2, cy=H / 2,
                         width=W, height=H))
    return cams


def train_views(cfg: dict) -> list:
    """Indices of the rig's training views: every `holdout_every`-th view
    is held out, as 3DGS splits Mip-NeRF 360."""
    k = cfg["holdout_every"]
    return [i for i in range(cfg["views"]) if i % k != 0]


def target_draws(cfg: dict, mix: dict, seed: int, n_views: int, device):
    """The low-resolution draws behind every training target,
    [n_views, 3, h, w] uniform in [0, 1]."""
    f = mix["target_downsample"]
    h = -(-cfg["height"] // f)
    w = -(-cfg["width"] // f)
    g = generator(seed, 2, device)
    return torch.rand((n_views, 3, h, w), generator=g, device=device)


def target(draws, i: int, height: int, width: int):
    """View i's target: its draw upsampled bilinearly to the image, as
    uint8 [H, W, 3]."""
    up = torch.nn.functional.interpolate(
        draws[i:i + 1], size=(height, width), mode="bilinear",
        align_corners=False)[0]
    return (up.permute(1, 2, 0) * 255.0 + 0.5).to(torch.uint8)


def viewer_poses(cfg: dict, mix: dict, seed: int) -> list:
    """The viewer's camera-to-world poses (OpenCV, [4, 4] float64): one
    orbit of `stations` evenly spaced yaws around the scene's centre, each
    jittered in yaw, pitch and distance from the seed, in an order the
    seed permutes. Every seed serves the same stations."""
    rng = np.random.RandomState(derived_seed(seed, 3) % (2 ** 32))
    n = mix["stations"]
    radius = cfg["rig"]["radius_per_million"] * scale_of(cfg)
    yaw = (np.arange(n) + rng.uniform(-0.5, 0.5, n)) * 360.0 / n
    lo, hi = mix["pitch_deg"]
    pitch = rng.uniform(lo, hi, n)
    dist = radius * rng.uniform(*mix["distance_factor"], n)
    order = rng.permutation(n)
    return [orbit_c2w(yaw[i], pitch[i], dist[i]) for i in order]


def orbit_c2w(yaw_deg, pitch_deg, dist, target=np.zeros(3)):
    """Orbit camera-to-world [4, 4], +z forward, as the viewer's orbit."""
    yaw, pitch = np.deg2rad(yaw_deg), np.deg2rad(pitch_deg)
    pos = target + dist * np.array([np.sin(yaw) * np.cos(pitch),
                                    -np.sin(pitch),
                                    -np.cos(yaw) * np.cos(pitch)])
    fwd = (target - pos) / np.linalg.norm(target - pos)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
    return c2w


def viewer_camera(c2w, width: int, height: int, fov_y: float) -> dict:
    """The camera the viewer builds for a pose: w2c = inverse(c2w) in
    float64, f = 0.5 H / tan(fov_y / 2), principal point at the centre."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    f = 0.5 * height / np.tan(0.5 * np.deg2rad(fov_y))
    return dict(R=w2c[:3, :3], T=w2c[:3, 3], fx=f, fy=f, cx=width / 2.0,
                cy=height / 2.0, width=width, height=height)
