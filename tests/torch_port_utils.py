"""Helpers for the tests that hold gsl_tpu_torch against gsl_tpu: the same
numpy inputs go to both packages."""
import numpy as np
import torch

from gsl_tpu.ops.projection import project_gaussians as jax_project

from gsl_tpu_torch.ops.projection import project_gaussians

from scene_utils import random_scene, simple_camera


def to_torch(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def both_projections(n, seed, width, height, **scene_kw):
    """Project one random scene with both packages.
    Returns (jax Projections, torch Projections, opacities [N], colors
    [N, 3]) with opacities/colors as numpy."""
    means, scales, quats, opac, colors = random_scene(n, seed, **scene_kw)
    cam = simple_camera(width, height)
    pj = jax_project(means, scales, quats, cam.world_to_camera, cam.fx,
                     cam.fy, cam.cx, cam.cy, width, height)
    pt = project_gaussians(
        to_torch(means), to_torch(scales), to_torch(quats),
        to_torch(cam.world_to_camera), to_torch(cam.fx), to_torch(cam.fy),
        to_torch(cam.cx), to_torch(cam.cy), width, height)
    return pj, pt, np.asarray(opac), np.asarray(colors)
