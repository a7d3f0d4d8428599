"""Helpers for the tests that hold gsl_tpu_torch against gsl_tpu: the same
numpy inputs go to both packages."""
import numpy as np
import torch

from gsl_tpu.ops.projection import project_gaussians as jax_project

from gsl_tpu_torch.ops.projection import project_gaussians
from gsl_tpu_torch.utils.convert import state_from_raw_arrays

from scene_utils import random_scene, simple_camera

# The suite runs in several worker processes at once. The port's tests work
# on small tensors in long Python loops, where torch's intra-op thread pool
# (one per process, as wide as the machine) gains nothing and, with every
# worker owning one, oversubscribes the cores many times over.
torch.set_num_threads(1)


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


def small_port_state(n=200, seed=21, sh_rest=0.1):
    """A random scene as a port GaussianState on the CPU, every row alive,
    SH degree 3 with `sh_rest` N(0, 1) in the higher bands."""
    means, scales, quats, opac, colors = (np.asarray(a) for a in
                                          random_scene(n, seed))
    rng = np.random.RandomState(seed + 100)
    return state_from_raw_arrays(dict(
        means=means, scales=np.log(scales), rotations=quats,
        opacities=np.log(opac / (1 - opac))[:, None],
        shs_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
        shs_rest=sh_rest * rng.normal(size=(n, 15, 3))), device="cpu")


PARAM_FIELDS = ("means", "scales", "rotations", "opacities", "shs_dc",
                "shs_rest")


def jax_opt_arrays(opt_state):
    """The optax state of build_gaussian_optimizer as
    {property: {"mu", "nu", "count"}} numpy arrays."""
    opt = {}
    for k in PARAM_FIELDS:
        adam = opt_state.inner_states[k].inner_state[0]
        opt[k] = {"mu": np.asarray(getattr(adam.mu, k)),
                  "nu": np.asarray(getattr(adam.nu, k)),
                  "count": int(adam.count)}
    return opt


def jax_train_state_arrays(state):
    """A gsl_tpu TrainState taken apart into numpy arrays, as
    gsl_tpu_torch.utils.convert.train_state_from_jax_arrays takes them."""
    return dict(
        params={k: np.asarray(getattr(state.params, k))
                for k in PARAM_FIELDS},
        alive=np.asarray(state.alive), opt=jax_opt_arrays(state.opt_state),
        density={k: np.asarray(getattr(state.density, k))
                 for k in ("grad_accum", "denom", "max_radii")},
        step=int(state.step),
        extra=(None if state.extra is None
               else {k: np.asarray(v) for k, v in state.extra.items()}))
