"""gsl_tpu_torch ops against gsl_tpu on the same numpy inputs: transforms,
spherical harmonics, projection and tile rectangles, cameras, model
getters.

Tolerance rtol 1e-5 / atol 1e-6 for float32 results: both sides run the
same float32 arithmetic in the same order; only library reductions
(norms, the 3x3 matmul) may round differently, by an ulp or two.
Integers (radii, tile rectangles) must be equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsl_tpu.data.cameras import make_camera as jax_make_camera
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.ops import sh as jsh
from gsl_tpu.ops import transforms as jtf
from gsl_tpu.ops.projection import tile_rect as jax_tile_rect

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.ops import sh as tsh
from gsl_tpu_torch.ops import transforms as ttf
from gsl_tpu_torch.ops.projection import tile_rect
from gsl_tpu_torch.utils.convert import state_from_jax_arrays

from torch_port_utils import both_projections, to_torch

RTOL, ATOL = 1e-5, 1e-6


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_transforms_match_jax():
    q = np.random.RandomState(0).normal(size=(64, 4)).astype(np.float32)
    close(ttf.normalize_quat(to_torch(q)), jtf.normalize_quat(jnp.asarray(q)))
    qn = np.asarray(jtf.normalize_quat(jnp.asarray(q)))
    close(ttf.quat_to_rotmat(to_torch(qn)), jtf.quat_to_rotmat(qn))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb_matches_jax(degree):
    rng = np.random.RandomState(degree)
    shs = rng.normal(size=(200, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    close(tsh.sh_to_rgb(to_torch(shs), to_torch(dirs), degree),
          jsh.sh_to_rgb(jnp.asarray(shs), jnp.asarray(dirs), degree))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


def test_sh_dc_conversions_match_jax():
    rgb = np.random.RandomState(1).uniform(size=(50, 3)).astype(np.float32)
    close(tsh.rgb_to_sh0(to_torch(rgb)), jsh.rgb_to_sh0(jnp.asarray(rgb)))
    close(tsh.sh0_to_rgb(to_torch(rgb)), jsh.sh0_to_rgb(jnp.asarray(rgb)))


@pytest.mark.parametrize("n,seed,w,h", [(300, 0, 64, 48), (200, 4, 128, 96)])
def test_projection_and_tile_rect_match_jax(n, seed, w, h):
    pj, pt, _, _ = both_projections(n, seed, w, h)
    for f in ("means2d", "depths", "conics", "compensations", "depth_grads"):
        close(getattr(pt, f), getattr(pj, f))
    assert np.array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    assert pt.radii.dtype == torch.int32
    assert np.array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    tx, ty = -(-w // 16), -(-h // 16)
    for got, want in zip(tile_rect(pt, 16, tx, ty),
                         jax_tile_rect(pj, 16, tx, ty)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_tile_rect_truncates_toward_zero():
    """Means just left of / above the image: the int32 cast truncates
    toward zero (not floor), so the rect starts at tile 0 exactly as in
    JAX."""
    pj, pt, _, _ = both_projections(300, 6, 64, 48, spread=2.0)
    left = (pt.means2d[:, 0] < 0) & (pt.radii > 0)
    assert bool(left.any())
    for got, want in zip(tile_rect(pt, 16, 4, 3), jax_tile_rect(pj, 16, 4, 3)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_camera_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.normal(size=4).astype(np.float32)
    R = np.asarray(jtf.quat_to_rotmat(jtf.normalize_quat(jnp.asarray(q))))
    T = rng.normal(size=3).astype(np.float32)
    kw = dict(fx=70.0, fy=71.0, cx=32.0, cy=24.0, width=64, height=48)
    cj = jax_make_camera(R=R, T=T, **kw)
    ct = make_camera(R=R, T=T, device="cpu", **kw)
    close(ct.world_to_camera, cj.world_to_camera)
    close(ct.camera_center, cj.camera_center)
    assert ct.fx.dtype == torch.float32 and ct.width == 64


def test_model_getters_match_jax():
    rng = np.random.RandomState(3)
    cap, n = 40, 30
    params = dict(
        means=rng.normal(size=(cap, 3)), scales=rng.uniform(-5, -1, (cap, 3)),
        rotations=rng.normal(size=(cap, 4)),
        opacities=rng.normal(size=(cap, 1)),
        shs_dc=rng.normal(size=(cap, 1, 3)),
        shs_rest=rng.normal(size=(cap, 15, 3)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = np.arange(cap) < n
    js = JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                      for k, v in params.items()}),
                  alive=jnp.asarray(alive))
    ts = state_from_jax_arrays(params, alive, device="cpu")
    assert ts.capacity == cap and ts.n_alive == n
    for getter in ("get_means", "get_scales", "get_rotations",
                   "get_opacities", "get_shs"):
        close(getattr(ts, getter)(), getattr(js, getter)())
    assert float(ts.get_opacities()[n:].abs().max()) == 0.0
