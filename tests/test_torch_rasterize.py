"""gsl_tpu_torch's rasterizer against gsl_tpu's Pallas rasterizer in its
exact mode (interpret=True, fast=False, exact_sort=True,
tile_based_culling=True) on the same numpy scenes. The CUDA kernels are
held against these plain versions in test_torch_kernels.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsl_tpu.ops.rasterize_jax import rasterize_tiles
from gsl_tpu.ops.rasterize_pallas import (_expand_sorted, _fwd_impl,
                                          _tiles_to_image,
                                          count_culled_isects,
                                          isect_encode_padded)
from gsl_tpu.ops.rasterize_reference import rasterize_oracle as jax_oracle
from gsl_tpu.ops.tiling import isect_encode as jax_isect_encode

from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops.projection import tile_rect
from gsl_tpu_torch.ops.rasterize_reference import rasterize_oracle

from torch_port_utils import both_projections, to_torch

W, H, TS = 64, 48, 16
TILES_X, TILES_Y = 4, 3
CAP = 8192
# rtol 1e-4 / atol 1e-5, as tests/test_rasterize_pallas.py holds the Pallas
# kernel to the XLA rasterizer: JAX closes the transmittance product
# through log1p/exp, the port multiplies sequentially
RTOL, ATOL = 1e-4, 1e-5


def _jax_depth_bits():
    return 32 - max(int(np.ceil(np.log2(TILES_X * TILES_Y + 1))), 1)


@pytest.mark.parametrize("n,seed", [(300, 0), (1000, 1), (50, 2)])
def test_expand_plain_matches_expand_sorted(n, seed):
    pj, pt, opac, colors = both_projections(n, seed, W, H)
    isects_j = isect_encode_padded(pj, H, W, TS, capacity=CAP)
    keys_j, gid_j, *_ = _expand_sorted(
        pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(colors),
        isects_j, CAP, TS, TILES_X, TILES_Y, _jax_depth_bits(), True, True,
        exact_sort=True)
    keys_j, gid_j = np.asarray(keys_j), np.asarray(gid_j)
    valid_j = keys_j != 0xFFFFFFFF

    isects = R.isect_encode(pt, H, W, TS)
    keys, gids = R.expand_plain(isects, pt.means2d, pt.conics,
                                to_torch(opac), pt.depths, TILES_X, TILES_Y,
                                TS, True)
    sk, gs, _ = R.sort_slots(keys, gids)
    valid = (sk != R.INVALID_KEY).numpy()

    assert isects.n_isects == int(isects_j.n_isects)
    assert isects.total == int(isects_j.total_padded)
    assert valid.sum() == valid_j.sum() == count_culled_isects(
        pj, opac, H, W, TS)
    # same Gaussians in the same (tile, depth) order, tile by tile
    assert np.array_equal(gs.numpy()[valid], gid_j[valid_j].astype(np.int64))
    assert np.array_equal((sk.numpy()[valid] >> 32),
                          (keys_j[valid_j] >> _jax_depth_bits()))
    # the CPU wrapper is the plain version
    k2, g2 = R.expand(isects, pt.means2d, pt.conics, to_torch(opac),
                      pt.depths, TILES_X, TILES_Y, TS, True)
    assert torch.equal(k2, keys) and torch.equal(g2, gids)


@pytest.mark.parametrize("n,seed", [(300, 0), (1000, 1)])
def test_forward_matches_pallas_exact_mode(n, seed):
    pj, pt, opac, colors = both_projections(n, seed, W, H)
    isects_j = isect_encode_padded(pj, H, W, TS, capacity=CAP)
    (img_j, alpha_j), res = _fwd_impl(
        pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(colors),
        isects_j, H, W, TS, 128, True, CAP, True, False, False, True)
    istop_j = np.asarray(_tiles_to_image(
        res[6].transpose(0, 2, 1), TILES_Y, TILES_X, TS, H, W))[..., 0]

    img, alpha, aux = R.rasterize(pt, to_torch(opac), to_torch(colors), H,
                                  W, TS, True)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(1.0 - aux.t_final.numpy(),
                               np.asarray(alpha_j), rtol=RTOL, atol=ATOL)
    # i_stop: the same sorted position, except where T sits within rounding
    # of 1e-4 and the stop moves by one splat
    assert aux.i_stop.dtype == torch.int32
    assert (aux.i_stop.numpy() == istop_j).mean() >= 0.995
    assert (aux.i_stop.numpy() < R.NEVER_STOPPED).any()
    assert aux.n_isects == int(isects_j.n_isects) and aux.n_dropped == 0


def test_forward_eight_channels_matches_xla():
    """C = 8 (rgb + depth + inverse depth + normal): the JAX Pallas path
    caps C at 5, so this is held against rasterize_tiles."""
    pj, pt, opac, colors = both_projections(400, 5, W, H)
    rng = np.random.RandomState(5)
    extra = rng.uniform(-1, 1, size=(400, 5)).astype(np.float32)
    ch = np.concatenate([colors, extra], axis=1)
    isects_j = jax_isect_encode(pj, H, W, TS, CAP)
    img_j, alpha_j = rasterize_tiles(
        pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(ch), isects_j,
        H, W, tile_size=TS, max_per_tile=2048, chunk=64)
    img, alpha, _ = R.rasterize(pt, to_torch(opac), to_torch(ch), H, W, TS,
                                True)
    assert img.shape == (H, W, 8)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j),
                               rtol=RTOL, atol=ATOL)


def test_forward_matches_port_oracle_and_oracles_agree():
    """The tile rasterizer equals the per-pixel oracle restricted to each
    splat's tile rectangle, and the port's oracle equals JAX's."""
    pj, pt, opac, colors = both_projections(120, 9, 32, 32)
    rmin, rmax = tile_rect(pt, TS, 2, 2)
    want, want_a = rasterize_oracle(
        pt.means2d, pt.conics, to_torch(opac), to_torch(colors), pt.depths,
        pt.mask, 32, 32, tile_rect_min=rmin, tile_rect_max=rmax)
    jw, jwa = jax_oracle(
        pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(colors),
        pj.depths, pj.mask, 32, 32, tile_rect_min=jnp.asarray(rmin.numpy()),
        tile_rect_max=jnp.asarray(rmax.numpy()))
    np.testing.assert_allclose(want.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(want_a.numpy(), np.asarray(jwa), rtol=RTOL,
                               atol=ATOL)
    img, alpha, _ = R.rasterize(pt, to_torch(opac), to_torch(colors), 32,
                                32, TS, False)
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(alpha.numpy(), want_a.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_empty_scene_and_offscreen_tiles():
    """No visible splat: zero image, alpha 0, T 1, no stop."""
    _, pt, opac, colors = both_projections(20, 0, W, H, z_range=(-3, -1))
    img, alpha, aux = R.rasterize(pt, to_torch(opac), to_torch(colors), H,
                                  W, TS, True)
    assert float(img.abs().max()) == 0.0 and float(alpha.max()) == 0.0
    assert bool((aux.i_stop == R.NEVER_STOPPED).all())
    assert aux.n_isects == 0
