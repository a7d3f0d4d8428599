"""The StopThePop path of gsl_tpu_torch (``stp_resort=True``) against
gsl_tpu's: per-tile depth-plane keys, the per-pixel resort of windows of 16
sorted positions, no transmittance stop, and the gradient.

The reference runs in its exact mode (``fast=False, exact_sort=True,
tile_based_culling=True``) with its Pallas kernels interpreted on the CPU.
On the CPU the port's wrappers run their plain versions
(``expand_plain(stp_resort=True)``, ``rasterize_fwd_stp_plain``,
``rasterize_bwd_stp_plain``); the CUDA kernels are held against those in
test_torch_kernels.py. A dense float64 oracle, written here from the
semantics alone, stands beside both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.ops.projection import Projections as JaxProjections
from gsl_tpu.ops.rasterize_pallas import (STP_WINDOW, _expand_sorted,
                                          isect_encode_padded,
                                          rasterize_pallas)

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.models.gaussian import (PARAM_FIELDS,
                                           VanillaGaussianConfig)
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops.projection import Projections
from gsl_tpu_torch.ops.rasterize_reference import (ALPHA_THRESHOLD,
                                                   MAX_ALPHA,
                                                   rasterize_oracle)
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.training.density import VanillaDensityControllerConfig
from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
from gsl_tpu_torch.viewer.renderer import ViewerRenderer

from torch_port_utils import small_port_state, to_torch

TS = 16
CAP = 4096      # the reference's slot budget: a multiple of its blocks


def _scene(n, seed, height=16, width=16, radius=8, kz_scale=0.6):
    """Seeded splats in screen space, as tests/test_stp_resort.py draws
    them: (means2d, conics, opacities, colours, depths, kz, radii)."""
    rng = np.random.RandomState(seed)
    means2d = (rng.rand(n, 2) * [width - 2, height - 2] + 1)
    conics = np.stack([rng.rand(n) * 0.15 + 0.03,
                       (rng.rand(n) - 0.5) * 0.02,
                       rng.rand(n) * 0.15 + 0.03], -1)
    opac = rng.rand(n) * 0.6 + 0.2
    colors = rng.rand(n, 3)
    depths = rng.rand(n) * 3 + 1
    kz = (rng.rand(n, 2) - 0.5) * kz_scale
    f32 = [x.astype(np.float32) for x in (means2d, conics, opac, colors,
                                          depths, kz)]
    return (*f32, np.full(n, radius, np.int32))


def _jax_projections(means2d, conics, depths, kz, radii):
    n = means2d.shape[0]
    return JaxProjections(
        means2d=jnp.asarray(means2d), depths=jnp.asarray(depths),
        radii=jnp.asarray(radii), conics=jnp.asarray(conics),
        compensations=jnp.ones(n), mask=jnp.ones(n, bool),
        depth_grads=jnp.asarray(kz))


def _torch_projections(means2d, conics, depths, kz, radii):
    n = means2d.shape[0]
    return Projections(
        means2d=to_torch(means2d), depths=to_torch(depths),
        radii=to_torch(radii), conics=to_torch(conics),
        compensations=torch.ones(n), mask=torch.ones(n, dtype=torch.bool),
        depth_grads=to_torch(kz))


def _pallas(scene, height, width, stp=True, channels=None, weights=None):
    """The reference's image and alpha, or with `weights` (wr, wa) the
    gradients of sum(img wr) + sum(alpha wa) for means2d, conics,
    opacities, channels and the AbsGS tap."""
    means2d, conics, opac, colors, depths, kz, radii = scene
    ch = colors if channels is None else channels
    pj = _jax_projections(means2d, conics, depths, kz, radii)
    isects = isect_encode_padded(pj, height, width, TS, capacity=CAP)

    def render(m, c, o, col, tap):
        return rasterize_pallas(m, c, o, col, tap, isects, height, width,
                                TS, 128, True, CAP, True, False, stp, True)

    args = (pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(ch),
            jnp.zeros_like(pj.means2d))
    if weights is None:
        img, alpha = render(*args)
        return np.asarray(img), np.asarray(alpha)
    wr, wa = (jnp.asarray(w) for w in weights)

    def loss(*a):
        img, alpha = render(*a)
        return jnp.sum(img * wr) + jnp.sum(alpha * wa)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *args)]


def _port(scene, height, width, stp=True, channels=None, weights=None):
    """The port's counterpart of `_pallas`, and the RasterAux."""
    means2d, conics, opac, colors, depths, kz, radii = scene
    ch = colors if channels is None else channels
    pt = _torch_projections(means2d, conics, depths, kz, radii)
    if weights is None:
        with torch.no_grad():
            img, alpha, aux = R.rasterize(pt, to_torch(opac), to_torch(ch),
                                          height, width, TS, True,
                                          stp_resort=stp)
        return img.numpy(), alpha.numpy(), aux
    leaves = [x.clone().requires_grad_(True) for x in (
        pt.means2d, pt.conics, to_torch(opac), to_torch(ch))]
    tap = torch.zeros_like(pt.means2d, requires_grad=True)
    img, alpha, _ = R.rasterize(
        pt._replace(means2d=leaves[0], conics=leaves[1]), leaves[2],
        leaves[3], height, width, TS, True, tap, stp_resort=stp)
    wr, wa = (to_torch(w) for w in weights)
    ((img * wr).sum() + (alpha * wa).sum()).backward()
    return [x.grad.numpy() for x in leaves + [tap]]


def _sorted_stream(scene, height, width):
    """The port's sorted Gaussian ids and tile bounds for a scene."""
    means2d, conics, opac, _, depths, kz, radii = scene
    pt = _torch_projections(means2d, conics, depths, kz, radii)
    tiles_x, tiles_y = -(-width // TS), -(-height // TS)
    isects = R.isect_encode(pt, height, width, TS)
    keys, gids = R.expand(isects, pt.means2d, pt.conics, to_torch(opac),
                          pt.depths, tiles_x, tiles_y, TS, True, True,
                          pt.depth_grads)
    sorted_keys, gids_sorted, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sorted_keys, tiles_x * tiles_y)
    return gids_sorted, bounds


def _dense_oracle(means2d, conics, opac, channels, depths, kz, gids_sorted,
                  bounds, height, width, origin="stream"):
    """Differentiable dense compositor in the dtype of its inputs: per
    tile, every pixel orders the tile's list by (window, d_p, position)
    and composites all of it, with no stop. Windows are position // 16 in
    the whole sorted stream (`origin="stream"`) or counted from the tile's
    first slot (`origin="tile"`, what the reference does not do). The
    order is a constant. Returns (img [H, W, C], alpha [H, W])."""
    tiles_x = -(-width // TS)
    img = torch.zeros((height, width, channels.shape[1]),
                      dtype=means2d.dtype)
    alpha_img = torch.zeros((height, width), dtype=means2d.dtype)
    for t in range(bounds.numel() - 1):
        st, end = int(bounds[t]), int(bounds[t + 1])
        y0, x0 = (t // tiles_x) * TS, (t % tiles_x) * TS
        ys = torch.arange(y0, min(y0 + TS, height))
        xs = torch.arange(x0, min(x0 + TS, width))
        if end == st or len(ys) == 0 or len(xs) == 0:
            continue
        g = gids_sorted[st:end].long()
        pos = torch.arange(st, end)
        window = (pos if origin == "stream" else pos - st) // STP_WINDOW
        py, px = torch.meshgrid(ys.to(means2d.dtype) + 0.5,
                                xs.to(means2d.dtype) + 0.5, indexing="ij")
        px, py = px.reshape(-1, 1), py.reshape(-1, 1)         # [P, 1]
        dx = means2d[g, 0][None, :] - px                      # [P, S]
        dy = means2d[g, 1][None, :] - py
        sigma = (0.5 * (conics[g, 0] * dx * dx + conics[g, 2] * dy * dy)
                 + conics[g, 1] * dx * dy)
        a = torch.clamp(opac[g] * torch.exp(-sigma), max=MAX_ALPHA)
        a = torch.where((sigma >= 0.0) & (a >= ALPHA_THRESHOLD), a,
                        torch.zeros_like(a))
        d_p = (depths[g] - kz[g, 0] * dx - kz[g, 1] * dy).detach()
        by_depth = torch.argsort(d_p, dim=1, stable=True)
        perm = by_depth.gather(1, torch.argsort(
            window[by_depth], dim=1, stable=True))            # [P, S]
        a_o = a.gather(1, perm)
        t_inc = torch.cumprod(1.0 - a_o, dim=1)
        t_exc = torch.cat([torch.ones_like(t_inc[:, :1]), t_inc[:, :-1]], 1)
        w = a_o * t_exc
        col = channels[g][perm]                               # [P, S, C]
        img[y0:y0 + len(ys), x0:x0 + len(xs)] = (
            (w[..., None] * col).sum(1).reshape(len(ys), len(xs), -1))
        alpha_img[y0:y0 + len(ys), x0:x0 + len(xs)] = (
            1.0 - t_inc[:, -1]).reshape(len(ys), len(xs))
    return img, alpha_img


def _oracle(scene, height, width, channels=None, origin="stream",
            dtype=torch.float64, weights=None):
    means2d, conics, opac, colors, depths, kz, _ = scene
    ch = colors if channels is None else channels
    gids_sorted, bounds = _sorted_stream(scene, height, width)
    leaves = [to_torch(x).to(dtype).requires_grad_(weights is not None)
              for x in (means2d, conics, opac, ch)]
    img, alpha = _dense_oracle(
        *leaves, to_torch(depths).to(dtype), to_torch(kz).to(dtype),
        gids_sorted, bounds, height, width, origin)
    if weights is None:
        return img.numpy(), alpha.numpy()
    wr, wa = (to_torch(w).to(dtype) for w in weights)
    ((img * wr).sum() + (alpha * wa).sum()).backward()
    return [x.grad.numpy() for x in leaves]


def _weights(height, width, n_channels=3, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(height, width, n_channels).astype(np.float32),
            rng.rand(height, width).astype(np.float32))


MULTI = dict(n=300, seed=5, height=48, width=64, radius=12)


def _multi_tile_scene():
    return _scene(**MULTI)


def test_stp_keys_sort_like_the_reference():
    """Multi-tile: the (tile, depth-plane key, slot) order of the port's
    `expand_plain(stp_resort=True)` + stable sort is the reference's
    `gid_sorted`, position by position over the valid slots, so both
    packages cut the same windows."""
    scene = _multi_tile_scene()
    means2d, conics, opac, colors, depths, kz, radii = scene
    H, W = MULTI["height"], MULTI["width"]
    tiles_x, tiles_y = W // TS, H // TS
    gids_sorted, bounds = _sorted_stream(scene, H, W)
    n_valid = int(bounds[-1])
    pj = _jax_projections(means2d, conics, depths, kz, radii)
    isects = isect_encode_padded(pj, H, W, TS, capacity=CAP)
    tile_bits = max(int(np.ceil(np.log2(tiles_x * tiles_y + 1))), 1)
    keys_j, gid_j, *_ = _expand_sorted(
        pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(colors),
        isects, CAP, TS, tiles_x, tiles_y, 32 - tile_bits, True, True,
        False, True, exact_sort=True)
    assert n_valid > 600
    assert int((np.asarray(keys_j) != 0xFFFFFFFF).sum()) == n_valid
    np.testing.assert_array_equal(
        np.asarray(gid_j)[:n_valid].astype(np.int64),
        gids_sorted[:n_valid].numpy())
    tiles_j = np.asarray(keys_j)[:n_valid] >> (32 - tile_bits)
    np.testing.assert_array_equal(
        np.searchsorted(tiles_j, np.arange(tiles_x * tiles_y + 1)),
        bounds.numpy())


def test_stp_key_is_the_depth_plane_at_the_tile_centre():
    """A steep plane changes a Gaussian's place in the tile's order, and a
    plane below zero at the tile centre is keyed at 0, not by its sign
    bit."""
    means2d = np.array([[7.0, 8.0], [9.0, 8.0], [4.0, 4.0]], np.float32)
    depths = np.array([2.0, 2.05, 0.5], np.float32)
    kz = np.array([[2.0, 0.0], [0.0, 0.0], [-1.0, 0.0]], np.float32)
    pt = _torch_projections(means2d, np.tile([0.08, 0, 0.08], (3, 1)).astype(
        np.float32), depths, kz, np.full(3, 8, np.int32))
    isects = R.isect_encode(pt, 16, 16, TS)
    args = (isects, pt.means2d, pt.conics, torch.full((3,), 0.9), pt.depths,
            1, 1, TS, True)
    keys, _ = R.expand_plain(*args, True, pt.depth_grads)
    # tile centre (8, 8): 2 + 2 (8 - 7) = 4; 2.05; 0.5 - (8 - 4) < 0 -> 0
    want = np.array([4.0, 2.05, 0.0], np.float32).view(np.int32)
    np.testing.assert_array_equal(keys.numpy(), want.astype(np.int64))
    plain_keys, _ = R.expand_plain(*args)
    np.testing.assert_array_equal(
        plain_keys.numpy(), depths.view(np.int32).astype(np.int64))
    with pytest.raises(ValueError, match="depth_grads"):
        R.expand(*args, stp_resort=True)


def test_stp_forward_one_tile_matches_pallas_and_the_oracle():
    """40 Gaussians in one tile, three windows: image and alpha within
    1e-4 of rasterize_pallas(stp_resort=True) and of the float64 oracle
    (float32 sums and products in different orders)."""
    scene = _scene(40, seed=3)
    img, alpha, aux = _port(scene, 16, 16)
    img_j, alpha_j = _pallas(scene, 16, 16)
    img_o, alpha_o = _oracle(scene, 16, 16)
    assert float(alpha.mean()) > 0.5
    for got, ref in ((img, img_j), (alpha, alpha_j), (img, img_o),
                     (alpha, alpha_o)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert bool((aux.i_stop == R.NEVER_STOPPED).all())
    np.testing.assert_allclose(alpha, 1.0 - aux.t_final.numpy())


def test_stp_forward_multi_tile_windows_straddle_tile_borders():
    """48x64, 300 Gaussians with non-zero depth slopes: most tile ranges
    start off a multiple of 16, so their first window is shared with the
    tile before. Image and alpha within 1e-4 of
    rasterize_pallas(stp_resort=True, interpret=True): windows are
    sorted position // 16 in the whole stream. Counting windows from each
    tile's first slot gives another image."""
    scene = _multi_tile_scene()
    H, W = MULTI["height"], MULTI["width"]
    _, bounds = _sorted_stream(scene, H, W)
    starts = bounds[:-1][bounds[1:] > bounds[:-1]]
    assert int((starts % STP_WINDOW != 0).sum()) >= 6
    assert int((bounds[1:] - bounds[:-1]).min()) > 2 * STP_WINDOW
    img, alpha, _ = _port(scene, H, W)
    img_j, alpha_j = _pallas(scene, H, W)
    np.testing.assert_allclose(img, img_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha, alpha_j, rtol=0, atol=1e-4)
    img_o, alpha_o = _oracle(scene, H, W)
    np.testing.assert_allclose(img, img_o, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha, alpha_o, rtol=0, atol=1e-4)
    img_t, _ = _oracle(scene, H, W, origin="tile")
    assert float(np.abs(img_t - img_j).max()) > 1e-2


def test_stp_two_gaussians_each_pixel_picks_its_own_order():
    """The scene of tests/test_rasterize_pallas.py::test_stp_per_pixel_resort:
    the centre depths say Gaussian 0 is in front, its steep plane puts it
    behind at the tile centre and at every pixel right of x = 7.025. The
    image is a per-pixel select between the two fixed-order renders."""
    means2d = np.array([[7.0, 8.0], [9.0, 8.0]], np.float32)
    conics = np.array([[0.08, 0.0, 0.08]] * 2, np.float32)
    opac = np.array([0.9, 0.9], np.float32)
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    depths = np.array([2.0, 2.05], np.float32)
    kz = np.array([[2.0, 0.0], [0.0, 0.0]], np.float32)
    scene = (means2d, conics, opac, colors, depths, kz,
             np.full(2, 8, np.int32))
    img_stp, _, _ = _port(scene, 16, 16)
    img_plain, _, _ = _port(scene, 16, 16, stp=False)
    assert not np.allclose(img_stp, img_plain)

    def fixed_order(fake_depths):
        return rasterize_oracle(
            to_torch(means2d), to_torch(conics), to_torch(opac),
            to_torch(colors), torch.tensor(fake_depths),
            torch.ones(2, dtype=torch.bool), 16, 16)[0].numpy()

    d0 = 2.0 + 2.0 * (np.arange(16) + 0.5 - 7.0)
    expected = np.where((d0 < 2.05)[None, :, None], fixed_order([2.0, 2.05]),
                        fixed_order([4.0, 2.05]))
    np.testing.assert_allclose(img_stp, expected, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img_plain, fixed_order([2.0, 2.05]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img_stp, _pallas(scene, 16, 16)[0],
                               rtol=1e-4, atol=1e-5)


def test_stp_with_flat_planes_equals_the_plain_renderer():
    """kz = 0 and nothing saturates: the per-pixel order is the key order
    and no pixel would have stopped, so STP is the plain rasterizer, to
    the rounding of the same products in the same order (1e-6)."""
    scene = list(_scene(12, seed=11))
    scene[5] = np.zeros_like(scene[5])
    scene[2] = scene[2] * 0.3
    img_stp, alpha_stp, _ = _port(scene, 16, 16)
    img, alpha, aux = _port(scene, 16, 16, stp=False)
    assert bool((aux.i_stop == R.NEVER_STOPPED).all())
    np.testing.assert_allclose(img_stp, img, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(alpha_stp, alpha, rtol=1e-5, atol=1e-6)


def test_stp_equal_depths_fall_back_to_position():
    """Every Gaussian twice, in other colours: the copies tie in d_p at
    every pixel, and the order falls back to sorted position in the
    forward and the backward alike (float64 oracle, which sorts stably:
    1e-4 of the image, 1e-4 of each gradient's largest entry)."""
    base = _scene(20, seed=2)
    scene = tuple(np.concatenate([x, x]) for x in base)
    scene[3][20:] = 1.0 - scene[3][20:]
    img, alpha, _ = _port(scene, 16, 16)
    img_o, alpha_o = _oracle(scene, 16, 16)
    np.testing.assert_allclose(img, img_o, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha, alpha_o, rtol=0, atol=1e-4)
    weights = _weights(16, 16)
    for got, want in zip(_port(scene, 16, 16, weights=weights),
                         _oracle(scene, 16, 16, weights=weights)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", ["one_tile", "multi_tile"])
def test_stp_gradients_match_pallas(case):
    """Gradients of a seeded weighted sum of image and alpha for means2d,
    conics, opacities, channels and the AbsGS tap against jax.grad of
    rasterize_pallas(stp_resort=True), C = 3, at the tolerance of
    tests/test_rasterize_pallas.py: rtol 5e-3 / atol 1e-4 (the reference
    closes the transmittance products through log1p/exp, the port
    multiplies them out)."""
    if case == "one_tile":
        scene, H, W = _scene(24, seed=7), 16, 16
    else:
        scene, H, W = _multi_tile_scene(), MULTI["height"], MULTI["width"]
    weights = _weights(H, W)
    got = _port(scene, H, W, weights=weights)
    want = _pallas(scene, H, W, weights=weights)
    names = ["means2d", "conics", "opacities", "channels", "absgrad tap"]
    for g, w, name in zip(got, want, names):
        assert np.abs(w).max() > 0.1, name
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("n_channels", [3, 8])
def test_stp_gradients_match_autograd_of_the_float64_oracle(n_channels):
    """The hand-derived backward against torch.autograd through the dense
    float64 oracle, multi-tile, with an image that is not a whole number
    of tiles: rtol 1e-4, atol 1e-4 of each gradient's largest entry. The
    reference cannot run C = 8 in this mode. The AbsGS tap bounds
    |d means2d| from above."""
    H, W = 40, 56
    scene = _scene(200, seed=9, height=H, width=W, radius=12)
    rng = np.random.RandomState(4)
    ch = rng.rand(200, n_channels).astype(np.float32)
    weights = _weights(H, W, n_channels, seed=6)
    got = _port(scene, H, W, channels=ch, weights=weights)
    want = _oracle(scene, H, W, channels=ch, weights=weights)
    for g, w, name in zip(got, want, ["means2d", "conics", "opacities",
                                      "channels"]):
        assert np.abs(w).max() > 0.1, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    assert (got[4] >= np.abs(got[0]) - 1e-5).all()
    img, alpha, _ = _port(scene, H, W, channels=ch)
    img_o, alpha_o = _oracle(scene, H, W, channels=ch)
    np.testing.assert_allclose(img, img_o, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha, alpha_o, rtol=0, atol=1e-4)


def _saturated_scene():
    """48 Gaussians of opacity 0.99 on one spot of one tile: T_final
    underflows to 0 at the spot."""
    scene = list(_scene(48, seed=13, kz_scale=0.2))
    rng = np.random.RandomState(14)
    scene[0] = (np.array([8.0, 8.0]) + 0.05 * rng.randn(48, 2)).astype(
        np.float32)
    scene[2] = np.full(48, 0.99, np.float32)
    return tuple(scene)


def test_stp_saturated_tile_has_finite_gradients():
    """With no stop, 48 near-opaque Gaussians drive T_final to 0 (0.01^48
    is far below the smallest float32). The forward and every gradient
    stay finite and agree with the float64 oracle (1e-4 of the image; rtol
    1e-3 and 1e-4 of each gradient's largest entry: float32 rounds T where
    it runs through the denormals), and a Gaussian behind the point where
    T reaches 0 gets exactly 0."""
    scene = _saturated_scene()
    img, alpha, aux = _port(scene, 16, 16)
    assert float(aux.t_final.min()) == 0.0
    assert np.isfinite(img).all() and np.isfinite(alpha).all()
    img_o, alpha_o = _oracle(scene, 16, 16)
    np.testing.assert_allclose(img, img_o, rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha, alpha_o, rtol=0, atol=1e-4)
    weights = _weights(16, 16)
    got = _port(scene, 16, 16, weights=weights)
    want = _oracle(scene, 16, 16, weights=weights)
    for g, w, name in zip(got, want, ["means2d", "conics", "opacities",
                                      "channels"]):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    assert np.isfinite(got[4]).all()


def test_stp_rows_are_exactly_zero_where_nothing_gets_through():
    """The rows of the slots behind an opaque wall are exactly 0 at the
    pixels where T is 0; with every pixel of the tile walled off, the
    whole row is."""
    n = 60
    scene = list(_scene(n, seed=15, kz_scale=0.0))
    scene[1] = np.tile([1e-4, 0.0, 1e-4], (n, 1)).astype(np.float32)
    scene[2] = np.full(n, 0.99, np.float32)
    scene[4] = np.linspace(1.0, 4.0, n).astype(np.float32)
    means2d, conics, opac, colors, depths, kz, radii = scene
    gids_sorted, bounds = _sorted_stream(scene, 16, 16)
    args = [to_torch(x) for x in (means2d, conics, opac, colors, depths, kz)]
    out, t_fin, _, ckpt = STP.rasterize_fwd_stp(
        *args, gids_sorted, bounds, 16, 16, TS, checkpoints=True)
    assert float(t_fin.max()) == 0.0
    wr, wa = (to_torch(w) for w in _weights(16, 16))
    rows = STP.rasterize_bwd_stp(*args, gids_sorted, bounds, wr, wa, t_fin,
                                 ckpt, TS)
    assert bool(torch.isfinite(rows).all())
    assert float(rows[:16].abs().max()) > 0.0
    assert float(rows[48:].abs().max()) == 0.0


def test_stp_reference_gradient_on_the_saturated_tile():
    """The reference on the saturated tile: its backward rebuilds T_exc as
    T_run * exp(-S_inc) (rasterize_pallas.py, `_bwd_kernel`), 0 * inf where
    T_final underflowed. Whatever it returns, the port's gradients are
    held to the oracle above; this test only pins what the reference does
    today, so ROADMAP.md's note on it stays true."""
    scene = _saturated_scene()
    want = _pallas(scene, 16, 16, weights=_weights(16, 16))
    finite = [bool(np.isfinite(w).all()) for w in want]
    assert finite == [False] * 5 or finite == [True] * 5
    img_j, alpha_j = _pallas(scene, 16, 16)
    assert np.isfinite(img_j).all() and np.isfinite(alpha_j).all()


def test_stp_checkpoints_are_the_transmittance_at_window_starts():
    """Window k of tile t leaves its T at row bounds[t] // 16 + k + t, and
    the last window's T times its (1 - a) is T_final; serving (no
    gradient wanted) keeps no checkpoints."""
    scene = _multi_tile_scene()
    H, W = MULTI["height"], MULTI["width"]
    means2d, conics, opac, colors, depths, kz, _ = scene
    gids_sorted, bounds = _sorted_stream(scene, H, W)
    args = [to_torch(x) for x in (means2d, conics, opac, colors, depths, kz)]
    out, t_fin, i_stop, ckpt = STP.rasterize_fwd_stp(
        *args, gids_sorted, bounds, H, W, TS, checkpoints=True)
    n_tiles = bounds.numel() - 1
    assert ckpt.shape == (STP.checkpoint_rows(gids_sorted.numel(), n_tiles),
                          TS * TS)
    rows_used = set()
    for t in range(n_tiles):
        st, end = int(bounds[t]), int(bounds[t + 1])
        w0 = st // STP_WINDOW
        for k in range((end - 1) // STP_WINDOW - w0 + 1):
            rows_used.add(w0 + k + t)
        assert bool((ckpt[w0 + t] == 1.0).all())
        last = ckpt[(end - 1) // STP_WINDOW + t]
        tile_t = t_fin[(t // 4) * TS:(t // 4 + 1) * TS,
                       (t % 4) * TS:(t % 4 + 1) * TS].reshape(-1)
        assert bool((tile_t <= last).all())
    assert len(rows_used) == sum(
        (int(bounds[t + 1]) - 1) // STP_WINDOW - int(bounds[t]) // STP_WINDOW
        + 1 for t in range(n_tiles))
    again = STP.rasterize_fwd_stp(*args, gids_sorted, bounds, H, W, TS)
    assert again[3] is None and torch.equal(again[0], out)
    assert bool((i_stop == R.NEVER_STOPPED).all())


# ---- renderer, viewer and trainer over an STP renderer -------------------

RW, RH = 64, 48
ALL_TYPES = frozenset({"rgb", "alpha", "acc_depth", "exp_depth",
                       "inverse_depth", "hard_inverse_depth", "normal"})


def _camera(i=0):
    return make_camera(R=np.eye(3), T=[0.3 * i - 0.3, 0.0, 0.0], fx=70.0,
                       fy=70.0, cx=RW / 2, cy=RH / 2, width=RW, height=RH,
                       device="cpu")


def test_stp_renderer_renders_every_output():
    """TileRenderer(stp_resort=True).forward for every render type: finite
    images of the right shape, rgb equal to a direct
    rasterize(stp_resort=True) of the same projection, the depth channels
    consistent with each other, and an image that differs from the plain
    renderer's where the order changed."""
    state, cam = small_port_state(), _camera(1)
    bg = torch.tensor([0.1, 0.2, 0.3])
    renderer = TileRendererConfig(stp_resort=True).instantiate()
    with torch.no_grad():
        out = renderer.forward(state, cam, RH, RW, bg, 3,
                               render_types=ALL_TYPES)
        plain = TileRendererConfig().instantiate().forward(
            state, cam, RH, RW, bg, 3, render_types=ALL_TYPES)
        img, alpha, aux = R.rasterize(
            out.projections,
            renderer.get_opacities(state, cam, out.projections),
            renderer.get_rgbs(state, cam, 3), RH, RW, stp_resort=True)
    shapes = dict(render=(RH, RW, 3), alpha=(RH, RW), acc_depth=(RH, RW),
                  exp_depth=(RH, RW), inverse_depth=(RH, RW),
                  hard_inverse_depth=(RH, RW), normal=(RH, RW, 3))
    for key, shape in shapes.items():
        v = getattr(out, key)
        assert tuple(v.shape) == shape, key
        assert bool(torch.isfinite(v).all()), key
    # the same sums with 8 channels in the pass or 3: float32 rounding
    np.testing.assert_allclose(
        out.render.numpy(), (img + (1 - alpha)[..., None] * bg).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.alpha.numpy(), alpha.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert bool((aux.i_stop == R.NEVER_STOPPED).all())
    assert float(out.alpha.mean()) > 0.2
    assert float(out.hard_inverse_depth.max()) > 0.0
    seen = out.alpha > 0.5
    assert float((out.exp_depth[seen] - 4.0).abs().max()) < 2.5
    assert out.n_isects == plain.n_isects and out.n_dropped == 0
    diff = (out.render - plain.render).abs()
    assert 1e-3 < float(diff.max()) and float(diff.mean()) < 0.05
    assert renderer.supports_absgrad()
    assert set(renderer.get_available_outputs()) == set(ALL_TYPES)


@pytest.mark.parametrize("output_type", ["rgb", "exp_depth", "normal"])
def test_viewer_renderer_serves_an_stp_renderer(output_type):
    """ViewerRenderer takes any renderer: over the renderer that stp.yaml
    configures it returns uint8 frames that are not black, and a depth
    map."""
    renderer = TileRendererConfig(stp_resort=True).instantiate()
    viewer = ViewerRenderer(small_port_state(), renderer, 3)
    viewer.output_type = output_type
    c2w = np.eye(4)
    frame = viewer.get_outputs(c2w, RW, RH)
    assert frame.shape == (RH, RW, 3) and frame.dtype == np.uint8
    assert int(frame.max()) > 50
    depth = viewer.get_depth(c2w, RW, RH)
    assert depth.shape == (RH, RW) and np.isfinite(depth).all()


@pytest.mark.parametrize("absgrad", [False, True])
def test_trainer_steps_and_densifies_with_an_stp_renderer(absgrad):
    """Three Trainer.train_steps and a maybe_density_ops that densifies,
    over TileRendererConfig(stp_resort=True), on the CPU: the loss is
    finite and falls, the parameters stay finite, Gaussians are born.

    The step as a whole has no reference on the CPU: gsl_tpu's XLA
    backend ignores stp_resort and its Pallas branch is compiled for the
    TPU only (interpret is fixed to False in its renderer). The parity of
    the STP path is carried by the op-level tests above."""
    truth = small_port_state(n=150, seed=11, sh_rest=0.0)
    stp = TileRendererConfig(stp_resort=True)
    bg = torch.zeros(3)
    with torch.no_grad():
        targets = [stp.instantiate().forward(truth, _camera(i), RH, RW, bg,
                                             0).render for i in range(3)]
    model = VanillaGaussianConfig(sh_degree=0)
    trainer = Trainer(
        model=model, renderer=stp,
        density=VanillaDensityControllerConfig(
            densify_from_iter=0, densification_interval=3,
            densify_until_iter=100, opacity_reset_interval=1000,
            densify_grad_threshold=1e-9, absgrad=absgrad),
        config=TrainerConfig(max_steps=4))
    assert trainer.renderer.config.stp_resort
    state = trainer.setup(model.init_from_pcd(
        truth.params.means.numpy(), np.full((150, 3), 0.5, np.float32), 512,
        device="cpu"), cameras_extent=1.5)
    gen = torch.Generator().manual_seed(0)
    n0 = state.gaussians.n_alive
    losses = []
    for step in (1, 2, 3):
        state, scalars = trainer.train_step(
            state, _camera(0), targets[0], RH, RW, 0, bg)
        losses.append(float(scalars["loss"]))
        state = trainer.maybe_density_ops(state, gen, step)
    assert all(np.isfinite(x) for x in losses)
    assert losses[2] < losses[0]
    assert state.gaussians.n_alive > n0 + 10
    state, scalars = trainer.train_step(state, _camera(1), targets[1], RH,
                                        RW, 0, bg)
    assert np.isfinite(float(scalars["loss"]))
    for k in PARAM_FIELDS:
        assert bool(torch.isfinite(getattr(state.params, k)).all()), k
    assert state.step == 4


def test_stp_cpu_wrappers_are_the_plain_versions_and_check_their_inputs():
    scene = _scene(30, seed=17)
    means2d, conics, opac, colors, depths, kz, _ = scene
    gids_sorted, bounds = _sorted_stream(scene, 16, 16)
    args = [to_torch(x) for x in (means2d, conics, opac, colors, depths, kz)]
    before = (STP.rasterize_fwd_stp.launches, STP.rasterize_bwd_stp.launches)
    fwd = STP.rasterize_fwd_stp(*args, gids_sorted, bounds, 16, 16, TS,
                                checkpoints=True)
    plain = STP.rasterize_fwd_stp_plain(*args, gids_sorted, bounds, 16, 16,
                                        TS, checkpoints=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, plain))
    wr, wa = (to_torch(w) for w in _weights(16, 16))
    stats = {}
    rows = STP.rasterize_bwd_stp(*args, gids_sorted, bounds, wr, wa, fwd[1],
                                 fwd[3], TS)
    rows_p = STP.rasterize_bwd_stp_plain(*args, gids_sorted, bounds, wr, wa,
                                         fwd[1], fwd[3], TS, stats=stats)
    assert torch.equal(rows, rows_p) and rows.shape == (30, 9)
    assert 0 < stats["composited_pairs"] <= 30 * 256
    assert before == (STP.rasterize_fwd_stp.launches,
                      STP.rasterize_bwd_stp.launches)
    pt = _torch_projections(means2d, conics, depths, kz,
                            np.full(30, 8, np.int32))
    with pytest.raises(ValueError, match="depth_grads"):
        R.rasterize(pt._replace(depth_grads=None), args[2], args[3], 16, 16,
                    stp_resort=True)
