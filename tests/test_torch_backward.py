"""Gradients of gsl_tpu_torch's rasterizer, projection and SH colour
against gsl_tpu's on the same numpy inputs. On the CPU the port's wrappers
run their plain versions (rasterize_bwd_plain, reduce_grads_plain); the
CUDA kernels are held against those in test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.ops.projection import project_gaussians as jax_project
from gsl_tpu.ops.rasterize_pallas import (isect_encode_padded,
                                          rasterize_pallas)
from gsl_tpu.ops.sh import sh_to_rgb as jax_sh_to_rgb

from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops.projection import project_gaussians, tile_rect
from gsl_tpu_torch.ops.rasterize_reference import rasterize_oracle
from gsl_tpu_torch.ops.sh import sh_to_rgb

from scene_utils import random_scene, simple_camera
from torch_port_utils import both_projections, to_torch

W, H, TS = 64, 48, 16
CAP = 8192


def _channels(colors, depths, n_channels, seed):
    rng = np.random.RandomState(seed)
    extra = rng.uniform(0.0, 1.0, (colors.shape[0], max(n_channels - 4, 0)))
    return np.concatenate(
        [colors, np.asarray(depths)[:, None], extra],
        axis=1)[:, :n_channels].astype(np.float32)


def _port_grads(pt, opac, ch, loss_fn):
    """Gradients of loss_fn(img_nobg, alpha) through the port's rasterize
    for means2d, conics, opacities, channels, and what arrives at the
    absgrad tap."""
    leaves = [x.clone().requires_grad_(True) for x in (
        pt.means2d, pt.conics, to_torch(opac), to_torch(ch))]
    tap = torch.zeros_like(pt.means2d, requires_grad=True)
    img, alpha, _ = R.rasterize(
        pt._replace(means2d=leaves[0], conics=leaves[1]), leaves[2],
        leaves[3], H, W, TS, True, tap)
    loss = loss_fn(img, alpha)
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in leaves + [tap]]


@pytest.mark.parametrize("n_channels", [3, 4])
def test_rasterize_gradients_match_pallas(n_channels):
    """The loss of tests/test_rasterize_pallas.py, and its tolerance: rtol
    5e-3 / atol 1e-4. The Pallas kernel closes the transmittance products
    through log1p/exp and triangle matmuls; the port divides T by
    (1 - alpha) step by step."""
    pj, pt, opac, colors = both_projections(400, 3, W, H)
    ch = _channels(colors, pj.depths, n_channels, 0)
    bg = np.array([0.05, 0.1, 0.15, 0.2], np.float32)[:n_channels]
    target = np.random.RandomState(1).uniform(
        size=(H, W, n_channels)).astype(np.float32)
    isects = isect_encode_padded(pj, H, W, TS, capacity=CAP, chunk=128)

    def loss_pallas(means2d, conics, op, col, abstap):
        img, alpha = rasterize_pallas(
            means2d, conics, op, col, abstap, isects, H, W, TS, 128, True,
            CAP, True, False, False, True)
        img = img + (1.0 - alpha)[..., None] * jnp.asarray(bg)
        return jnp.sum((img - target) ** 2) + 0.3 * jnp.sum(alpha ** 2)

    args = (pj.means2d, pj.conics, jnp.asarray(opac), jnp.asarray(ch),
            jnp.zeros_like(pj.means2d))
    l_j, g_j = jax.value_and_grad(loss_pallas, argnums=(0, 1, 2, 3, 4))(*args)

    def loss_port(img, alpha):
        img = img + (1.0 - alpha)[..., None] * to_torch(bg)
        return (((img - to_torch(target)) ** 2).sum()
                + 0.3 * (alpha ** 2).sum())

    l_t, g_t = _port_grads(pt, opac, ch, loss_port)
    np.testing.assert_allclose(l_t, float(l_j), rtol=1e-5)
    names = ["means2d", "conics", "opacities", "channels", "absgrad tap"]
    for got, want, name in zip(g_t, g_j, names):
        assert np.abs(np.asarray(want)).max() > 0.1, name
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n_channels", [3, 8])
def test_rasterize_gradients_match_autograd_of_oracle(n_channels):
    """The hand-derived backward against torch.autograd through the port's
    per-pixel oracle, which composites with the same sequential float32
    arithmetic: rtol 1e-4, atol 1e-6 of the largest gradient (the two sum
    the pixels of a tile in different orders). The absgrad tap has no
    autograd counterpart; it must bound |d means2d| from above and equal
    it where a Gaussian touches one tile."""
    pj, pt, opac, colors = both_projections(300, 5, W, H)
    ch = _channels(colors, pj.depths, n_channels, 1)
    target = to_torch(np.random.RandomState(2).uniform(
        size=(H, W, n_channels)).astype(np.float32))

    def loss_fn(img, alpha):
        return ((img - target) ** 2).sum() + 0.3 * (alpha ** 2).sum()

    _, g_t = _port_grads(pt, opac, ch, loss_fn)
    leaves = [x.clone().requires_grad_(True) for x in (
        pt.means2d, pt.conics, to_torch(opac), to_torch(ch))]
    rect_min, rect_max = tile_rect(pt, TS, W // TS, H // TS)
    img, alpha = rasterize_oracle(*leaves, pt.depths, pt.mask, H, W,
                                  rect_min, rect_max, TS)
    loss_fn(img, alpha).backward()
    for got, leaf, name in zip(g_t, leaves, ["means2d", "conics",
                                             "opacities", "channels"]):
        want = leaf.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    abs_tap, d_means = g_t[4], g_t[0]
    assert (abs_tap >= np.abs(d_means) - 1e-5).all()
    one_tile = ((rect_max - rect_min).prod(-1) == 1).numpy()
    assert one_tile.sum() > 10
    np.testing.assert_allclose(abs_tap[one_tile], np.abs(d_means[one_tile]),
                               rtol=1e-6, atol=1e-7)


def test_rasterize_forward_keeps_no_graph_for_serving():
    _, pt, opac, colors = both_projections(100, 2, W, H)
    with torch.no_grad():
        img, alpha, aux = R.rasterize(pt, to_torch(opac), to_torch(colors),
                                      H, W, TS)
    assert not img.requires_grad and not aux.t_final.requires_grad
    np.testing.assert_allclose(alpha.numpy(), 1.0 - aux.t_final.numpy())


@pytest.mark.parametrize("n_cols", [9, 14])
def test_reduce_grads_plain_matches_numpy_group_by(n_cols):
    rng = np.random.RandomState(n_cols)
    n, n_rows = 50, 400
    rows = rng.normal(size=(n_rows, n_cols)).astype(np.float32)
    gids = rng.randint(0, n, n_rows).astype(np.int32)
    want = np.zeros((n, n_cols + 2), np.float64)
    for r, g in zip(rows.astype(np.float64), gids):
        want[g, :6] += r[:6]
        want[g, 6:8] += np.abs(r[:2])
        want[g, 8:] += r[6:]
    got = R.reduce_grads_plain(to_torch(rows), to_torch(gids), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the CPU wrapper is the plain version
    same = R.reduce_grads(to_torch(rows), to_torch(gids), None, None, None,
                          n)
    assert torch.equal(same, got)


def _projection_inputs(n, seed):
    means, scales, quats, _, _ = (np.asarray(x) for x in
                                  random_scene(n, seed))
    means, scales, quats = means.copy(), scales.copy(), quats.copy()
    # rows the training state really holds: behind the camera, far off
    # screen, and padding slots (scale exp(-10), identity rotation, at the
    # origin, which is the camera's position here)
    means[0, 2] = -1.0
    means[1, 0] = 50.0
    means[2] = 0.0
    scales[2] = np.exp(-10.0)
    quats[2] = [1.0, 0.0, 0.0, 0.0]
    return means, scales, quats


def test_projection_vjp_matches_jax():
    """Random cotangents for every float output, pulled back to means,
    scales and quaternions: rtol 1e-4 / atol 1e-5 of each gradient's
    largest entry (float32 sums in different orders). Culled and padding
    rows get exactly zero, finite gradients."""
    n = 200
    means, scales, quats = _projection_inputs(n, 7)
    cam = simple_camera(W, H)
    rng = np.random.RandomState(0)
    cot = dict(means2d=rng.normal(size=(n, 2)), conics=rng.normal(
        size=(n, 3)), compensations=rng.normal(size=n),
        depths=rng.normal(size=n))
    cot = {k: v.astype(np.float32) for k, v in cot.items()}

    def f_jax(m, s, q):
        p = jax_project(m, s, q, cam.world_to_camera, cam.fx, cam.fy,
                        cam.cx, cam.cy, W, H)
        return sum(jnp.sum(getattr(p, k) * cot[k]) for k in cot)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats))
    leaves = [to_torch(x).requires_grad_(True)
              for x in (means, scales, quats)]
    p = project_gaussians(
        *leaves, to_torch(cam.world_to_camera), to_torch(cam.fx),
        to_torch(cam.fy), to_torch(cam.cx), to_torch(cam.cy), W, H)
    sum((getattr(p, k) * to_torch(cot[k])).sum() for k in cot).backward()
    assert int(p.mask.sum()) > 100 and not bool(p.mask[:3].any())
    for leaf, w, name in zip(leaves, want, ["means", "scales", "quats"]):
        got, w = leaf.grad.numpy(), np.asarray(w)
        assert np.isfinite(got).all(), name
        assert (got[~p.mask.numpy()] == 0.0).all(), name
        np.testing.assert_allclose(got, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_projection_gradient_of_a_zero_quaternion_is_finite():
    means, scales, quats = _projection_inputs(20, 8)
    quats[5] = 0.0
    leaves = [to_torch(x).requires_grad_(True)
              for x in (means, scales, quats)]
    p = project_gaussians(*leaves, torch.eye(4), 70.0, 70.0, W / 2, H / 2,
                          W, H)
    (p.means2d.sum() + p.conics.sum() + p.compensations.sum()).backward()
    for leaf in leaves:
        assert bool(torch.isfinite(leaf.grad).all())


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_vjp_matches_jax(degree):
    n = 100
    rng = np.random.RandomState(degree)
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    want = jax.grad(lambda s, d: jnp.sum(
        jax_sh_to_rgb(s, d, degree) * cot), argnums=(0, 1))(
            jnp.asarray(shs), jnp.asarray(dirs))
    leaves = [to_torch(shs).requires_grad_(True),
              to_torch(dirs).requires_grad_(True)]
    (sh_to_rgb(*leaves, degree) * to_torch(cot)).sum().backward()
    for leaf, w, name in zip(leaves, want, ["shs", "dirs"]):
        # degree 0 does not look at the directions: no gradient at all
        got = np.zeros_like(w) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
