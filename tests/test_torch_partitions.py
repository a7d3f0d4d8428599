"""gsl_tpu_torch's city-scale slice against gsl_tpu's on the same seeded
numpy inputs: the partitioning and its file, update_stats's distance
damping and the partition store, and the LoD renderer's frustum test,
choice of levels, fallback and frames. The partition tools are held to
the repo-root tools in test_torch_partition_tools.py."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_tpu.data.cameras import make_camera as jax_make_camera
from gsl_tpu.data.cameras import stack_cameras as jax_stack_cameras
from gsl_tpu.models.gaussian import GaussianParams as JaxParams
from gsl_tpu.models.gaussian import GaussianState as JaxState
from gsl_tpu.renderers import partition_lod as jlod
from gsl_tpu.renderers.tile_renderer import \
    TileRendererConfig as JaxRendererConfig
from gsl_tpu.training import density as jd
from gsl_tpu.training import stores as jstores
from gsl_tpu.utils import partitioning as jpart

from gsl_tpu_torch.data.cameras import make_camera, stack_cameras
from gsl_tpu_torch.renderers import partition_lod as tlod
from gsl_tpu_torch.training import density as td
from gsl_tpu_torch.training import stores as tstores
from gsl_tpu_torch.utils import partitioning as tpart
from gsl_tpu_torch.utils.convert import state_from_raw_arrays
from gsl_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply

import torch_port_utils  # noqa: F401  (one intra-op thread)

JAX_RENDERER = dict(backend="xla", max_per_tile=4096, chunk=64)
KEYS = ("partition_size", "origin", "rotation", "ijs", "xy_mins",
        "xy_maxs", "camera_masks")


# ---- partitioning ---------------------------------------------------------

def _look_at(pos, target):
    """(R, T) of a camera at `pos` looking at `target`, y up."""
    fwd = np.asarray(target, np.float64) - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return R, -R @ np.asarray(pos, np.float64)


def _ground_cameras(n, seed):
    """n cameras over a 12 x 12 ground patch (y up) looking at points of
    the patch: their centres, and the batch in each package."""
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.uniform(-6, 6, n), rng.uniform(-1.5, -0.5, n),
                    rng.uniform(-6, 6, n)], -1)
    targets = pos + np.stack([rng.uniform(-3, 3, n), np.full(n, 1.0),
                              rng.uniform(-3, 3, n)], -1)
    kw = [dict(zip(("R", "T"), _look_at(p, t)), fx=40.0, fy=40.0, cx=24.0,
               cy=16.0, width=48, height=32) for p, t in zip(pos, targets)]
    jcams = jax_stack_cameras([jax_make_camera(**k) for k in kw])
    tcams = stack_cameras([make_camera(device="cpu", **k) for k in kw])
    return pos, jcams, tcams


def _ground_points(n, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-7, 7, n), rng.uniform(-0.5, 0.5, n),
                     rng.uniform(-7, 7, n)], -1).astype(np.float32)


def _npz(path):
    d = np.load(path)
    return {k: d[k] for k in d.files}


@pytest.mark.parametrize("case", ["centres", "points", "points_cameras",
                                  "convex_hull"])
def test_build_partitions_matches_jax(case, tmp_path):
    """The same cells, camera masks and derived config (both packages
    write partition_size and origin into the caller's SceneConfig), and
    partitions.npz files whose arrays are equal; each package loads the
    other's file."""
    centres, jcams, tcams = _ground_cameras(30, seed=1)
    points = None if case == "centres" else _ground_points(400, seed=2)
    with_cams = case in ("points_cameras", "convex_hull")
    mode = "convex_hull" if case == "convex_hull" else "points"
    jcfg = jpart.SceneConfig(visibility_mode=mode, visibility_threshold=0.1)
    tcfg = tpart.SceneConfig(visibility_mode=mode, visibility_threshold=0.1)
    want = jpart.build_partitions(centres, points, jcfg, n_partitions_hint=4,
                                  cameras=jcams if with_cams else None)
    got = tpart.build_partitions(centres, points, tcfg, n_partitions_hint=4,
                                 cameras=tcams if with_cams else None)
    assert tcfg.partition_size == jcfg.partition_size > 0
    np.testing.assert_array_equal(tcfg.origin, jcfg.origin)
    assert len(got.partitions) == len(want.partitions) == 4
    masks = np.stack([p.camera_mask for p in got.partitions])
    if case == "points_cameras":
        # visibility adds cameras beyond the enlarged cells
        in_box = [np.all((centres[:, [0, 2]] >= p.xy_min - 0.1 * tcfg.
                          partition_size) & (centres[:, [0, 2]] < p.xy_max
                                             + 0.1 * tcfg.partition_size),
                         axis=1) for p in got.partitions]
        assert (masks.sum() > np.stack(in_box).sum())
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want.save(jpath)
    got.save(tpath)
    j, t = _npz(jpath), _npz(tpath)
    for k in KEYS:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for scene in (tpart.PartitionedScene.load(jpath),
                  jpart.PartitionedScene.load(tpath)):
        np.testing.assert_array_equal(
            np.stack([p.camera_mask for p in scene.partitions]), masks)
        assert scene.up_axis == 1


def test_partitions_file_keeps_the_up_axis(tmp_path):
    """gsl_tpu's save drops up_axis and its load rebuilds it as 1; the
    port writes it as an extra key, which gsl_tpu's load ignores, and
    reads it back, 1 where the file has none."""
    pts = _ground_points(200, seed=3)[:, [0, 2, 1]]      # z up
    scene = tpart.build_partitions(pts, up_axis=2, n_partitions_hint=4)
    path = str(tmp_path / "partitions.npz")
    scene.save(path)
    assert tpart.PartitionedScene.load(path).up_axis == 2
    assert jpart.PartitionedScene.load(path).up_axis == 1    # its fault
    jpath = str(tmp_path / "jax.npz")
    jpart.build_partitions(pts, up_axis=2, n_partitions_hint=4).save(jpath)
    assert "up_axis" not in _npz(jpath)
    assert tpart.PartitionedScene.load(jpath).up_axis == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_auto_hyper_parameter_matches_jax(seed):
    n = int(np.random.RandomState(seed).randint(50, 2000))
    for mode in ("linear", "sqrt", "none"):
        assert tpart.auto_hyper_parameter(n, scale_mode=mode) == \
            jpart.auto_hyper_parameter(n, scale_mode=mode)


# ---- density damping and the store ----------------------------------------

@pytest.mark.parametrize("damped", [False, True])
def test_update_stats_distance_factors_match_jax(damped):
    rng = np.random.RandomState(5)
    cap = 257
    g = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-3
    radii = rng.randint(0, 4, cap).astype(np.int32)
    scale = np.array([24.0, 16.0], np.float32)
    dist = rng.uniform(0, 3, cap).astype(np.float32) if damped else None
    acc = [rng.uniform(0, 1, cap).astype(np.float32) for _ in range(3)]
    want = jd.update_stats(
        jd.DensityControlState(*(jnp.asarray(a) for a in acc)),
        jnp.asarray(g), jnp.asarray(radii), jnp.asarray(scale),
        distance_factors=None if dist is None else jnp.asarray(dist))
    got = td.update_stats(
        td.DensityControlState(*(torch.from_numpy(a) for a in acc)),
        torch.from_numpy(g), torch.from_numpy(radii),
        torch.from_numpy(scale),
        distance_factors=None if dist is None else torch.from_numpy(dist))
    for k in ("grad_accum", "denom", "max_radii"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_partition_store_matches_jax(tmp_path):
    """Distances within 1e-6 of gsl_tpu's on a scene with a rotation; the
    vanilla store gives None in both."""
    centres = np.random.RandomState(0).uniform(-10, 10, (40, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    scene = tpart.build_partitions(centres, n_partitions_hint=4,
                                   rotation=rot)
    path = str(tmp_path / "partitions.npz")
    scene.save(path)
    means = np.random.RandomState(1).uniform(-25, 25, (300, 3)).astype(
        np.float32)
    arrays = dict(means=means, scales=np.zeros((300, 3), np.float32),
                  rotations=np.tile([1.0, 0, 0, 0], (300, 1)).astype(
                      np.float32),
                  opacities=np.zeros((300, 1), np.float32),
                  shs_dc=np.zeros((300, 1, 3), np.float32),
                  shs_rest=np.zeros((300, 0, 3), np.float32))
    jstate = JaxState(params=JaxParams(**{k: jnp.asarray(v)
                                          for k, v in arrays.items()}),
                      alive=jnp.ones(300, bool))
    tstate = state_from_raw_arrays(arrays, device="cpu")
    for idx in range(len(scene.partitions)):
        want = jstores.PartitionStoreConfig(
            partitions_path=path, partition_idx=idx,
            distance_normalization=0.5).instantiate().distance_factors(jstate)
        got = tstores.PartitionStoreConfig(
            partitions_path=path, partition_idx=idx,
            distance_normalization=0.5).instantiate().distance_factors(tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert (got.numpy() == 0).any() and (got.numpy() > 1).any()
    assert tstores.VanillaStoreConfig().instantiate().distance_factors(
        tstate) is None
    assert jstores.VanillaStoreConfig().instantiate().distance_factors(
        jstate) is None


# ---- the LoD renderer -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convex_boxes_intersect_matches_jax(seed):
    rng = np.random.RandomState(seed)
    unit = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
                     [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64)
    a = unit * rng.uniform(1, 3, 3) + rng.uniform(-2, 2, 3)
    a[4:] = a[4:] * 1.5 - a[4:].mean(0) * 0.5      # a frustum-like prism
    boxes = unit[None] * rng.uniform(0.5, 2, (64, 1, 3)) \
        + rng.uniform(-4, 3, (64, 1, 3))
    got = tlod.convex_boxes_intersect(a, boxes)
    np.testing.assert_array_equal(got, jlod.convex_boxes_intersect(a, boxes))
    assert 0 < got.sum() < 64


def _write_ply_run(run_dir, arrays):
    save_gaussian_ply(os.path.join(run_dir, "point_cloud", "iteration_1",
                                   "point_cloud.ply"),
                      *(arrays[k] for k in ("means", "scales", "rotations",
                                            "opacities", "shs_dc",
                                            "shs_rest")))


def _cloud(n, centre, seed, k_rest=3, spread=0.8):
    rng = np.random.RandomState(seed)
    means = (rng.uniform(-spread, spread, (n, 3)) * [1.0, 0.3, 1.0]
             + centre).astype(np.float32)
    return dict(
        means=means,
        scales=np.log(rng.uniform(0.05, 0.15, (n, 3))).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(-1, 2, (n, 1)).astype(np.float32),
        shs_dc=rng.normal(scale=0.5, size=(n, 1, 3)).astype(np.float32),
        shs_rest=rng.normal(scale=0.1, size=(n, k_rest, 3)).astype(
            np.float32))


@pytest.fixture
def lod_scene(tmp_path):
    """Four partitions on a 2 x 2 grid of cells of size 2 in the x-z plane
    (y up), two levels of 48 and 12 rows; partition 3 has no coarse
    level, so it falls back to its fine one."""
    root = str(tmp_path / "parts")
    cells = [(-2.0, -2.0), (0.0, -2.0), (-2.0, 0.0), (0.0, 0.0)]
    tpart.PartitionedScene(
        config=tpart.SceneConfig(origin=np.zeros(2), partition_size=2.0),
        partitions=[tpart.Partition(
            ij=np.array([int(x // 2), int(z // 2)]),
            xy_min=np.array([x, z]), xy_max=np.array([x + 2.0, z + 2.0]),
            camera_mask=np.ones(4, bool)) for x, z in cells],
        rotation=np.eye(3)).save(os.path.join(root, "partitions.npz"))
    for pi, (x, z) in enumerate(cells):
        centre = np.array([x + 1.0, 0.0, z + 1.0])
        _write_ply_run(os.path.join(root, "lod0", f"partition_{pi:03d}"),
                       _cloud(48, centre, seed=pi))
        if pi != 3:
            _write_ply_run(os.path.join(root, "lod1", f"partition_{pi:03d}"),
                           _cloud(12, centre, seed=10 + pi))
    return root


def _lods(root, **kw):
    want = jlod.PartitionLoDConfig(
        data=root, names=("lod0", "lod1"), lod_distances=(0.75,),
        renderer=JaxRendererConfig(**JAX_RENDERER), **kw).instantiate()
    got = tlod.PartitionLoDConfig(
        data=root, names=("lod0", "lod1"), lod_distances=(0.75,),
        **kw).instantiate()
    return want.setup(), got.setup("cpu")


def _camera_path(n, seed):
    """Camera kwargs along a seeded fly-over of the lod_scene at heights
    1-6, each looking at a point of the ground."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pos = np.array([rng.uniform(-5, 5), -rng.uniform(1, 6),
                        rng.uniform(-5, 5)])
        R, T = _look_at(pos, [rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)])
        out.append(dict(R=R, T=T, fx=40.0, fy=40.0, cx=24.0, cy=16.0,
                        width=48, height=32))
    return out


@pytest.mark.parametrize("visibility_filter", [False, True])
def test_lod_selection_and_fallback_match_jax(lod_scene, visibility_filter):
    """Over a seeded camera path: the same levels, visibility and
    assembled row counts (partition 3's missing coarse level falls back to
    its fine one) as gsl_tpu's; the selection changes along the path."""
    jr, tr = _lods(lod_scene, visibility_filter=visibility_filter)
    keys = set()
    for kw in _camera_path(24, seed=7):
        jl_, jv = jr.select(jax_make_camera(**kw))
        tl_, tv = tr.select(make_camera(device="cpu", **kw))
        np.testing.assert_array_equal(tl_, jl_)
        np.testing.assert_array_equal(tv, jv)
        _, n_want = jr._assemble(jl_, jv)
        _, n_got = tr._assemble(tl_, tv)
        assert n_got == n_want
        keys.add((tuple(tl_), tuple(tv)))
    assert len(keys) >= 4
    assert any(k[0][3] == 1 for k in keys)      # the fallback was taken
    if visibility_filter:
        assert any(not all(k[1]) for k in keys)


def test_lod_frame_matches_jax(lod_scene):
    """One frame with partitions at both levels (and partition 3 on its
    fallback) within 1e-4 of gsl_tpu's XLA render; the assembly is reused
    while the selection holds and redone when it changes."""
    jr, tr = _lods(lod_scene)
    kw = dict(zip(("R", "T"), _look_at(np.array([-1.6, -3.0, -1.6]),
                                       [0.5, 0.0, 0.5])),
              fx=40.0, fy=40.0, cx=24.0, cy=16.0, width=48, height=32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout, jst = jr.forward(jax_make_camera(**kw), 32, 48, jnp.asarray(bg))
    cam = make_camera(device="cpu", **kw)
    tout, tst = tr.forward(cam, 32, 48, torch.from_numpy(bg))
    assert tst["partition_lods"].tolist() == [0, 1, 1, 1]
    assert tst["n_gaussians"] == jst["n_gaussians"] == 48 + 12 + 12 + 48
    np.testing.assert_allclose(tout.render.numpy(), np.asarray(jout.render),
                               rtol=1e-4, atol=1e-4)
    assert float(tout.render.std()) > 0.01
    state = tr._cached_state
    tr.forward(cam, 32, 48, torch.from_numpy(bg))
    assert tr._cached_state is state
    far = dict(kw, T=kw["T"] + np.array([0.0, 0.0, 9.0]))
    tr.forward(make_camera(device="cpu", **far), 32, 48,
               torch.from_numpy(bg))
    assert tr._cached_state is not state


def _overlapping_scene(root):
    """Two partitions (cells [-2, 0) and [0, 2) along x) whose models each
    reach over both cells, as train_partitions' fits of the whole cloud
    do."""
    tpart.PartitionedScene(
        config=tpart.SceneConfig(origin=np.zeros(2), partition_size=2.0),
        partitions=[tpart.Partition(
            ij=np.array([i - 1, 0]), xy_min=np.array([x, -1.0]),
            xy_max=np.array([x + 2.0, 1.0]), camera_mask=np.ones(2, bool))
            for i, x in enumerate((-2.0, 0.0))],
        rotation=np.eye(3)).save(os.path.join(root, "partitions.npz"))
    for pi in range(2):
        _write_ply_run(os.path.join(root, "lod0", f"partition_{pi:03d}"),
                       _cloud(64, [0.0, 0.0, 0.0], seed=40 + pi,
                              spread=1.8))


def test_lod_assembles_every_row_of_overlapping_partitions(tmp_path):
    """Where the partitions' models overlap, as train_partitions' fits of
    the whole cloud do, the frame assembles every alive row of both, as
    gsl_tpu's does, and matches it within 1e-4."""
    root = str(tmp_path / "parts")
    _overlapping_scene(root)
    kw = dict(zip(("R", "T"), _look_at(np.array([0.3, -3.0, -2.0]),
                                       [0.0, 0.0, 0.0])),
              fx=40.0, fy=40.0, cx=24.0, cy=16.0, width=48, height=32)
    want, jst = jlod.PartitionLoDConfig(
        data=root, names=("lod0",),
        renderer=JaxRendererConfig(**JAX_RENDERER)).instantiate().setup(
    ).forward(jax_make_camera(**kw), 32, 48, jnp.zeros(3))
    got, tst = tlod.PartitionLoDConfig(
        data=root, names=("lod0",)).instantiate().setup("cpu").forward(
            make_camera(device="cpu", **kw), 32, 48, torch.zeros(3))
    assert tst["n_gaussians"] == jst["n_gaussians"] == 128
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render),
                               rtol=1e-4, atol=1e-4)
    assert float(got.render.std()) > 0.01


def test_lod_capacity_overflow_raises(lod_scene):
    jr, tr = _lods(lod_scene, capacity=100)
    cam = dict(zip(("R", "T"), _look_at(np.array([-1.0, -0.5, -1.0]),
                                        [0.0, 0.0, 0.0])),
               fx=40.0, fy=40.0, cx=24.0, cy=16.0, width=48, height=32)
    lods, vis = tr.select(make_camera(device="cpu", **cam))
    assert lods.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="capacity 100"):
        tr.forward(make_camera(device="cpu", **cam), 32, 48, torch.zeros(3))
    with pytest.raises(ValueError, match="capacity 100"):
        jr.forward(jax_make_camera(**cam), 32, 48, jnp.zeros(3))
    assert tr.capacity == 100
    assert tlod.PartitionLoDConfig(
        data=lod_scene, names=("lod0",)).instantiate().setup(
            "cpu").capacity == 1024
