"""The generator makes every input from the seed: the same seed gives the
same inputs, another seed other draws of the same work."""
import copy

import numpy as np
import pytest
import torch

from port_bench import harness, scene

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (5, 2 ** 31 + 17)


def tiny(cell_name):
    cell = harness.resolve(BENCH, cell_name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(n_gaussians=4000, width=64, height=40, views=12)
    return cfg, copy.deepcopy(cell.traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_scene_is_a_function_of_the_seed(cell):
    cfg, mix = tiny(cell)
    a = scene.draw_scene(cfg, SEEDS[1], "cpu")
    b = scene.draw_scene(cfg, SEEDS[1], "cpu")
    c = scene.draw_scene(cfg, SEEDS[0], "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    if mix["kind"] == "train":
        pa = scene.perturb(a, mix["perturb"], SEEDS[1], "cpu")
        pb = scene.perturb(b, mix["perturb"], SEEDS[1], "cpu")
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert not torch.equal(pa["means"], a["means"])
        assert torch.equal(pa["scales"], a["scales"])


def test_the_layout_and_the_rig_do_not_change_with_the_seed():
    cfg, _ = tiny(CELLS[0])
    # the blob centres: every seed's means cluster around the same points
    a = scene.draw_scene(cfg, SEEDS[0], "cpu")["means"]
    b = scene.draw_scene(cfg, SEEDS[1], "cpu")["means"]
    assert torch.allclose(a.mean(0), b.mean(0), atol=0.05)
    r1, r2 = scene.rig(cfg), scene.rig(cfg)
    assert all(np.array_equal(x["R"], y["R"]) for x, y in zip(r1, r2))
    assert len(scene.train_views(cfg)) == 12 - 2


def test_targets_are_a_function_of_the_seed():
    cfg, mix = tiny("train_vanilla_bicycle")
    d1 = scene.target_draws(cfg, mix, SEEDS[0], 3, "cpu")
    d2 = scene.target_draws(cfg, mix, SEEDS[0], 3, "cpu")
    d3 = scene.target_draws(cfg, mix, SEEDS[1], 3, "cpu")
    t1 = scene.target(d1, 2, cfg["height"], cfg["width"])
    assert t1.dtype == torch.uint8 and t1.shape == (40, 64, 3)
    assert torch.equal(t1, scene.target(d2, 2, cfg["height"], cfg["width"]))
    assert not torch.equal(t1, scene.target(d3, 2, cfg["height"],
                                            cfg["width"]))


def test_viewer_poses_serve_the_same_stations_in_a_seeded_order():
    cfg, mix = tiny("render_vanilla_bicycle")
    a = scene.viewer_poses(cfg, mix, SEEDS[0])
    b = scene.viewer_poses(cfg, mix, SEEDS[0])
    c = scene.viewer_poses(cfg, mix, SEEDS[1])
    assert len(a) == mix["stations"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # one pose per station, jittered within it
    spacing = 360.0 / mix["stations"]
    for poses in (a, c):
        yaw = np.sort([np.degrees(np.arctan2(p[0, 3], -p[2, 3])) % 360
                       for p in poses])
        assert np.all(np.diff(yaw) > 0) and np.diff(yaw).max() < 2 * spacing
