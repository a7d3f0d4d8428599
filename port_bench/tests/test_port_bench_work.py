"""The work counts against a pixel-by-pixel walk on a tiny scene, and the
least-time arithmetic."""
import math

import pytest
import torch

from port_bench import scene
from port_bench.reference import model, raster
from port_bench.work import PEAKS, counts, least_time


def tiny_scene(n=1500, seed=3):
    """Dense enough that most pixels meet their transmittance stop."""
    cfg = {"n_gaussians": n, "scene": {
        "layout_seed": 0, "blobs_per_million": 60, "box_half_per_million": 1.5,
        "blob_sigma": 0.15, "log_scale": [-1.5, -0.5],
        "logit_opacity": [1.0, 4.0], "shs_dc_std": 0.8,
        "shs_rest_std": 0.15}}
    params = scene.draw_scene(cfg, seed, "cpu")
    params["means"] = params["means"] * 10.0     # spread over the frame
    return params


def camera(W=40, H=24):
    R = torch.eye(3).numpy()
    return model.camera(R, [0.0, 0.0, 8.0], 30.0, 30.0, W / 2, H / 2, W, H,
                        "cpu")


def walk(params, cam, stp):
    """Per pixel, slot by slot, sequentially."""
    H, W = cam["height"], cam["width"]
    proj = model.project(params["means"], torch.exp(params["scales"]),
                         model.normalize_quat(params["rotations"]), cam,
                         model.Precision())
    op = torch.sigmoid(params["opacities"][:, 0]) * proj["compensations"]
    tx, ty = raster.tiles_of(H, W, 16)
    off, rect, total, _ = raster.isect_encode(proj["means2d"], proj["conics"],
                                              proj["radii"], H, W, 16)
    keys, gids = raster.expand(off, rect, total, proj["means2d"],
                               proj["conics"], op, proj["depths"], tx, ty, 16,
                               stp, proj["depth_grads"])
    g, b = raster.sort_and_bound(keys, gids, tx * ty)
    visited = composited = stopped = 0
    for y in range(H):
        for x in range(W):
            t = (y // 16) * tx + x // 16
            T = 1.0
            for k in range(int(b[t]), int(b[t + 1])):
                i = int(g[k])
                dx = float(proj["means2d"][i, 0]) - (x + 0.5)
                dy = float(proj["means2d"][i, 1]) - (y + 0.5)
                a_, b_, c_ = proj["conics"][i].tolist()
                sigma = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
                alpha = min(float(op[i]) * math.exp(-sigma), 0.999)
                visited += 1
                if sigma < 0 or alpha < 1 / 255:
                    continue
                if not stp and T * (1 - alpha) <= 1e-4:
                    stopped += 1
                    break
                composited += 1
                T *= 1 - alpha
    return visited, visited - stopped, composited


@pytest.mark.parametrize("stp", [False, True])
def test_pair_counts_match_a_pixel_by_pixel_walk(stp):
    params, cam = tiny_scene(), camera()
    c = counts.view_counts(params, cam, stp)
    visited, before, composited = walk(params, cam, stp)
    assert c["pixels"] == 40 * 24 and c["tiles"] == 3 * 2
    assert c["visited"] == visited
    assert c["composited"] == composited
    assert c["before_stop"] == (before if not stp else visited)
    assert 0 < c["visible"] <= c["rows"] and c["valid_slots"] <= c["slots"]
    assert stp or 0 < before < visited      # some pixels stop


def test_a_part_takes_the_larger_of_its_two_bounds():
    p = least_time.part(67e12, 1.0)
    assert p["bound"] == "operations" and p["s"] == pytest.approx(1.0)
    p = least_time.part(1.0, PEAKS["bytes_per_s"] * 2)
    assert p["bound"] == "bytes" and p["s"] == pytest.approx(2.0)


def test_step_parts_add_the_backward_and_adam_to_the_frame():
    params, cam = tiny_scene(), camera()
    for stp in (False, True):
        c = counts.view_counts(params, cam, stp)
        frame = least_time.totals(least_time.frame_parts(c, stp))
        step = least_time.totals(least_time.step_parts(c, stp))
        assert 0 < frame["kernels_s"] < step["kernels_s"] < step["all_s"]
        assert frame["kernels_s"] < frame["all_s"]
        parts = least_time.step_parts(c, stp)
        assert ("K3s" in parts) == stp and ("K2s" in parts) == stp
        assert parts["adam"]["s"] == pytest.approx(
            c["rows"] * 59 * 28 / PEAKS["bytes_per_s"])
