"""A training run's late stretch, the kind of the mixes whose `kind` is
``train``: its run, its reference, what `correct` compares and the scene
its work is counted on.

The reference follows the first `checked_steps` steps that the run's
set-up took through the window's own call and feed. Compared, each by
its worst case: each step's loss (`loss_gap`, relative), the first
gradient as Adam received it (the program's worked out from its first
moment after one step, mu / (1 - b1)) by the worst leaf (`grad_gap`), and
the parameters' change over the checked steps by the worst leaf
(`change_gap`). A leaf's gap is |norm(program) - norm(reference)| over
the larger of the reference's norm of that leaf and of the median leaf;
a leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of `change_gap`.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import harness, scene
from ..check import camera_extent, leaf_gap, norms, reference_camera
from ..program import (GIB, Outcome, build_trainer, host_delta, host_times,
                       launches, launches_since, peak, reset_peak, sync)
from ..reference import model

# the reference's own faults, for calibrate.py: the loss over the image's
# first half of rows only
FAULTS = ("half_rows",)


def write_ppm(path: str, img: np.ndarray) -> None:
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img).tobytes())


def start_scene(cell, seed: int, device) -> dict:
    """The state the stretch starts from: the scene perturbed by the
    seed."""
    return scene.perturb(harness.renderer(cell).draw_scene(
        cell.config, seed, device), cell.traffic["perturb"], seed, device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    """Steps from `start_step` on of the configuration's schedule through
    the fit loop's per-step path: `DataLoader` over a `CachedDataset`
    whose cache is filled before the window, the image uploaded and
    converted by `image_to_float`, the fit's step hook (`train_step`),
    the plugins, the density hooks (`maybe_density_ops`)."""
    from gsl_tpu_torch.data.dataparsers.dataparser import (
        DataParserOutputs, ImageSet, PointCloud, cameras_from_numpy,
        camera_centers, compute_camera_extent)
    from gsl_tpu_torch.data.dataset import (CachedDataset, DataLoader,
                                            image_to_float)
    from gsl_tpu_torch.training.fit import setup_state
    from gsl_tpu_torch.training.hooks import FitContext, build_hooks

    cfg, mix = cell.config, cell.traffic
    rend = harness.renderer(cell)
    trainer, fit_cfg = build_trainer(cfg)
    workdir = tempfile.mkdtemp(prefix="port_bench_")
    loader = None
    try:
        arrays = start_scene(cell, seed, device)
        gstate = rend.program_state(arrays, device)
        del arrays
        cams = scene.rig(cfg)
        views = scene.train_views(cfg)
        H, W = cfg["height"], cfg["width"]
        draws = scene.target_draws(cfg, mix, seed, len(views), device)
        names, paths = [], []
        for j, v in enumerate(views):
            names.append(f"view_{v:04d}")
            paths.append(os.path.join(workdir, f"view_{v:04d}.ppm"))
            write_ppm(paths[-1], scene.target(draws, j, H, W).cpu().numpy())
        del draws
        sel = [cams[v] for v in views]
        stack = {k: np.stack([c[k] for c in sel]) for k in
                 ("R", "T", "fx", "fy", "cx", "cy", "width", "height")}
        image_set = ImageSet(image_names=names, image_paths=paths,
                             cameras=cameras_from_numpy(**stack))
        empty = ImageSet(image_names=[], image_paths=[],
                         cameras=cameras_from_numpy(**{
                             k: v[:0] for k, v in stack.items()}))
        outputs = DataParserOutputs(
            train_set=image_set, val_set=empty, test_set=empty,
            point_cloud=PointCloud(xyz=np.zeros((0, 3), np.float32),
                                   rgb=np.zeros((0, 3), np.float32)),
            camera_extent=compute_camera_extent(
                camera_centers(image_set.cameras)))
        background = np.asarray(trainer.config.background_color, np.float32)
        bg = torch.from_numpy(background).to(device)
        dataset = CachedDataset(image_set, background=background)
        # the first epoch's decodes, as a user's first epoch fills the
        # cache, before the window
        with ThreadPoolExecutor(mix["cache_fill_threads"]) as ex:
            list(ex.map(dataset.get, range(len(dataset))))

        state = setup_state(trainer, outputs, gstate)
        start = mix["start_step"]
        state = dataclasses.replace(
            state, step=start,
            opt_state=dataclasses.replace(state.opt_state, count=start))
        generator = torch.Generator(device=device)
        generator.manual_seed(scene.derived_seed(seed, 5))
        ctx = FitContext(trainer=trainer, outputs=outputs, dataset=dataset,
                         cfg=fit_cfg, bg=bg, name_to_idx={
                             n: i for i, n in enumerate(names)})
        step_hook, density_hook, pre, post = build_hooks(
            ctx, state.gaussians.n_alive)
        state = step_hook.init_state(state, generator)
        loader = iter(DataLoader(dataset, seed=seed % (2 ** 32)))
        cameras = {}
        host = {"loader_wait_s": 0.0, "dispatch_s": 0.0}
        served = []

        # fit()'s loop body without its viewer, log and checkpoint steps;
        # tests/test_port_bench_fit_order.py holds the two to one order
        def step_once(state, step):
            t0 = time.perf_counter()
            cam, name, img_u8, mask = next(loader)
            t1 = time.perf_counter()
            host["loader_wait_s"] += t1 - t0
            if name not in cameras:
                cameras[name] = cam.to(device)
            img = image_to_float(img_u8.to(device))
            mask = None if mask is None else mask.to(device)
            h, w = img.shape[:2]
            t2 = time.perf_counter()
            state, scalars = step_hook(state, generator, step,
                                       trainer.sh_degree_at(step),
                                       cameras[name], name, img, mask, h, w)
            host["dispatch_s"] += time.perf_counter() - t2
            for plugin in trainer.plugins:
                state = plugin.after_step(state, step)
            for hook in pre:
                state = hook.periodic(state, generator, step)
            state = density_hook(state, generator, step)
            for hook in post:
                state = hook.periodic(state, generator, step)
            served.append(name)
            return state, scalars

        # the first steps, through the window's own call and feed; the
        # reference follows them (`reference`, below)
        state0 = state.params
        step = start
        losses = []
        for i in range(mix["checked_steps"]):
            step += 1
            state, scalars = step_once(state, step)
            losses.append(float(scalars["loss"]))
            if i == 0:
                g1 = norms({k: v / (1.0 - 0.9) for k, v in
                             state.opt_state.exp_avg.items()})
        change = norms({k: getattr(state.params, k) - getattr(state0, k)
                         for k in state.params.fields()})
        readings = {"losses": losses, "grad_norms": g1,
                    "change_norms": change,
                    "views": list(served)}
        del state0
        for _ in range(mix["warmup_steps"]):
            step += 1
            state, _ = step_once(state, step)
        traced, items = None, []
        if trace:
            # traced before the window: work/ counts the starting state,
            # and the state drifts through the window (PERF.md)
            from .. import trace as tr
            first = len(served)
            holder = {"state": state, "step": step}

            def traced_step(i):
                holder["step"] += 1
                holder["state"], _ = step_once(holder["state"],
                                               holder["step"])
            traced = tr.profile(traced_step, mix["traced_steps"])
            items = served[first:]
            state, step = holder["state"], holder["step"]
        sync(device)
        setup_peak = peak(device)
        reset_peak(device)

        host.update(loader_wait_s=0.0, dispatch_s=0.0)
        n = 0
        before, host0 = launches(), host_times()
        t_open = time.perf_counter()
        setup_s = t_open - t_process
        while time.perf_counter() - t_open < seconds:
            step += 1
            state, _ = step_once(state, step)
            n += 1
        sync(device)
        window = time.perf_counter() - t_open
        window_peak = peak(device)
        host.update(window_s=window, items=n, launches=launches_since(before),
                    **host_delta(host0))
        metrics = {"setup_s": setup_s,
                   "train_step_ms": 1e3 * window / n,
                   "peak_mem_gib": window_peak / GIB}
        view_of = dict(zip(names, views))
        return Outcome(
            metrics=metrics, host=host, readings=readings,
            items=[view_of[nm] for nm in items], trace=traced,
            attempted=n, failed=0,
            memory_peak_bytes=max(setup_peak, window_peak),
            info={"views_checked": [view_of[nm] for nm in readings["views"]],
                  "camera_extent": outputs.camera_extent})
    finally:
        if loader is not None:
            loader.close()
        shutil.rmtree(workdir, ignore_errors=True)


def reference(cell, seed: int, device, readings=None,
              precision: str = "float32", fault: str = None) -> dict:
    """The reference's readings of the checked steps, as the program's:
    losses, the first gradient's norms and the change's norms by leaf."""
    cfg, mix = cell.config, cell.traffic
    rend = harness.renderer(cell)
    prec = model.Precision(precision)
    params = start_scene(cell, seed, device)
    cams = scene.rig(cfg)
    views = scene.train_views(cfg)
    extent = camera_extent([cams[v] for v in views])
    order = np.random.RandomState(seed % (2 ** 32)).permutation(len(views))
    draws = scene.target_draws(cfg, mix, seed, len(views), device)
    H, W = cfg["height"], cfg["width"]
    bg = torch.tensor(cfg["background"], dtype=torch.float32, device=device)
    rows = slice(0, H // 2) if fault == "half_rows" else None
    p0 = params
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = mix["start_step"]
    losses, g1 = [], None
    for i in range(mix["checked_steps"]):
        j = int(order[i])
        gt = scene.target(draws, j, H, W).to(torch.float32) / 255.0
        cam = reference_camera(cams[views[j]], device)
        loss, grads, params, mu, nu = rend.train_step(
            cfg, params, mu, nu, count, cam, gt, bg, extent, prec, rows)
        count += 1
        losses.append(loss)
        if i == 0:
            g1 = norms(grads)
        del grads
    change = norms({k: params[k] - p0[k] for k in params})
    return {"losses": losses, "grad_norms": g1, "change_norms": change,
            "views": [views[int(j)] for j in order[:mix["checked_steps"]]]}


def numbers(readings: dict, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(readings["losses"], ref["losses"]))
    leaves = sorted(ref["grad_norms"])
    med = float(np.median([ref["grad_norms"][k] for k in leaves]))
    moving = [k for k in leaves if ref["grad_norms"][k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(readings["grad_norms"], ref["grad_norms"],
                                 leaves),
            "change_gap": leaf_gap(readings["change_norms"],
                                   ref["change_norms"], moving)}


def counted_scene(cell, seed: int, device):
    """The scene and the camera of each view, as the work is counted."""
    rig = scene.rig(cell.config)
    return start_scene(cell, seed, device), lambda v: rig[v]


def parts(cell, c: dict) -> dict:
    return harness.renderer(cell).step_parts(cell.config, c)


def describe(cell, seed: int, device) -> dict:
    """The work of the first training view, for the configuration's
    record of its depth complexity."""
    params, camera_of = counted_scene(cell, seed, device)
    cam = camera_of(scene.train_views(cell.config)[0])
    return harness.renderer(cell).view_counts(
        cell.config, params, reference_camera(cam, device))
