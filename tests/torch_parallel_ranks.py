"""Rank-side helpers of the distributed tests: module-level functions that
the spawned ranks import and run. Only torch and gsl_tpu_torch here (no
JAX), so a rank starts quickly; inputs and results are numpy."""
import dataclasses

import numpy as np
import torch

from gsl_tpu_torch.data.cameras import make_camera
from gsl_tpu_torch.models.gaussian import GaussianState, OptimizationConfig
from gsl_tpu_torch.parallel.gaussian_sharded import (
    exchange, gather_params, gather_rows, make_mesh,
    make_mp_train_step, shard_params, shard_rows)
from gsl_tpu_torch.training.density import (VanillaDensityControllerConfig,
                                            densify_and_prune,
                                            init_density_state)
from gsl_tpu_torch.training.optimizers import GaussianAdam
from gsl_tpu_torch.utils.convert import train_state_from_jax_arrays

torch.set_num_threads(1)


def port_camera(c: dict, device="cpu"):
    """A camera from numpy fields R, T, fx, fy, cx, cy, width, height."""
    return make_camera(R=c["R"], T=c["T"], fx=c["fx"], fy=c["fy"],
                       cx=c["cx"], cy=c["cy"], width=int(c["width"]),
                       height=int(c["height"]), device=device)


def train_state(state: dict, device="cpu"):
    """The port TrainState of {"params", "alive", "opt"} numpy arrays."""
    cap = state["alive"].shape[0]
    zeros = np.zeros(cap, np.float32)
    return train_state_from_jax_arrays(
        state["params"], state["alive"], state["opt"],
        {"grad_accum": zeros, "denom": zeros, "max_radii": zeros}, 0,
        device=device)


def _launches():
    from gsl_tpu_torch.ops import rasterize as R
    return {k: getattr(R, k).launches for k in (
        "expand", "rasterize_fwd", "rasterize_bwd", "reduce_grads")}


def _np(x):
    return x.detach().cpu().numpy()


def sharded_step(dp, mp, state, cams, gts, masks, bg, H, W, sh_degree,
                 compact_k=None, device="cpu"):
    """One sharded step on this rank; returns the gathered global results
    (every rank of a dp row holds them)."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp * mp, dp=dp, mp=mp, device=device)
    dev = mesh.device
    ts = train_state(state, dev)
    tx = GaussianAdam(OptimizationConfig(), 1.0)
    params, alive, opt = shard_params(mesh, ts.params, ts.alive,
                                      ts.opt_state)
    j = mesh.dp_index * mesh.mp + mesh.mp_index
    step = make_mp_train_step(mesh, tx, H, W, sh_degree,
                              compact_k=compact_k,
                              with_masks=masks is not None)
    extra = () if masks is None else (torch.from_numpy(masks[j]).to(dev),)
    mesh.stats.reset()
    before = _launches()
    params, opt, loss, tap, radii, n_ovf = step(
        params, alive, opt, port_camera(cams[j], dev),
        torch.from_numpy(gts[j]).to(dev), *extra,
        torch.from_numpy(bg).to(dev))
    gp, ga, go = gather_params(mesh, params, alive, opt)
    return {"loss": float(loss), "n_overflow": int(n_ovf),
            "params": {k: _np(getattr(gp, k)) for k in gp.fields()},
            "mu": {k: _np(v) for k, v in go.exp_avg.items()},
            "nu": {k: _np(v) for k, v in go.exp_avg_sq.items()},
            "tap": _np(gather_rows(mesh, tap)),
            "radii": _np(gather_rows(mesh, radii)),
            "exchange": mesh.stats.snapshot(),
            "launches": {k: v - before[k] for k, v in _launches().items()}}


def exchange_grad(mp, blocks, weights):
    """sum(weights[rank] * exchange(blocks[rank])) on each rank; returns the
    rank's exchanged blocks and the gradient at its input."""
    torch.set_num_threads(1)
    mesh = make_mesh(mp, dp=1, mp=mp, device="cpu")
    x = torch.from_numpy(blocks[mesh.rank]).requires_grad_(True)
    y = exchange(mesh, x)
    (y * torch.from_numpy(weights[mesh.rank])).sum().backward()
    return _np(y), _np(x.grad)


def sharded_densify(dp, mp, state, grad_accum, denom, seed):
    """Densify the global state gathered from the shards, as fit_distributed
    does; returns every rank's gathered result."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp * mp, dp=dp, mp=mp, device="cpu")
    ts = train_state(state)
    params, alive, opt = shard_params(mesh, ts.params, ts.alive,
                                      ts.opt_state)
    dens = init_density_state(ts.alive.shape[0])
    dens = dataclasses.replace(dens, grad_accum=torch.from_numpy(grad_accum),
                               denom=torch.from_numpy(denom))
    dens = type(dens)(**{f.name: shard_rows(mesh, getattr(dens, f.name))
                         for f in dataclasses.fields(dens)})
    gp, ga, go = gather_params(mesh, params, alive, opt)
    gd = type(dens)(**{f.name: gather_rows(mesh, getattr(dens, f.name))
                       for f in dataclasses.fields(dens)})
    gen = torch.Generator().manual_seed(seed)
    out, _, _, _ = densify_and_prune(
        gen, GaussianState(params=gp, alive=ga), go, gd,
        VanillaDensityControllerConfig(), 1.0, 100.0, False)
    return {"alive": _np(out.alive),
            "means": _np(out.params.means), "scales": _np(out.params.scales)}


def dist_outputs(root, sizes, seed=0):
    """tests/test_parallel.py::_dist_dataset for the port: random PNGs of
    the given (h, w) under `root`, cameras along x looking down +z, 200
    random points; the train set is also the val and test set."""
    import os
    from PIL import Image
    from gsl_tpu_torch.data.cameras import Cameras
    from gsl_tpu_torch.data.dataparsers.dataparser import (
        DataParserOutputs, ImageSet, PointCloud)
    rng = np.random.RandomState(seed)
    names, paths = [], []
    fields = {k: [] for k in ("R", "T", "fx", "fy", "cx", "cy", "width",
                              "height")}
    for i, (h, w) in enumerate(sizes):
        name = f"i{i}.png"
        p = os.path.join(root, name)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        names.append(name)
        paths.append(p)
        for k, v in (("R", np.eye(3)), ("T", [0.05 * i, 0.0, 3.0]),
                     ("fx", 40.0), ("fy", 40.0), ("cx", w / 2),
                     ("cy", h / 2), ("width", w), ("height", h)):
            fields[k].append(v)
    cams = Cameras(**{k: torch.tensor(
        np.asarray(v), dtype=torch.int32 if k in ("width", "height")
        else torch.float32) for k, v in fields.items()})
    train = ImageSet(image_names=names, image_paths=paths, cameras=cams)
    return DataParserOutputs(
        train_set=train, val_set=train, test_set=train,
        point_cloud=PointCloud(
            xyz=rng.rand(200, 3).astype(np.float32) * 2 - 1,
            rgb=rng.rand(200, 3).astype(np.float32)),
        camera_extent=1.0)


def dist_trainer(densification_interval=5):
    """tests/test_parallel.py::_dist_trainer for the port."""
    from gsl_tpu_torch.models.gaussian import VanillaGaussianConfig
    from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
    return Trainer(
        model=VanillaGaussianConfig(sh_degree=0),
        density=VanillaDensityControllerConfig(
            densify_from_iter=2,
            densification_interval=densification_interval,
            densify_until_iter=30, densify_grad_threshold=1e-9,
            opacity_reset_interval=10000),
        config=TrainerConfig())


def fit_rank(dp, mp, outputs, fit_kwargs, densification_interval=5,
             val_at_end=True):
    """fit_distributed on this rank; returns (alive count of the final
    state, the validation results)."""
    from gsl_tpu_torch.parallel.fit_distributed import fit_distributed
    from gsl_tpu_torch.training.fit import FitConfig
    torch.set_num_threads(1)
    mesh = make_mesh(dp * mp, dp=dp, mp=mp, device="cpu")
    final, results = fit_distributed(
        dist_trainer(densification_interval), outputs,
        FitConfig(**fit_kwargs), mesh=mesh, val_at_end=val_at_end)
    return int(final.alive.sum()), final.step, results


def fail_first_on_rank_two():
    """Rank 2 raises at once but lingers at exit; the others raise a moment
    later, as ranks do whose peer is gone, and leave first."""
    import atexit
    import time
    import torch.distributed as dist
    if dist.get_rank() == 2:
        atexit.register(time.sleep, 2.0)
        raise ValueError("rank two could not read its image")
    time.sleep(0.5)
    raise RuntimeError(f"rank {dist.get_rank()}: a peer is gone")
