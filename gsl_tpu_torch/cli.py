"""CLI: ``python -m gsl_tpu_torch.cli fit|validate|test --config x.yaml``.

Port of ``gsl_tpu/cli.py``: YAML presets select component classes by
``class_path`` / ``init_args`` and set hyperparameters; later configs and
``key=value`` overrides win over earlier ones; ``-n/--name`` builds the
output dir; ``fit`` snapshots the resolved config into it, and
``validate`` / ``test`` load that snapshot first and then the newest
checkpoint. ``--device`` (default ``cuda``) picks where it runs.

The same YAML files drive both packages. Fields that exist only for the
TPU (`TPU_ONLY_FIELDS`) are accepted and ignored with one printed line.
Components, fields and keys of variants the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item; any other unknown field
raises ``KeyError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
from typing import Any, Dict

import yaml

from .data.dataparsers.blender import BlenderDataParserConfig
from .data.dataparsers.colmap import ColmapDataParserConfig
from .models.gaussian import VanillaGaussianConfig
from .models.gaussian_2d import Gaussian2DConfig
from .renderers.surfel_renderer import SurfelRendererConfig
from .renderers.tile_renderer import TileRendererConfig
from .training.density import VanillaDensityControllerConfig
from .training.fit import FitConfig, _round_capacity, fit, validate
from .training.gs2d import GS2DMetricsConfig, GS2DTrainer
from .training.metrics import VanillaMetricsConfig
from .training.trainer import Trainer, TrainerConfig
from .utils.checkpoint import find_latest_checkpoint, load_checkpoint
from .utils.device import resolve_device

_REGISTRY = {
    "VanillaGaussian": VanillaGaussianConfig,
    "Gaussian2D": Gaussian2DConfig,
    "TileRenderer": TileRendererConfig,
    "SurfelRenderer": SurfelRendererConfig,
    "VanillaDensityController": VanillaDensityControllerConfig,
    "VanillaMetrics": VanillaMetricsConfig,
    "GS2DMetrics": GS2DMetricsConfig,
    "Colmap": ColmapDataParserConfig,
    "Blender": BlenderDataParserConfig,
}

# components of gsl_tpu's registry that the port has not yet -> ROADMAP item
_UNPORTED_COMPONENTS = {
    "MipSplatting": 7, "MipSplattingRenderer": 7,
    "MCMCDensityController": 8, "MCMCMetrics": 8,
    "DepthMetrics": 9, "EstimatedDepthColmap": 9,
    "NSVF": 12, "PhotoTourism": 12, "MatrixCity": 12, "Nerfies": 12,
    "SegAnyColmap": 12, "NGP": 12, "AppearanceFeatureGaussian": 12,
    "SpotLessColmap": 12, "SpotLessMetrics": 12,
    "StaticDensityController": 12, "RevisingDensityController": 12,
    "NoCullingBigScaleDC": 12, "H3DGSDensityController": 12,
    "AccurateVisibilityFilterDensityController": 12,
    "BackgroundRemoval": 12, "GNS": 12, "Feature3DGSColmap": 12,
    "SILVR": 12, "PVG": 12, "PVGRenderer": 12,
}

# fields of gsl_tpu's configs that exist for the TPU's static shapes, its
# matrix unit or its sort; the port has no knob for them
TPU_ONLY_FIELDS = ("backend", "chunk", "pallas_chunk", "max_per_tile",
                   "min_isect_capacity", "isect_capacity_factor",
                   "fast_math", "exact_sort", "matmul_precision",
                   "size_bucket")

# fields of gsl_tpu's FitConfig for features not ported yet -> ROADMAP item
_UNPORTED_FIT_FIELDS = {"viewer": 14, "viewer_port": 14,
                        "lg_prune_steps": 12, "lg_prune_percent": 12,
                        "lg_prune_decay": 12, "lg_n_cameras": 12}

# top-level / model keys gsl_tpu's build_components reads for variants
_UNPORTED_KEYS = {"distributed": 13, "opt_strategy": 12,
                  "output_processor": 12, "glossy": 12, "deform": 12,
                  "plugins": 12, "swag": 12, "similarity_reg": 12,
                  "visibility_map": 12, "n_appearances": 12}


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to gsl_tpu_torch yet (ROADMAP item {item})")


def _resolve_class(path: str):
    if path in _REGISTRY:
        return _REGISTRY[path]
    if path in _UNPORTED_COMPONENTS:
        raise _not_ported(path, _UNPORTED_COMPONENTS[path])
    if "." in path:
        mod, name = path.rsplit(".", 1)
        return getattr(importlib.import_module(mod), name)
    raise KeyError(f"unknown component {path!r}; known: {list(_REGISTRY)}")


def _build(cfg_cls, spec: Any):
    """Build a config dataclass from a YAML dict, supporting
    class_path/init_args subclass swaps and nested dataclass fields (e.g.
    model.gaussian.optimization)."""
    if spec is None:
        return cfg_cls()
    if isinstance(spec, dict) and ("class_path" in spec
                                   or "init_args" in spec):
        if "class_path" in spec:
            cfg_cls = _resolve_class(spec["class_path"])
        spec = spec.get("init_args", {}) or {}
    inst = cfg_cls()
    field_names = {f.name for f in dataclasses.fields(cfg_cls)}
    for k, v in (spec or {}).items():
        if k not in field_names:
            if cfg_cls is FitConfig and k in _UNPORTED_FIT_FIELDS:
                raise _not_ported(f"fit.{k}", _UNPORTED_FIT_FIELDS[k])
            if k in TPU_ONLY_FIELDS:
                print(f"[cli] ignoring the TPU-only field {k}={v!r} of "
                      f"{cfg_cls.__name__}")
                continue
            raise KeyError(f"unknown field {k!r} for {cfg_cls.__name__}")
        cur = getattr(inst, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            setattr(inst, k, _build(type(cur), v))
        else:
            setattr(inst, k, v)
    return inst


def _deep_update(base: Dict, new: Dict) -> Dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(config_paths, overrides: Dict) -> Dict:
    merged: Dict = {}
    for p in config_paths or []:
        with open(p) as f:
            _deep_update(merged, yaml.safe_load(f) or {})
    _deep_update(merged, overrides)
    return merged


def parse_overrides(pairs) -> Dict:
    out: Dict = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        val = yaml.safe_load(val)
        node = out
        parts = key.lstrip("-").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def build_components(cfg: Dict):
    """-> (trainer, dataparser config, FitConfig)."""
    model_spec = cfg.get("model", {})
    for key, item in _UNPORTED_KEYS.items():
        if cfg.get(key) or model_spec.get(key):
            raise _not_ported(f"the {key!r} key", item)

    data_spec = cfg.get("data", {})
    parser_spec = data_spec.get("parser", {"class_path": "Colmap"})
    if isinstance(parser_spec, str):
        parser_spec = {"class_path": parser_spec}
    if "path" in data_spec:
        parser_spec.setdefault("init_args", {})["path"] = data_spec["path"]
    dataparser_cfg = _build(ColmapDataParserConfig, parser_spec)

    model = _build(VanillaGaussianConfig, model_spec.get("gaussian"))
    renderer = _build(TileRendererConfig, model_spec.get("renderer"))
    density = _build(VanillaDensityControllerConfig,
                     model_spec.get("density"))
    metrics = _build(VanillaMetricsConfig, model_spec.get("metric"))
    trainer_cfg = _build(TrainerConfig, cfg.get("trainer"))
    fit_cfg = _build(FitConfig, cfg.get("fit"))

    trainer_cls = (GS2DTrainer if isinstance(metrics, GS2DMetricsConfig)
                   else Trainer)
    trainer = trainer_cls(model=model, renderer=renderer, density=density,
                          metrics=metrics, config=trainer_cfg)
    return trainer, dataparser_cfg, fit_cfg


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch")
    ap.add_argument("subcommand", choices=["fit", "validate", "test"])
    ap.add_argument("--config", action="append", default=[])
    ap.add_argument("--data.path", dest="data_path", default=None)
    ap.add_argument("-n", "--name", default="run")
    ap.add_argument("--output", default="outputs")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--viewer", action="store_true",
                    help="the in-training web viewer (not ported yet)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("set", nargs="*", help="key=value overrides")
    # key=value overrides may come before, between or after the options
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    if args.viewer:
        raise _not_ported("--viewer", 14)

    overrides = parse_overrides(args.set)
    config_paths = list(args.config)
    if args.subcommand in ("validate", "test"):
        # the run's own config snapshot first, so the model matches the
        # checkpoint
        snap = os.path.join(args.output, args.name, "config.yaml")
        if os.path.exists(snap):
            config_paths = [snap] + config_paths
    cfg = load_config(config_paths, overrides)
    if args.data_path:
        cfg.setdefault("data", {})["path"] = args.data_path
    if args.max_steps:
        cfg.setdefault("fit", {})["max_steps"] = args.max_steps
        cfg.setdefault("trainer", {})["max_steps"] = args.max_steps
    cfg.setdefault("fit", {}).setdefault(
        "output_dir", os.path.join(args.output, args.name))
    cfg["fit"]["seed"] = args.seed

    trainer, dataparser_cfg, fit_cfg = build_components(cfg)
    outputs = dataparser_cfg.instantiate().get_outputs()

    if args.subcommand == "fit":
        os.makedirs(fit_cfg.output_dir, exist_ok=True)
        with open(os.path.join(fit_cfg.output_dir, "config.yaml"),
                  "w") as f:
            yaml.safe_dump(cfg, f)
        state, results = fit(trainer, outputs, fit_cfg, device=device)
        if results:
            print(f"val: psnr={results['psnr']:.3f} "
                  f"ssim={results['ssim']:.4f}")
        return state, results

    ckpt = find_latest_checkpoint(
        os.path.join(fit_cfg.output_dir, "checkpoints"))
    if ckpt is None:
        raise FileNotFoundError("no checkpoint found")
    pc = outputs.point_cloud
    capacity = _round_capacity(max(
        int(pc.xyz.shape[0] * fit_cfg.capacity_multiplier),
        fit_cfg.min_capacity))
    template = trainer.setup(
        trainer.model.init_from_pcd(pc.xyz, pc.rgb, capacity, device),
        outputs.camera_extent)
    state = load_checkpoint(ckpt, template)
    split = "val" if args.subcommand == "validate" else "test"
    results = validate(trainer, state, outputs, fit_cfg, split=split,
                       save_images=True)
    print(f"{split}: psnr={results['psnr']:.3f} "
          f"ssim={results['ssim']:.4f}")
    return state, results


if __name__ == "__main__":
    main()
