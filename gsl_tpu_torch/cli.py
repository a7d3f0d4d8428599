"""CLI: ``python -m gsl_tpu_torch.cli fit|validate|test --config x.yaml``.

Port of ``gsl_tpu/cli.py``: YAML presets select component classes by
``class_path`` / ``init_args`` and set hyperparameters; later configs and
``key=value`` overrides win over earlier ones; ``-n/--name`` builds the
output dir; ``fit`` snapshots the resolved config into it, and
``validate`` / ``test`` load that snapshot first and then the newest
checkpoint. ``--device`` (default ``cuda``) picks where it runs.

The same YAML files drive both packages. Fields that exist only for the
TPU (`TPU_ONLY_FIELDS`) are accepted and ignored with one printed line.
Components the port does not have yet raise ``NotImplementedError``
naming their ROADMAP item; any other unknown field raises ``KeyError``. A ``class_path`` into gsl_tpu (``taming.yaml``
names one) resolves through the registry, or raises
``NotImplementedError``: it is never imported. Two variants that
gsl_tpu's CLI combines but whose step applies only one (an appearance
model with an output processor, gradient accumulation, a depth or 2DGS
metric or plugins; gradient accumulation or Glossy with an output
processor; Glossy with another variant trainer; GNS with a trainer whose
step is not the plain one; a deformation field with another variant
trainer, an output processor, plugins, the AbsGS or accurate-visibility
statistic or MCMC's regularisers; the SpotLess metrics, whose step
replaces the trainer's, with anything that step drops) raise
``ValueError`` naming both. The ``deform`` key (a field name, or {field, init_args} with ``init_args``
into `DeformModelConfig`) selects `DeformTrainer`.
Without ``model.n_appearances`` the appearance embedding is sized from the
data at fit time.

``distributed:`` (true, or a mapping of ``n_devices``, ``dp``, ``mp``,
``compact_k`` and ``backend``) routes ``fit`` to
``parallel/fit_distributed.py``: camera data parallelism x Gaussian-sharded
model parallelism over ``torch.distributed``. Under a launcher (``RANK``
and ``WORLD_SIZE`` set: ``torchrun``, ``tools/launch_multihost.py``) this
process is one rank and joins by ``env://``; otherwise the CLI spawns the
dp x mp ranks on this host (a world of one runs in this process), and a
rank that fails fails the command, naming the rank. ``n_devices`` is the
world size; ranks share cards when there are more ranks than cards.
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
from .data.dataparsers.estimated_depth_colmap import \
    EstimatedDepthColmapDataParserConfig
from .data.dataparsers.feature_3dgs import Feature3DGSColmapDataParserConfig
from .data.dataparsers.matrix_city import MatrixCityDataParserConfig
from .data.dataparsers.nerfies import NerfiesDataParserConfig
from .data.dataparsers.ngp import NGPDataParserConfig
from .data.dataparsers.nsvf import NSVFDataParserConfig
from .data.dataparsers.phototourism import PhotoTourismDataParserConfig
from .data.dataparsers.segany_colmap import SegAnyColmapDataParserConfig
from .data.dataparsers.silvr import SILVRDataParserConfig
from .data.dataparsers.spotless_colmap import SpotLessColmapDataParserConfig
from .models.appearance import AppearanceFeatureGaussianConfig
from .models.deform import DeformModelConfig
from .models.gaussian import VanillaGaussianConfig
from .models.gaussian_2d import Gaussian2DConfig
from .models.mip_splatting import MipSplattingConfig
from .models.pvg import PVGConfig, PVGRendererConfig
from .parallel import fit_distributed
from .renderers.mip_splatting_renderer import MipSplattingRendererConfig
from .renderers.surfel_renderer import SurfelRendererConfig
from .renderers.tile_renderer import TileRendererConfig
from .training.appearance_trainer import AppearanceTrainer
from .training.deform_trainer import DeformTrainer
from .training.density import VanillaDensityControllerConfig
from .training.density import (
    AccurateVisibilityFilterDensityControllerConfig,
    BackgroundRemovalDensityControllerConfig, H3DGSDensityControllerConfig,
    NoCullingBigScaleDensityControllerConfig,
    RevisingDensityControllerConfig, StaticDensityControllerConfig)
from .training.depth_trainer import DepthMetricsConfig, DepthTrainer
from .training.fit import (FitConfig, _round_capacity, fit, setup_state,
                           validate)
from .training.glossy_trainer import GlossyTrainer
from .training.gns import GNSDensityControllerConfig
from .training.gs2d import GS2DMetricsConfig, GS2DTrainer
from .training.mcmc import MCMCDensityControllerConfig
from .training.metrics import MCMCMetricsConfig, VanillaMetricsConfig
from .training.opt_strategies import GradAccConfig, GradAccTrainer
from .training.output_processors import BilateralGridConfig, ExposureConfig
from .training.plugins import PLUGIN_REGISTRY
from .training.similarity_reg import SimilarityRegConfig
from .training.spotless import SpotLessMetricsConfig, check_spotless_trainer
from .training.taming import Taming3DGSDensityControllerConfig
from .training.trainer import Trainer, TrainerConfig
from .training.visibility_map_trainer import VisibilityMapAppearanceTrainer
from .utils.checkpoint import find_latest_checkpoint, load_checkpoint
from .utils.device import resolve_device

_REGISTRY = {
    "VanillaGaussian": VanillaGaussianConfig,
    "MipSplatting": MipSplattingConfig,
    "Gaussian2D": Gaussian2DConfig,
    "AppearanceFeatureGaussian": AppearanceFeatureGaussianConfig,
    "PVG": PVGConfig,
    "TileRenderer": TileRendererConfig,
    "MipSplattingRenderer": MipSplattingRendererConfig,
    "PVGRenderer": PVGRendererConfig,
    "SurfelRenderer": SurfelRendererConfig,
    "VanillaDensityController": VanillaDensityControllerConfig,
    "MCMCDensityController": MCMCDensityControllerConfig,
    "StaticDensityController": StaticDensityControllerConfig,
    "RevisingDensityController": RevisingDensityControllerConfig,
    "NoCullingBigScaleDC": NoCullingBigScaleDensityControllerConfig,
    "H3DGSDensityController": H3DGSDensityControllerConfig,
    "AccurateVisibilityFilterDensityController":
        AccurateVisibilityFilterDensityControllerConfig,
    "BackgroundRemoval": BackgroundRemovalDensityControllerConfig,
    "GNS": GNSDensityControllerConfig,
    # taming.yaml names its class by gsl_tpu's module path; the port
    # resolves that name here and never imports gsl_tpu
    "gsl_tpu.training.taming.Taming3DGSDensityControllerConfig":
        Taming3DGSDensityControllerConfig,
    "VanillaMetrics": VanillaMetricsConfig,
    "MCMCMetrics": MCMCMetricsConfig,
    "GS2DMetrics": GS2DMetricsConfig,
    "DepthMetrics": DepthMetricsConfig,
    "SpotLessMetrics": SpotLessMetricsConfig,
    "Colmap": ColmapDataParserConfig,
    "EstimatedDepthColmap": EstimatedDepthColmapDataParserConfig,
    "PhotoTourism": PhotoTourismDataParserConfig,
    "Blender": BlenderDataParserConfig,
    "Nerfies": NerfiesDataParserConfig,
    "NSVF": NSVFDataParserConfig,
    "NGP": NGPDataParserConfig,
    "MatrixCity": MatrixCityDataParserConfig,
    "SILVR": SILVRDataParserConfig,
    "SpotLessColmap": SpotLessColmapDataParserConfig,
    # the second stages' parsers (gsl_tpu_torch.seganygs and
    # gsl_tpu_torch.feature3dgs build them themselves)
    "SegAnyColmap": SegAnyColmapDataParserConfig,
    "Feature3DGSColmap": Feature3DGSColmapDataParserConfig,
}

# output_processor shorthands
_PROCESSORS = {"bilagrid": BilateralGridConfig, "exposure": ExposureConfig}

# components of gsl_tpu's registry that the port has not yet -> ROADMAP
# item (every one is ported)
_UNPORTED_COMPONENTS = {}

# fields of gsl_tpu's configs that exist for the TPU's static shapes, its
# matrix unit or its sort; the port has no knob for them
TPU_ONLY_FIELDS = ("backend", "chunk", "pallas_chunk", "max_per_tile",
                   "min_isect_capacity", "isect_capacity_factor",
                   "fast_math", "exact_sort", "matmul_precision",
                   "size_bucket")

def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to gsl_tpu_torch yet (ROADMAP item {item})")


def _resolve_class(path: str):
    """A registry name, or a dotted path to import. A path into gsl_tpu
    resolves only through the registry: the port never imports the JAX
    package."""
    if path in _REGISTRY:
        return _REGISTRY[path]
    if path in _UNPORTED_COMPONENTS:
        raise _not_ported(path, _UNPORTED_COMPONENTS[path])
    if path.split(".", 1)[0] == "gsl_tpu":
        raise NotImplementedError(
            f"{path} names a class of gsl_tpu, which gsl_tpu_torch never "
            "imports, and the port has no counterpart registered for it; "
            f"known: {list(_REGISTRY)}")
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

    # variant trainers selected by the metrics' type, the opt strategy and
    # the model, as gsl_tpu selects them; where gsl_tpu would drop one of
    # two variants silently, the port raises naming both
    trainer_cls, kwargs = Trainer, {}
    if isinstance(metrics, GS2DMetricsConfig):
        trainer_cls = GS2DTrainer
    elif isinstance(metrics, DepthMetricsConfig):
        trainer_cls = DepthTrainer
    grad_acc = (model_spec.get("opt_strategy")
                or cfg.get("opt_strategy")) == "grad_acc"
    if grad_acc:
        trainer_cls = GradAccTrainer
        kwargs["grad_acc"] = GradAccConfig()
    plugins = build_plugins(cfg.get("plugins") or model_spec.get("plugins")
                            or [])
    op_spec = model_spec.get("output_processor") or cfg.get(
        "output_processor")
    if isinstance(model, AppearanceFeatureGaussianConfig):
        # (an output processor: the trainer raises, naming both)
        dropped = [what for what, present in (
            ("opt_strategy grad_acc", grad_acc),
            (f"metrics {type(metrics).__name__}",
             isinstance(metrics, (GS2DMetricsConfig, DepthMetricsConfig))),
            ("plugins", bool(plugins))) if present]
        if dropped:
            raise ValueError(
                f"appearance (AppearanceFeatureGaussian) with "
                f"{dropped[0]}: gsl_tpu's appearance step would drop it "
                "silently")
        trainer_cls = AppearanceTrainer
        kwargs["n_appearances"] = int(model_spec.get("n_appearances",
                                                     0)) or None
        if model_spec.get("swag") or cfg.get("swag"):
            kwargs["with_opacity"] = True      # the SWAG opacity head
        sim_spec = model_spec.get("similarity_reg")
        if sim_spec:
            kwargs["similarity_reg"] = _build(
                SimilarityRegConfig,
                sim_spec if isinstance(sim_spec, dict) else {})
        vis_spec = model_spec.get("visibility_map") or cfg.get(
            "visibility_map")
        if vis_spec:
            trainer_cls = VisibilityMapAppearanceTrainer
            if isinstance(vis_spec, dict) and "grid_type" in vis_spec:
                kwargs["grid_type"] = vis_spec["grid_type"]
    if model_spec.get("glossy") or cfg.get("glossy"):
        if trainer_cls is not Trainer:
            raise ValueError(
                f"glossy with {trainer_cls.__name__}: gsl_tpu's glossy "
                "step would drop the other trainer's step silently")
        trainer_cls = GlossyTrainer       # (a processor: the trainer raises)
    deform_spec = model_spec.get("deform") or cfg.get("deform")
    if deform_spec:
        if isinstance(deform_spec, str):
            deform_spec = {"field": deform_spec}
        if trainer_cls is not Trainer:
            raise ValueError(
                f"deform with {trainer_cls.__name__}: gsl_tpu's deform "
                "step would drop the other trainer's step silently")
        # (a processor, plugins, appearance or a dropped statistic: the
        # trainer raises, naming both)
        trainer_cls = DeformTrainer
        kwargs["field"] = deform_spec.get("field", "mlp")
        kwargs["deform_cfg"] = _build(DeformModelConfig,
                                      deform_spec.get("init_args", {}))
    if op_spec:
        if isinstance(op_spec, str):
            op_spec = {"class_path": op_spec}
        name = op_spec.get("class_path", "bilagrid")
        if name in _PROCESSORS:
            kwargs["output_processor"] = _build(
                _PROCESSORS[name], op_spec.get("init_args", {}))
        else:
            kwargs["output_processor"] = _build(BilateralGridConfig,
                                                op_spec)
    trainer = trainer_cls(model=model, renderer=renderer, density=density,
                          metrics=metrics, config=trainer_cfg,
                          plugins=plugins, **kwargs)
    if isinstance(metrics, SpotLessMetricsConfig):
        # its step replaces the trainer's (training/hooks.py)
        check_spotless_trainer(trainer)
    return trainer, dataparser_cfg, fit_cfg


def build_plugins(specs) -> tuple:
    """Plugins from a list of registry names or {class_path, init_args}."""
    plugins = []
    for spec in specs:
        if isinstance(spec, str):
            spec = {"class_path": spec}
        name = spec.get("class_path")
        pcfg_cls = PLUGIN_REGISTRY.get(name) or _resolve_class(name)
        plugins.append(_build(pcfg_cls, spec.get("init_args", {})
                              ).instantiate())
    return tuple(plugins)


def main(argv=None):
    ap = argparse.ArgumentParser("gsl_tpu_torch")
    ap.add_argument("subcommand", choices=["fit", "validate", "test"])
    ap.add_argument("--config", action="append", default=[])
    ap.add_argument("--data.path", dest="data_path", default=None)
    ap.add_argument("-n", "--name", default="run")
    ap.add_argument("--output", default="outputs")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--viewer", action="store_true",
                    help="serve the in-training web viewer")
    ap.add_argument("--viewer_port", type=int, default=8080)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("set", nargs="*", help="key=value overrides")
    # key=value overrides may come before, between or after the options
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

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
    if args.viewer:
        cfg["fit"]["viewer"] = True
        cfg["fit"]["viewer_port"] = args.viewer_port
    cfg["fit"]["seed"] = args.seed

    trainer, dataparser_cfg, fit_cfg = build_components(cfg)
    if args.subcommand == "fit" and cfg.get("distributed"):
        os.makedirs(fit_cfg.output_dir, exist_ok=True)
        if int(os.environ.get("RANK", "0")) == 0:
            with open(os.path.join(fit_cfg.output_dir, "config.yaml"),
                      "w") as f:
                yaml.safe_dump(cfg, f)
        # every rank builds its own components and data
        results = fit_distributed.run(cfg, device)
        if results:
            print(f"val: psnr={results['psnr']:.3f} "
                  f"ssim={results['ssim']:.4f}")
        return None, results
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
    template = setup_state(
        trainer, outputs,
        trainer.model.init_from_pcd(pc.xyz, pc.rgb, capacity, device))
    state = load_checkpoint(ckpt, template)
    split = "val" if args.subcommand == "validate" else "test"
    results = validate(trainer, state, outputs, fit_cfg, split=split,
                       save_images=True)
    print(f"{split}: psnr={results['psnr']:.3f} "
          f"ssim={results['ssim']:.4f}")
    return state, results


if __name__ == "__main__":
    main()
