"""COLMAP scene with estimated (monocular) inverse-depth maps, for
depth-regularised training.

Port of ``gsl_tpu/data/dataparsers/estimated_depth_colmap.py``: the map of
image `<name>` is `<path>/<depth_dir>/<stem>.npy`, or `<name>.npy`; with
`depth_rescaling`, its per-image scale and offset come from
`<path>/<depth_scale_name>.json` ({name: {"scale": s, "offset": o}}, as
``python -m gsl_tpu_torch.tools.get_depth_scales`` writes it) and the
given inverse depth is map * scale + offset. An image whose scale lies
outside [lower, upper] x the median scale, or that has no map or no
scale, gets None: no depth supervision.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .colmap import ColmapDataParser, ColmapDataParserConfig
from .dataparser import DataParserOutputs


@dataclasses.dataclass
class EstimatedDepthColmapDataParserConfig(ColmapDataParserConfig):
    depth_dir: str = "estimated_depths"
    depth_rescaling: bool = True
    depth_scale_name: str = "estimated_depth_scales"
    depth_scale_lower_bound: float = 0.2
    depth_scale_upper_bound: float = 5.0

    def instantiate(self) -> "EstimatedDepthColmapDataParser":
        return EstimatedDepthColmapDataParser(self)


class EstimatedDepthColmapDataParser(ColmapDataParser):
    def get_outputs(self) -> DataParserOutputs:
        """The COLMAP outputs, the train and val sets with
        `extra_data["depth"]`: per image, {"path", "scale", "offset"} or
        None."""
        outputs = super().get_outputs()
        cfg: EstimatedDepthColmapDataParserConfig = self.config

        scales = {}
        if cfg.depth_rescaling:
            with open(os.path.join(cfg.path,
                                   f"{cfg.depth_scale_name}.json")) as f:
                scales = json.load(f)
            vals = [v["scale"] for v in scales.values()]
            median = float(np.median(vals)) if vals else 1.0
            lo = cfg.depth_scale_lower_bound * median
            hi = cfg.depth_scale_upper_bound * median
        for image_set in (outputs.train_set, outputs.val_set):
            depth_info = []
            for name in image_set.image_names:
                base = os.path.splitext(name)[0]
                dpath = os.path.join(cfg.path, cfg.depth_dir, f"{base}.npy")
                if not os.path.exists(dpath):
                    dpath = os.path.join(cfg.path, cfg.depth_dir,
                                         f"{name}.npy")
                entry: Optional[dict] = None
                if os.path.exists(dpath):
                    if cfg.depth_rescaling:
                        s = scales.get(name) or scales.get(base)
                        if s is not None and lo <= s["scale"] <= hi:
                            entry = {"path": dpath,
                                     "scale": float(s["scale"]),
                                     "offset": float(s.get("offset", 0.0))}
                    else:
                        entry = {"path": dpath, "scale": 1.0, "offset": 0.0}
                depth_info.append(entry)
            image_set.extra_data = {**(image_set.extra_data or {}),
                                    "depth": depth_info}
        return outputs


def load_depth(entry: Optional[dict]) -> Optional[np.ndarray]:
    """-> the scaled inverse depth [H, W] float32, or None."""
    if entry is None:
        return None
    d = np.load(entry["path"]).astype(np.float32)
    return d * entry["scale"] + entry["offset"]
