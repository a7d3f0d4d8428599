"""Feature3DGS dataparser: a COLMAP scene with a teacher feature map per
image, for the second-stage distillation (`training/feature3dgs.py`).

Port of ``gsl_tpu/data/dataparsers/feature_3dgs.py``: image `<name>`'s
map is `<path>/<feature_dir>/<name><filename_suffix>.npy`, the name
without its extension unless `filename_include_image_ext`, in
`extra_data["feature_map_paths"]`.
"""
from __future__ import annotations

import dataclasses
import os

from .colmap import ColmapDataParser, ColmapDataParserConfig
from .dataparser import DataParserOutputs


@dataclasses.dataclass
class Feature3DGSColmapDataParserConfig(ColmapDataParserConfig):
    feature_dir: str = "semantic/sam_features"
    filename_suffix: str = ""
    filename_include_image_ext: bool = True

    def instantiate(self) -> "Feature3DGSColmapDataParser":
        return Feature3DGSColmapDataParser(self)


class Feature3DGSColmapDataParser(ColmapDataParser):
    def get_outputs(self) -> DataParserOutputs:
        outputs = super().get_outputs()
        cfg: Feature3DGSColmapDataParserConfig = self.config
        for s in (outputs.train_set, outputs.val_set):
            paths = []
            for nm in s.image_names:
                if not cfg.filename_include_image_ext and "." in nm:
                    nm = nm[:nm.rfind(".")]
                paths.append(os.path.join(
                    cfg.path, cfg.feature_dir,
                    f"{nm}{cfg.filename_suffix}.npy"))
            if s.extra_data is None:
                s.extra_data = {}
            s.extra_data["feature_map_paths"] = paths
        return outputs
