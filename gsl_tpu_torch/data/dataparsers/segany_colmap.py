"""SegAny COLMAP dataparser: a COLMAP scene with SAM masks and mask
scales, for the second-stage feature distillation (`training/segany.py`).

Port of ``gsl_tpu/data/dataparsers/segany_colmap.py``: per image,
`<path>/<semantic_mask_dir>/<stem>.npz` (key `masks`, [M, H, W] bool) and
`<path>/<semantic_scale_dir>/<stem>.npy` ([M]), each path None where the
file is missing, in `extra_data["sam_masks"]` and
`extra_data["mask_scales"]`. (`tools/get_sam_masks.py` writes
`<name with extension>.npz`, which this parser, like gsl_tpu's, does not
find.)
"""
from __future__ import annotations

import dataclasses
import os

from .colmap import ColmapDataParser, ColmapDataParserConfig
from .dataparser import DataParserOutputs


@dataclasses.dataclass
class SegAnyColmapDataParserConfig(ColmapDataParserConfig):
    semantic_mask_dir: str = "semantic/masks"
    semantic_scale_dir: str = "semantic/scales"

    def instantiate(self) -> "SegAnyColmapDataParser":
        return SegAnyColmapDataParser(self)


class SegAnyColmapDataParser(ColmapDataParser):
    def get_outputs(self) -> DataParserOutputs:
        cfg: SegAnyColmapDataParserConfig = self.config
        outputs = super().get_outputs()
        for image_set in (outputs.train_set, outputs.val_set):
            masks, scales = [], []
            for name in image_set.image_names:
                base = os.path.splitext(name)[0]
                m = os.path.join(cfg.path, cfg.semantic_mask_dir,
                                 base + ".npz")
                s = os.path.join(cfg.path, cfg.semantic_scale_dir,
                                 base + ".npy")
                masks.append(m if os.path.exists(m) else None)
                scales.append(s if os.path.exists(s) else None)
            image_set.extra_data = {**(image_set.extra_data or {}),
                                    "sam_masks": masks,
                                    "mask_scales": scales}
        return outputs
