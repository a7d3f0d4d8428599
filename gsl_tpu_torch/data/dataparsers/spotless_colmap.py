"""SpotLessSplats dataparser: a keyword train / test split and per-image
Stable Diffusion feature paths.

Port of ``gsl_tpu/data/dataparsers/spotless_colmap.py``: images whose name
contains `train_keyword` train and those with `test_keyword` evaluate
(each name once, train set first); each image gets
`<path>/<semantic_feature_dir>/<stem>.npy` as its SD feature path
(`extra_data["sd_feature_paths"]`, loaded by the fit's SpotLess hook).
The rebuilt sets carry no other `extra_data`, as gsl_tpu's do: the
per-image distortion is dropped with them.
"""
from __future__ import annotations

import dataclasses
import os

from ..cameras import stack_cameras
from .colmap import ColmapDataParser, ColmapDataParserConfig
from .dataparser import DataParserOutputs, ImageSet


@dataclasses.dataclass
class SpotLessColmapDataParserConfig(ColmapDataParserConfig):
    semantic_feature_dir: str = "SD"
    train_keyword: str = "clutter"
    test_keyword: str = "extra"
    keyword_split: bool = True

    def instantiate(self) -> "SpotLessColmapDataParser":
        return SpotLessColmapDataParser(self)


def _keyword_set(outputs: DataParserOutputs, keyword: str):
    """The images of the train and val sets whose name holds `keyword`,
    each name once, as one set; None if there is none."""
    picks, seen = [], set()
    for s in (outputs.train_set, outputs.val_set):
        for i, nm in enumerate(s.image_names):
            if keyword in nm and nm not in seen:
                seen.add(nm)
                picks.append((s, i))
    if not picks:
        return None
    return ImageSet(
        image_names=[s.image_names[i] for s, i in picks],
        image_paths=[s.image_paths[i] for s, i in picks],
        cameras=stack_cameras([s.cameras[i] for s, i in picks]),
        extra_data={})


class SpotLessColmapDataParser(ColmapDataParser):
    def get_outputs(self) -> DataParserOutputs:
        outputs = super().get_outputs()
        cfg: SpotLessColmapDataParserConfig = self.config
        if cfg.keyword_split:
            train_set = _keyword_set(outputs, cfg.train_keyword)
            test_set = _keyword_set(outputs, cfg.test_keyword)
            if train_set is not None:
                outputs = dataclasses.replace(
                    outputs, train_set=train_set,
                    val_set=test_set or outputs.val_set,
                    test_set=test_set or outputs.test_set)
        for s in (outputs.train_set, outputs.val_set):
            feats = []
            for nm in s.image_names:
                stem = nm[:nm.rfind(".")] if "." in nm else nm
                feats.append(os.path.join(
                    cfg.path, cfg.semantic_feature_dir, stem + ".npy"))
            if s.extra_data is None:
                s.extra_data = {}
            s.extra_data["sd_feature_paths"] = feats
        return outputs
