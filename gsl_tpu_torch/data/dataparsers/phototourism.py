"""PhotoTourism dataparser: a ``.tsv`` train/test split over a COLMAP
model.

Port of ``gsl_tpu/data/dataparsers/phototourism.py``: reads
``<scene>.tsv`` (columns filename, id, split, dataset; the first ``*.tsv``
in the scene when `tsv_file` is empty) and splits the COLMAP images by
it. A listed image is in the split its row names; an unlisted one trains.
The appearance ids keep their COLMAP order (``cameras[sel]``), so the
train ids need not be contiguous, and the test views keep ids of their
own. Unlike gsl_tpu's subsets, which drop it, each image keeps its
distortion, so undistortion happens as in the COLMAP parser. Both splits
index the COLMAP images (gsl_tpu takes the test rows out of the train
split it has just cut, so its test views are train images, or an
IndexError).
"""
from __future__ import annotations

import csv
import dataclasses
import glob
import os

import numpy as np

from .colmap import ColmapDataParser, ColmapDataParserConfig
from .dataparser import DataParserOutputs, ImageSet


@dataclasses.dataclass
class PhotoTourismDataParserConfig(ColmapDataParserConfig):
    tsv_file: str = ""   # the first *.tsv of the scene when empty

    def instantiate(self) -> "PhotoTourismDataParser":
        return PhotoTourismDataParser(self)


class PhotoTourismDataParser(ColmapDataParser):
    def get_outputs(self) -> DataParserOutputs:
        cfg: PhotoTourismDataParserConfig = self.config
        outputs = super().get_outputs()

        tsv = cfg.tsv_file
        if not tsv:
            cands = sorted(glob.glob(os.path.join(cfg.path, "*.tsv")))
            if not cands:
                return outputs
            tsv = cands[0]
        split = {}
        with open(tsv) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                if row.get("filename"):
                    split[row["filename"]] = row.get("split", "train")

        full = outputs.train_set
        names = full.image_names
        train_idx = [i for i, nm in enumerate(names)
                     if split.get(nm, "train") == "train"]
        test_idx = [i for i, nm in enumerate(names)
                    if split.get(nm) == "test"]

        def subset(idx) -> ImageSet:
            extra = full.extra_data and {
                k: [v[i] for i in idx] for k, v in full.extra_data.items()}
            return ImageSet(
                image_names=[full.image_names[i] for i in idx],
                image_paths=[full.image_paths[i] for i in idx],
                cameras=full.cameras[np.asarray(idx, np.int64)],
                extra_data=extra)

        outputs.train_set = subset(train_idx)
        if test_idx:
            outputs.val_set = subset(test_idx)
            outputs.test_set = outputs.val_set
        return outputs
