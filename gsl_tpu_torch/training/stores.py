"""Stores: per-Gaussian state beside the model, shared by components.

Port of ``gsl_tpu/training/stores.py``:

- `VanillaStoreConfig`: no store (``distance_factors`` gives None);
- `PartitionStore`: loads ``partitions.npz`` (``utils/partitioning.py``),
  keeps the owning cell's box and the scene's rotation, and gives each
  Gaussian's distance to the cell over the cell size, 0 inside. That is
  the foreground-first damping `training/density.update_stats` takes as
  `distance_factors`.

As in gsl_tpu, nothing in the fit passes `distance_factors` and no config
key reaches `PartitionStoreConfig`: the store is there for a caller that
builds its own loop.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.gaussian import GaussianState


@dataclasses.dataclass
class VanillaStoreConfig:
    def instantiate(self):
        return self

    def distance_factors(self, gstate: GaussianState):
        return None


@dataclasses.dataclass
class PartitionStoreConfig:
    partitions_path: str = ""     # partitions.npz from utils/partitioning
    partition_idx: int = 0
    distance_normalization: float = 1.0

    def instantiate(self) -> "PartitionStore":
        return PartitionStore(self)


class PartitionStore:
    def __init__(self, config: PartitionStoreConfig):
        from ..utils.partitioning import PartitionedScene

        self.config = config
        scene = PartitionedScene.load(config.partitions_path)
        self.partition = scene.partitions[config.partition_idx]
        self.rotation = torch.as_tensor(scene.rotation, dtype=torch.float32)
        self.up_axis = scene.up_axis
        self.size = float(scene.config.partition_size)

    def distance_factors(self, gstate: GaussianState) -> torch.Tensor:
        """[CAP] distance of each Gaussian's centre, in the reoriented
        ground plane, to the partition's box, over size *
        distance_normalization; 0 inside the box. On the state's
        device."""
        dev = gstate.device
        p = gstate.params.means @ self.rotation.to(dev).T
        keep = [i for i in range(3) if i != self.up_axis]
        xy = p[:, keep]
        lo = torch.as_tensor(self.partition.xy_min, dtype=torch.float32,
                             device=dev)
        hi = torch.as_tensor(self.partition.xy_max, dtype=torch.float32,
                             device=dev)
        d = torch.clamp(torch.maximum(lo - xy, xy - hi), min=0.0)
        dist = torch.linalg.norm(d, dim=-1)
        return dist / (self.size * self.config.distance_normalization)
