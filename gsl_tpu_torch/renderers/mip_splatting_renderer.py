"""Mip-Splatting renderer: the tile renderer with the 3D filter applied.

Port of ``gsl_tpu/renderers/mip_splatting_renderer.py``: the scale and
opacity seams return the filtered scales and the compensated opacities of
``models/mip_splatting.apply_3d_filter``, and the 2D low-pass kernel is
0.1. The rasterizer's kernels (K1-K4) see nothing else.
"""
from __future__ import annotations

import dataclasses

from ..models.gaussian import GaussianState
from ..models.mip_splatting import apply_3d_filter
from .tile_renderer import TileRenderer, TileRendererConfig


@dataclasses.dataclass
class MipSplattingRendererConfig(TileRendererConfig):
    filter_2d_kernel_size: float = 0.1
    opacity_compensation: bool = True

    def instantiate(self) -> "MipSplattingRenderer":
        return MipSplattingRenderer(self)


class MipSplattingRenderer(TileRenderer):
    def _filtered(self, gaussians: GaussianState):
        return apply_3d_filter(
            gaussians.get_scales(), gaussians.get_opacities(),
            gaussians.extra["filter_3d"], self.config.opacity_compensation)

    def get_scales(self, gaussians, camera):
        _, scales = self._filtered(gaussians)
        return scales

    def get_opacities(self, gaussians, camera, proj):
        op, _ = self._filtered(gaussians)
        if self.config.anti_aliased:
            op = op * proj.compensations
        return op
