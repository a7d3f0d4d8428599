"""Renderer base types (port of ``gsl_tpu/renderers/renderer.py``):
renderers declare their outputs as (key, type) so viewers can pick a
visualizer for each."""
from __future__ import annotations

import dataclasses
import enum


class RendererOutputType(enum.Enum):
    RGB = "rgb"
    GRAY = "gray"
    NORMAL_MAP = "normal_map"
    FEATURE_MAP = "feature_map"
    OTHER = "other"


@dataclasses.dataclass(frozen=True)
class RendererOutputInfo:
    key: str
    type: RendererOutputType = RendererOutputType.RGB
