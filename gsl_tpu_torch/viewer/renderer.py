"""Viewer-side rendering: camera pose -> visualized uint8 image.

Port of ``gsl_tpu/viewer/renderer.py``. The camera is built on the
state's device, the frame is rendered, visualized and quantized there, and
one uint8 image goes to the host, whatever the output type.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.cameras import make_camera
from ..models.gaussian import GaussianState
from ..renderers.surfel_renderer import SurfelRenderer
from ..utils.tracing import span
from ..utils.visualizers import visualize_output


class ViewerRenderer:
    def __init__(self, state: GaussianState, renderer, sh_degree: int,
                 background=(0.0, 0.0, 0.0)):
        self.state = state
        self.renderer = renderer
        self.sh_degree = sh_degree
        self.bg = torch.as_tensor(background, dtype=torch.float32).to(
            state.device)
        self.output_type = "rgb"

    def available_output_types(self):
        """The names of the renderer's outputs, in its order."""
        return list(self.renderer.get_available_outputs().keys())

    def _camera(self, c2w, width, height, fov_y):
        w2c = np.linalg.inv(np.asarray(c2w, np.float64))
        f = 0.5 * height / np.tan(0.5 * np.deg2rad(fov_y))
        # each field a copy from pageable host memory, which waits on the
        # stream
        with span("wait.camera_upload"):
            return make_camera(R=w2c[:3, :3], T=w2c[:3, 3], fx=f, fy=f,
                               cx=width / 2.0, cy=height / 2.0, width=width,
                               height=height, device=self.state.device)

    @torch.no_grad()
    def get_depth(self, c2w: np.ndarray, width: int, height: int,
                  fov_y: float = 60.0) -> np.ndarray:
        """Expected-depth map [H, W]; a surfel renderer's surface depth
        (the JAX package serves no surfel model)."""
        with span("viewer.frame"):
            with span("viewer.camera"):
                camera = self._camera(c2w, width, height, fov_y)
            with span("viewer.render"):
                out = self.renderer.forward(
                    self.state, camera, height, width, self.bg,
                    self.sh_degree,
                    render_types=frozenset({"rgb", "exp_depth"}))
            depth = (out.surf_depth
                     if isinstance(self.renderer, SurfelRenderer)
                     else out.exp_depth)
            with span("wait.frame_copy"):
                return depth.cpu().numpy()

    @torch.no_grad()
    def get_outputs(self, c2w: np.ndarray, width: int, height: int,
                    fov_y: float = 60.0) -> np.ndarray:
        """c2w [4,4] OpenCV convention -> uint8 HWC image of the selected
        output type."""
        render_types = (frozenset({"rgb"}) if self.output_type == "rgb"
                        else frozenset({"rgb", self.output_type}))
        with span("viewer.frame"):
            with span("viewer.camera"):
                camera = self._camera(c2w, width, height, fov_y)
            with span("viewer.render"):
                out = self.renderer.forward(
                    self.state, camera, height, width, self.bg,
                    self.sh_degree, render_types=render_types)
            # visualized and quantized on the device: one uint8 copy to
            # the host, not a float one
            with span("viewer.quantise"):
                if self.output_type == "rgb":
                    img = out.render
                else:
                    info = self.renderer.get_available_outputs()[
                        self.output_type]
                    img = visualize_output(info.type.value,
                                           getattr(out, info.key))
                img = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)
            with span("wait.frame_copy"):
                return img.cpu().numpy()
