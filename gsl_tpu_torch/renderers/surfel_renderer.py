"""2DGS surfel renderer.

Port of ``gsl_tpu/renderers/surfel_renderer.py``. Outputs: render, alpha,
rend_normal (world space, unnormalized), view_normal, rend_dist,
surf_depth (expected and median depth blended by depth_ratio) and
surf_normal (finite-difference normals of the unprojected depth map,
scaled by alpha). All seven come from one rasterize pass with C = 6
composited channels (rgb + view-space normal).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..data.cameras import Cameras
from ..models.gaussian import GaussianState
from ..ops.sh import sh_colors
from ..ops.surfel import project_surfels
from ..ops.surfel_rasterize import rasterize_surfels
from ..utils.device import float32_math
from .renderer import RendererOutputInfo, RendererOutputType


class SurfelRenderOutputs(NamedTuple):
    render: torch.Tensor          # [H, W, 3]
    alpha: torch.Tensor           # [H, W]
    rend_normal: torch.Tensor     # [H, W, 3] world space (unnormalized)
    view_normal: torch.Tensor     # [H, W, 3]
    rend_dist: torch.Tensor       # [H, W]
    surf_depth: torch.Tensor      # [H, W]
    surf_normal: torch.Tensor     # [H, W, 3]
    radii: torch.Tensor           # [CAP] int32
    n_isects: int
    n_dropped: int                # always 0: buffers are sized to the total


@dataclasses.dataclass
class SurfelRendererConfig:
    depth_ratio: float = 0.0     # 0: expected depth; 1: median depth
    tile_size: int = 16
    max_viewspace_grad_scale: float = 65535.0

    def instantiate(self) -> "SurfelRenderer":
        return SurfelRenderer(self)


def depth_to_points(camera: Cameras, depth: torch.Tensor) -> torch.Tensor:
    """Unproject a depth map [H, W] to world points [H, W, 3]."""
    H, W = depth.shape
    dev = depth.device
    px = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5
          )[None, :].expand(H, W)
    py = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5
          )[:, None].expand(H, W)
    dir_cam = torch.stack([(px - camera.cx) / camera.fx,
                           (py - camera.cy) / camera.fy,
                           torch.ones_like(px)], dim=-1)
    dir_world = torch.einsum("ji,hwj->hwi", camera.R, dir_cam)
    return depth[..., None] * dir_world + camera.camera_center


def depth_to_normal(camera: Cameras, depth: torch.Tensor) -> torch.Tensor:
    """Finite-difference world normals of the depth map; the border pixels
    stay zero."""
    pts = depth_to_points(camera, depth)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # rsqrt(max(n.n, eps)) has a finite gradient everywhere; the gradient
    # of a norm is 0 / 0 where dx = dy = 0 (flat or empty regions)
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    n = n * torch.rsqrt(torch.clamp(n2, min=1e-24))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


class SurfelRenderer:
    def __init__(self, config: SurfelRendererConfig):
        self.config = config

    def supports_absgrad(self) -> bool:
        """False: the surfel rasterizer produces no AbsGS statistic, so a
        trainer configured with `absgrad` takes the plain means2d tap."""
        return False

    def forward(self, gaussians: GaussianState, camera: Cameras,
                img_height: int, img_width: int, bg_color: torch.Tensor,
                sh_degree: int, render_types=None,
                means2d_tap: Optional[torch.Tensor] = None
                ) -> SurfelRenderOutputs:
        """Every call renders all outputs; `render_types` is accepted so a
        viewer can drive this renderer like the tile renderer. The gradient
        of `means2d_tap` ([N, 2] zeros) is dL/d(projected center) in
        pixels."""
        cfg = self.config
        with float32_math():   # the camera transform's matrix product
            proj = project_surfels(
                gaussians.get_means(), gaussians.get_scales(),
                gaussians.get_rotations(), camera.world_to_camera,
                camera.fx, camera.fy, camera.cx, camera.cy,
                img_width, img_height)
        if means2d_tap is not None:
            # shift the homogeneous center by tap pixels: Tw.xy += tap*Tw.z
            shift = torch.cat([means2d_tap * proj.Tw[:, 2:3],
                               torch.zeros_like(proj.Tw[:, :1])], dim=-1)
            proj = proj._replace(Tw=proj.Tw + shift,
                                 means2d=proj.means2d + means2d_tap)

        opacities = gaussians.get_opacities()
        rgbs = sh_colors(gaussians.get_means(), camera.camera_center,
                         gaussians.params.shs_dc, gaussians.params.shs_rest,
                         sh_degree)
        channels = torch.cat([rgbs, proj.normals], dim=-1)

        res, aux = rasterize_surfels(proj, opacities, channels, img_height,
                                     img_width, cfg.tile_size)

        render = (res.channels[..., :3]
                  + (1.0 - res.alpha)[..., None] * bg_color.to(rgbs))
        view_normal = res.channels[..., 3:6]
        # view -> world: n_world = R_wc^T n_view
        with float32_math():
            rend_normal = torch.einsum("ji,hwj->hwi", camera.R, view_normal)

        exp_depth = res.exp_depth / torch.clamp(res.alpha, min=1e-8)
        surf_depth = (exp_depth * (1.0 - cfg.depth_ratio)
                      + cfg.depth_ratio * res.median_depth)
        with float32_math():
            surf_normal = depth_to_normal(camera, surf_depth)
        surf_normal = surf_normal * res.alpha.detach()[..., None]

        return SurfelRenderOutputs(
            render=render,
            alpha=res.alpha,
            rend_normal=rend_normal,
            view_normal=-view_normal,
            rend_dist=res.distortion,
            surf_depth=surf_depth,
            surf_normal=surf_normal,
            radii=proj.radii,
            n_isects=aux.n_isects,
            n_dropped=0,
        )

    def get_available_outputs(self):
        gray = RendererOutputType.GRAY
        normal = RendererOutputType.NORMAL_MAP
        return {
            "rgb": RendererOutputInfo("render", RendererOutputType.RGB),
            "rend_alpha": RendererOutputInfo("alpha", gray),
            "rend_normal": RendererOutputInfo("rend_normal", normal),
            "view_normal": RendererOutputInfo("view_normal", normal),
            "rend_dist": RendererOutputInfo("rend_dist", gray),
            "surf_depth": RendererOutputInfo("surf_depth", gray),
            "surf_normal": RendererOutputInfo("surf_normal", normal),
        }
