"""Primary renderer: project -> SH colors -> rasterize.

Port of ``gsl_tpu/renderers/tile_renderer.py``. Depth, inverse depth and
normals ride the same rasterize pass as extra composited channels next to
rgb; hard inverse depth is a second pass with opacities pushed to 1. The
output is always the reference's exact mode (exact (tile, depth) order,
f32 payload). The whole forward is differentiable in the Gaussian
parameters; the two taps hand the screen-space mean gradients to density
control. A variant renderer overrides the seams `get_means`,
`get_scales` and `get_opacities`, each of which sees the camera (the
Mip-Splatting renderer filters scales and opacities there). The
appearance trainers hand `forward` their colours (`rgbs_override`) and an
opacity offset (`opacity_offset`).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, NamedTuple, Optional

import torch

from ..data.cameras import Cameras
from ..models.gaussian import GaussianState
from ..ops.projection import Projections, project_gaussians
from ..ops.rasterize import rasterize
from ..ops.sh import sh_to_rgb
from ..ops.transforms import normalize_quat, quat_to_rotmat
from ..utils.device import float32_math
from .renderer import RendererOutputInfo, RendererOutputType


class RenderOutputs(NamedTuple):
    """All images HWC / HW. Only requested keys are non-None."""

    render: torch.Tensor                       # [H, W, 3]
    alpha: Optional[torch.Tensor]              # [H, W]
    acc_depth: Optional[torch.Tensor]          # [H, W] alpha-blended z
    exp_depth: Optional[torch.Tensor]          # [H, W] acc_depth / alpha
    inverse_depth: Optional[torch.Tensor]      # [H, W] blended 1/z
    hard_inverse_depth: Optional[torch.Tensor]  # [H, W]
    normal: Optional[torch.Tensor]             # [H, W, 3] world normals
    projections: Projections
    radii: torch.Tensor                        # [N] int32
    n_isects: int
    n_dropped: int


@dataclasses.dataclass
class TileRendererConfig:
    tile_size: int = 16
    anti_aliased: bool = True
    filter_2d_kernel_size: float = 0.3
    tile_based_culling: bool = True    # peak-alpha tile cull: drops only
                                       # slots whose peak alpha over the tile
                                       # is below the 1/255 threshold
    max_viewspace_grad_scale: float = 65535.0
    stp_resort: bool = False           # StopThePop: per-tile depth-plane
                                       # keys, per-pixel resort of windows of
                                       # 16, no transmittance stop

    def instantiate(self) -> "TileRenderer":
        return TileRenderer(self)


class TileRenderer:
    def __init__(self, config: TileRendererConfig):
        self.config = config

    def supports_absgrad(self) -> bool:
        """True when forward() produces the absgrad tap's gradient: always,
        since the kernels' plain versions produce it too."""
        return True

    # ---- seams a variant renderer overrides ----
    def get_means(self, gaussians: GaussianState, camera: Cameras):
        return gaussians.get_means()

    def get_scales(self, gaussians: GaussianState, camera: Cameras):
        return gaussians.get_scales()

    def get_opacities(self, gaussians: GaussianState, camera: Cameras,
                      proj: Projections):
        op = gaussians.get_opacities()
        if self.config.anti_aliased:
            op = op * proj.compensations
        return op

    def get_rgbs(self, gaussians: GaussianState, camera: Cameras,
                 sh_degree: int):
        viewdirs = gaussians.get_means().detach() - camera.camera_center
        rgbs = sh_to_rgb(gaussians.get_shs(), viewdirs, sh_degree)
        return torch.clamp(rgbs + 0.5, min=0.0)

    def forward(
        self,
        gaussians: GaussianState,
        camera: Cameras,
        img_height: int,
        img_width: int,
        bg_color: torch.Tensor,            # [3]
        sh_degree: int,
        render_types: FrozenSet[str] = frozenset({"rgb"}),
        scaling_modifier: float = 1.0,
        means2d_tap: Optional[torch.Tensor] = None,   # [N, 2] zeros
        absgrad_tap: Optional[torch.Tensor] = None,   # [N, 2] zeros
        rgbs_override: Optional[torch.Tensor] = None,  # [N, 3]
        opacity_offset: Optional[torch.Tensor] = None,  # [N]
    ) -> RenderOutputs:
        """`means2d_tap` is added to the projected means, so its gradient
        is dL/d(means2d); the gradient of `absgrad_tap` is the AbsGS
        statistic (see `ops.rasterize.rasterize`). `rgbs_override` takes
        the place of the SH colours (an appearance network's); with an
        `opacity_offset`, opacity = min(sigmoid(op) + offset * alive, 1),
        times the compensations when anti-aliased, in place of
        `get_opacities`."""
        cfg = self.config
        with float32_math():   # the camera transform's matrix product
            proj = project_gaussians(
                self.get_means(gaussians, camera),
                self.get_scales(gaussians, camera) * scaling_modifier,
                gaussians.get_rotations(), camera.world_to_camera,
                camera.fx, camera.fy, camera.cx, camera.cy, img_width,
                img_height, filter_2d=cfg.filter_2d_kernel_size)
        if means2d_tap is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_tap)
        if opacity_offset is not None:
            op = gaussians.get_opacities() + opacity_offset * gaussians.alive
            op = torch.minimum(op, op.new_ones(()))  # jnp.minimum's ties
            opacities = (op * proj.compensations if cfg.anti_aliased
                         else op)
        else:
            opacities = self.get_opacities(gaussians, camera, proj)
        rgbs = (rgbs_override if rgbs_override is not None
                else self.get_rgbs(gaussians, camera, sh_degree))

        # extra composited channels next to rgb
        channels = [rgbs]
        bg = [bg_color.to(rgbs)]
        idx = {}
        c = 3
        if {"alpha", "acc_depth", "exp_depth"} & render_types:
            channels.append(proj.depths[:, None])
            idx["acc_depth"] = c
            c += 1
        if "inverse_depth" in render_types:
            channels.append(1.0 / torch.clamp(proj.depths[:, None], min=1e-8))
            idx["inverse_depth"] = c
            c += 1
        if "normal" in render_types:
            # per-gaussian normal = local z axis (third rotation column),
            # flipped to face the camera
            normals = quat_to_rotmat(
                normalize_quat(gaussians.get_rotations()))[:, :, 2]
            dirs = (self.get_means(gaussians, camera).detach()
                    - camera.camera_center)
            away = torch.sum(normals * dirs, dim=-1) > 0.0
            normals = normals * torch.where(away, -1.0, 1.0)[:, None]
            channels.append(normals)
            idx["normal"] = c
            c += 3
        ch = torch.cat(channels, dim=-1)
        bg.append(torch.zeros(c - 3, dtype=rgbs.dtype, device=rgbs.device))
        bgv = torch.cat(bg)

        img_nobg, alpha, aux = rasterize(
            proj, opacities, ch, img_height, img_width, cfg.tile_size,
            cfg.tile_based_culling, absgrad_tap, cfg.stp_resort)
        img = img_nobg + (1.0 - alpha)[..., None] * bgv

        hard_inv = None
        if "hard_inverse_depth" in render_types:
            # hard blending: every visible splat fully opaque, with the
            # reference's straight-through gradient
            hard_op = opacities + (1.0 - opacities).detach()
            hard_op = hard_op * (opacities > 0.0)
            inv_d = 1.0 / torch.clamp(proj.depths[:, None], min=1e-8)
            hd_img, _, _ = rasterize(
                proj, hard_op, inv_d, img_height, img_width, cfg.tile_size,
                cfg.tile_based_culling, stp_resort=cfg.stp_resort)
            hard_inv = hd_img[..., 0]

        acc_depth = img[..., idx["acc_depth"]] if "acc_depth" in idx else None
        exp_depth = None
        if acc_depth is not None and "exp_depth" in render_types:
            exp_depth = acc_depth / torch.clamp(alpha, min=1e-8)
        return RenderOutputs(
            render=img[..., :3],
            alpha=alpha if "alpha" in render_types else None,
            acc_depth=acc_depth,
            exp_depth=exp_depth,
            inverse_depth=(img[..., idx["inverse_depth"]]
                           if "inverse_depth" in idx else None),
            hard_inverse_depth=hard_inv,
            normal=(img[..., idx["normal"]:idx["normal"] + 3]
                    if "normal" in idx else None),
            projections=proj,
            radii=proj.radii,
            n_isects=aux.n_isects,
            n_dropped=aux.n_dropped,
        )

    def get_available_outputs(self):
        gray = RendererOutputType.GRAY
        return {
            "rgb": RendererOutputInfo("render", RendererOutputType.RGB),
            "alpha": RendererOutputInfo("alpha", gray),
            "acc_depth": RendererOutputInfo("acc_depth", gray),
            "exp_depth": RendererOutputInfo("exp_depth", gray),
            "inverse_depth": RendererOutputInfo("inverse_depth", gray),
            "hard_inverse_depth": RendererOutputInfo("hard_inverse_depth",
                                                     gray),
            "normal": RendererOutputInfo("normal",
                                         RendererOutputType.NORMAL_MAP),
        }


def viewspace_grad_scale(img_width: int, img_height: int,
                         max_scale: float = 65535.0, device=None):
    """[2] 0.5 * [W, H], clamped: the factor that turns means2d gradients
    in pixels into the densification statistic."""
    return torch.clamp(
        torch.tensor([0.5 * img_width, 0.5 * img_height],
                     dtype=torch.float32, device=device), max=max_scale)
