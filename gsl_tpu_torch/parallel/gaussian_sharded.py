"""Multi-device training: camera data parallelism x Gaussian-sharded model
parallelism over a (dp, mp) grid of ``torch.distributed`` ranks.

Port of ``gsl_tpu/parallel/gaussian_sharded.py``. One process is one rank
(one device of the JAX mesh); rank r sits at (dp_index, mp_index) =
(r // mp, r % mp), row-major as ``make_mesh``'s device grid:

    gsl_tpu (shard_map)                  this module (torch.distributed)
      params sharded P('mp')               each rank holds its rows
                                           [mp_index, mp_index + 1) x cap_local
      lax.all_gather(cameras, 'mp')        `all_gather` over the mp group
      vmap(project) over the mp cameras    a loop over them
      lax.all_to_all of the payload        `_Exchange`, an autograd Function
                                           whose backward is the reverse
                                           all_to_all of the cotangents
      rasterize_pallas per device          the port's rasterize (K1, sort,
                                           ranges, K2; K3, K4 backward)
      lax.psum(grads, 'dp')                `all_reduce` over the dp group

Backends: NCCL only where every rank on a host has a CUDA device of its
own; gloo otherwise (on the CPU, and when several ranks share one card,
which NCCL refuses). On gloo every collective stages CUDA tensors through
the host itself (page-locked buffers), whatever the PyTorch build lets
gloo take; each mesh's `stats` count and time those copies with the
exchange. A world of one rank
needs no process group: every collective is then the identity.

What the reference computes, the port computes, quirks included
(ROADMAP §3):
- the applied gradient is that of the SUM of the n_dev per-rank losses
  (``lax.pmean`` inside the differentiated function, then ``lax.psum``
  over dp), n_dev times the mean loss's; the reported loss is the mean;
- `radii_max` comes from dp row 0 alone: shard_map returns the dp-0
  replica of an output that is not reduced over dp.

Intersection buffers are sized per call, as everywhere in the port, so
``isect_capacity``, ``max_per_tile``, ``chunk``, ``backend`` and
``fast_math`` are accepted and ignored.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.cameras import Cameras
from ..models.gaussian import GaussianParams, GaussianState
from ..ops.projection import Projections, project_gaussians
from ..ops.rasterize import rasterize
from ..ops.sh import sh_colors
from ..training.density import DensityControlState
from ..training.metrics import train_loss
from ..training.optimizers import AdamState
from ..utils.device import float32_math

PAYLOAD_DIM = 10            # means2d 2, conic 3, opacity 1, rgb 3, depth 1
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=30)


# ---- process groups and the mesh -------------------------------------------

def choose_backend(device, local_world_size: int) -> str:
    """NCCL when `device` is CUDA and the host has a card for each of its
    `local_world_size` ranks; gloo otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def backend_reason(backend: str, device, local_world_size: int) -> str:
    dev = torch.device(device)
    if backend == "nccl":
        return (f"{local_world_size} ranks on this host, "
                f"{torch.cuda.device_count()} CUDA devices: one each")
    if dev.type != "cuda":
        return "the ranks run on the CPU"
    return (f"{local_world_size} ranks share {torch.cuda.device_count()} "
            "CUDA device(s), which NCCL refuses; CUDA tensors are staged "
            "through the host")


def init_process_group(rank: int, world_size: int, init_method: str,
                       device, local_world_size: Optional[int] = None
                       ) -> str:
    """Join the world by `init_method` (``env://``, ``file://...`` or
    ``tcp://127.0.0.1:PORT``) on the backend `choose_backend` picks, and
    print the choice. A CUDA rank first makes its own card
    (`rank_device`) the current device, which NCCL and the kernels'
    launches use. Returns the backend."""
    local = world_size if local_world_size is None else local_world_size
    backend = choose_backend(device, local)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, int(
            os.environ.get("LOCAL_RANK", rank))))
    print(f"[fit_mp] rank {rank}/{world_size}: process group on {backend} "
          f"({backend_reason(backend, device, local)})", flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=PROCESS_GROUP_TIMEOUT)
    return backend


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank `local_rank` of its host: ``cpu``, or CUDA
    device ``local_rank % device_count`` (ranks share cards when there
    are more ranks than cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK`` under torchrun)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if _initialized() else 0


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass
class ExchangeStats:
    """The splat exchange's cost on this rank: forward and backward
    all_to_all calls and seconds (host staging included), and the host
    copies of every collective on gloo (count, bytes, seconds). The
    exchange is timed by CUDA events on the card, so that timing it adds
    no synchronisation, and by the host clock on the CPU; `snapshot`
    reads the events still pending (one synchronisation)."""

    fwd_calls: int = 0
    fwd_s: float = 0.0
    bwd_calls: int = 0
    bwd_s: float = 0.0
    staged_copies: int = 0
    staged_bytes: int = 0
    staging_s: float = 0.0
    pending: List = dataclasses.field(default_factory=list, repr=False)

    def start(self, device: torch.device):
        """A mark before a timed exchange."""
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, kind: str, begin, device: torch.device):
        """Add the time since `begin` to `kind` ("fwd" or "bwd")."""
        setattr(self, f"{kind}_calls", getattr(self, f"{kind}_calls") + 1)
        if device.type != "cuda":
            setattr(self, f"{kind}_s", getattr(self, f"{kind}_s")
                    + time.perf_counter() - begin)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pending.append((kind, begin, end))
        if len(self.pending) > PENDING_EVENTS:
            self._settle(wait=False)

    def _settle(self, wait: bool):
        while self.pending and (wait or self.pending[0][2].query()):
            kind, begin, end = self.pending.pop(0)
            end.synchronize()
            setattr(self, f"{kind}_s", getattr(self, f"{kind}_s")
                    + begin.elapsed_time(end) / 1e3)

    def reset(self):
        for f in dataclasses.fields(self):
            if f.name != "pending":
                setattr(self, f.name, f.default)
        self.pending.clear()

    def snapshot(self) -> dict:
        self._settle(wait=True)
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "pending"}


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dp, mp) grid, its subgroups and device.
    `dp_group` joins the ranks of one mp index (they hold the same shard),
    `mp_group` the ranks of one dp row (they render jointly); each is
    None in a world of one rank. `stats` is the rank's exchange cost;
    `host_buffers` the page-locked buffers its collectives stage through
    on gloo."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    backend: Optional[str]
    dp_group: object = None
    mp_group: object = None
    stats: ExchangeStats = dataclasses.field(default_factory=ExchangeStats)
    host_buffers: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              mp: Optional[int] = None, device="cuda") -> Mesh:
    """The (dp, mp) mesh of the current world, with gsl_tpu's defaults:
    mp = min(n, 4), dp = n // mp. `n_devices` defaults to the world size
    (the number of CUDA devices, or 1 on the CPU, before a process group
    exists). Every rank must call it: it creates the subgroups."""
    initialized = _initialized()
    dev = torch.device(device)
    n = n_devices
    if n is None:
        if initialized:
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if dp is None and mp is None:
        mp = min(n, 4)
        dp = n // mp
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    if dp * mp != n:
        raise ValueError(f"dp {dp} x mp {mp} != {n} devices")
    world = dist.get_world_size() if initialized else 1
    if world != n:
        raise ValueError(f"a mesh of {n} devices (dp {dp} x mp {mp}) in a "
                         f"world of {world} ranks")
    rank = dist.get_rank() if initialized else 0
    mesh = Mesh(dp=dp, mp=mp, rank=rank,
                device=rank_device(dev, local_rank()),
                backend=dist.get_backend() if initialized else None)
    if initialized and n > 1:
        # every rank creates every group, in the same order
        for i in range(dp):
            g = dist.new_group([i * mp + j for j in range(mp)])
            if i == mesh.dp_index:
                mesh.mp_group = g
        for j in range(mp):
            g = dist.new_group([i * mp + j for i in range(dp)])
            if j == mesh.mp_index:
                mesh.dp_group = g
    return mesh


# ---- collectives ----------------------------------------------------------

def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _group_size(mesh: Mesh, group) -> int:
    if group is None:
        return mesh.size
    return mesh.mp if group is mesh.mp_group else mesh.dp


PINNED_BUFFERS = 16          # host buffers kept (shapes change rarely)
PENDING_EVENTS = 64          # exchange timings kept unread on the card


def _host_buffer(mesh: Mesh, role: str, like: torch.Tensor) -> torch.Tensor:
    """A page-locked host tensor shaped like `like`, kept for the next
    call of the same role, shape and dtype."""
    bufs = mesh.host_buffers
    key = (role, tuple(like.shape), like.dtype)
    if key not in bufs:
        if len(bufs) >= PINNED_BUFFERS:
            bufs.clear()
        bufs[key] = torch.empty(like.shape, dtype=like.dtype,
                                pin_memory=True)
    return bufs[key]


def _staged(mesh: Mesh, x: torch.Tensor, op):
    """op(t, private) on the backend's device. On NCCL, or for a CPU `x`,
    t is `x` itself (private False: op must not write it). On gloo a CUDA
    `x` is copied into a page-locked host buffer (private True: op may
    write it, and take its result from `_host_buffer`), and op's result is
    copied back to the device; both copies are counted and timed."""
    if mesh.backend == "nccl" or not x.is_cuda:
        return op(x, False)
    t0 = time.perf_counter()
    host = _host_buffer(mesh, "in", x)
    host.copy_(x)
    mesh.stats.staging_s += time.perf_counter() - t0
    out = op(host, True)
    t0 = time.perf_counter()
    back = out.to(x.device)
    _sync(x.device)
    mesh.stats.staging_s += time.perf_counter() - t0
    mesh.stats.staged_copies += 2
    mesh.stats.staged_bytes += host.numel() * host.element_size() \
        + out.numel() * out.element_size()
    return back


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[n_mp, ...] -> [n_mp, ...] over the mp group: block i goes to mp
    peer i, and block i of the result came from peer i."""
    if mesh.mp == 1:
        return x

    def op(t, private):
        t = t.contiguous()
        out = (_host_buffer(mesh, "out", t) if private
               else torch.empty_like(t))
        dist.all_to_all_single(out, t, group=mesh.mp_group)
        return out

    return _staged(mesh, x, op)


def all_gather(mesh: Mesh, x: torch.Tensor, group) -> torch.Tensor:
    """[...] -> [n, ...]: every member's `x`, stacked in group order."""
    n = _group_size(mesh, group)
    if n == 1:
        return x[None]

    def op(t, private):
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t.contiguous(), group=group)
        return torch.stack(out)

    if x.dtype == torch.bool:          # gloo reduces no bool tensors
        return _staged(mesh, x.to(torch.uint8), op).to(torch.bool)
    return _staged(mesh, x, op)


def all_reduce(mesh: Mesh, x: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of `x` over `group` (None: the world), out of place."""
    if _group_size(mesh, group) == 1:
        return x

    def run(t, private):
        t = t if private else t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return _staged(mesh, x, run)


def broadcast_from_dp0(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Dp row 0's `x` on every rank of this rank's dp group."""
    if mesh.dp == 1:
        return x

    def run(t, private):
        t = t if private else t.clone()
        # the group's member in dp row 0 is global rank mp_index
        dist.broadcast(t, src=mesh.mp_index, group=mesh.dp_group)
        return t

    return _staged(mesh, x, run)


class _Exchange(torch.autograd.Function):
    """The payload all_to_all over the mp group; its backward is the same
    all_to_all of the cotangents (the transpose JAX derives)."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        begin = mesh.stats.start(x.device)
        out = all_to_all(mesh, x)
        mesh.stats.stop("fwd", begin, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        stats = ctx.mesh.stats
        begin = stats.start(g.device)
        out = all_to_all(ctx.mesh, g.contiguous())
        stats.stop("bwd", begin, g.device)
        return None, out


def exchange(mesh: Mesh, payload: torch.Tensor) -> torch.Tensor:
    """Differentiable all_to_all of [n_mp, K, D] over the mp group."""
    return _Exchange.apply(mesh, payload)


# ---- the sharded step -----------------------------------------------------

def pack_camera(cam: Cameras) -> torch.Tensor:
    """[16]: R (9), T (3), fx, fy, cx, cy."""
    return torch.cat([cam.R.reshape(9), cam.T.reshape(3),
                      torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]).reshape(
                          4)]).to(torch.float32)


def unpack_camera(v: torch.Tensor, width: int, height: int) -> Cameras:
    return Cameras(R=v[:9].reshape(3, 3), T=v[9:12], fx=v[12], fy=v[13],
                   cx=v[14], cy=v[15], width=width, height=height)


def _project_and_color(params: GaussianParams, alive, camera: Cameras,
                       img_height: int, img_width: int, sh_degree: int,
                       anti_aliased: bool, filter_2d: float):
    """The rank's shard projected for `camera`: the packed payload
    [N_local, 10] (means2d, conic, opacity x compensation, rgb, depth) and
    the radii [N_local]."""
    gstate = GaussianState(params=params, alive=alive)
    proj = project_gaussians(
        gstate.get_means(), gstate.get_scales(), gstate.get_rotations(),
        camera.world_to_camera, camera.fx, camera.fy, camera.cx, camera.cy,
        img_width, img_height, filter_2d=filter_2d)
    op = gstate.get_opacities()
    if anti_aliased:
        op = op * proj.compensations
    rgbs = sh_colors(gstate.get_means(), camera.camera_center,
                     params.shs_dc, params.shs_rest, sh_degree)
    payload = torch.cat([proj.means2d, proj.conics, op[:, None], rgbs,
                         proj.depths[:, None]], dim=-1)
    return payload, proj.radii


class StageTimer:
    """Marks between the sharded step's stages: CUDA events on the card,
    the host clock on the CPU. `ms()` gives each stage's milliseconds
    (from the previous mark)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.marks: List = []

    def mark(self, name: str):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = (a.elapsed_time(b) if self.device.type == "cuda"
                         else 1e3 * (b - a))
        return out


STAGES = ("proj", "compact", "exchange", "fwd", "bwd", "reduce_update")


def make_mp_train_step(
    mesh: Mesh,
    tx,
    img_height: int,
    img_width: int,
    sh_degree: int,
    tile_size: int = 16,
    isect_capacity: int = 1 << 16,
    max_per_tile: int = 512,
    chunk: int = 64,
    anti_aliased: bool = True,
    filter_2d: float = 0.3,
    lambda_dssim: float = 0.2,
    compact_k: Optional[int] = None,
    backend: str = "auto",
    fast_math: bool = True,
    with_masks: bool = False,
):
    """The sharded training step of this rank. `tx` is a `GaussianAdam`.

    Returns step(params, alive, opt_state, camera, gt, [mask,] bg,
    timer=None) -> (params, opt_state, loss, tap_grad_sum, radii_max,
    n_overflow) with the rank's shard in and out (params, alive, Adam
    moments: [cap_local, ...]), its own camera (one `Cameras` on its
    device), its ground truth [H, W, 3] and, with `with_masks`, its mask
    [H, W] (1 = keep). `loss` is the mean over the world's ranks, a 0-d
    tensor; `tap_grad_sum` [cap_local, 2] the means2d gradients summed
    over the mp cameras and the dp rows, `radii_max` [cap_local] int32
    the largest radius over the mp cameras of dp row 0, `n_overflow` the
    visible splats the top-K compaction dropped on every rank this step
    (a 0-d int64 tensor: the step reads nothing back to the host, and the
    caller reads it when it needs it). A `StageTimer` as `timer` is
    marked between the stages of `STAGES`."""
    n_mp = mesh.mp
    n_dev = mesh.size
    dev = mesh.device

    def step(params, alive, opt_state, camera, gt, *rest, timer=None):
        if with_masks:
            mask, bg = rest
        else:
            (bg,), mask = rest, None
        mark = timer.mark if timer is not None else (lambda name: None)
        cap_local = params.capacity
        k_eff = cap_local if compact_k is None else min(int(compact_k),
                                                        cap_local)
        with float32_math():
            mark("start")
            # every mp peer's camera: this dp row renders n_mp cameras
            packed = all_gather(mesh, pack_camera(camera).to(dev),
                                mesh.mp_group)
            cams_mp = [unpack_camera(packed[i], img_width, img_height)
                       for i in range(n_mp)]
            leaves = params.map(lambda _, x: x.detach().requires_grad_(True))
            tap = torch.zeros((n_mp, cap_local, 2), dtype=torch.float32,
                              device=dev, requires_grad=True)
            payloads, radii = [], []
            for i, cam in enumerate(cams_mp):
                p, r = _project_and_color(leaves, alive, cam, img_height,
                                          img_width, sh_degree, anti_aliased,
                                          filter_2d)
                payloads.append(torch.cat([p[:, 0:2] + tap[i], p[:, 2:]],
                                          dim=-1))
                radii.append(r)
            payload = torch.stack(payloads)           # [n_mp, cap_local, D]
            radii = torch.stack(radii)                # [n_mp, cap_local]
            mark("proj")
            # visible-first top-K compaction before the exchange
            n_visible = (radii > 0).sum(dim=1)
            overflow = torch.clamp(n_visible - k_eff, min=0).sum()
            radii_x = radii
            if k_eff < cap_local:
                order = torch.argsort((radii <= 0).to(torch.int8), dim=1,
                                      stable=True)[:, :k_eff]
                payload = torch.gather(
                    payload, 1, order[..., None].expand(-1, -1,
                                                        payload.shape[-1]))
                radii_x = torch.gather(radii, 1, order)
            mark("compact")
            # [n_mp cameras, K, D] -> [n_mp shards, K, D] of MY camera
            payload = exchange(mesh, payload)
            radii_x = all_to_all(mesh, radii_x)
            mark("exchange")
            n_total = n_mp * k_eff
            payload = payload.reshape(n_total, payload.shape[-1])
            radii_full = radii_x.reshape(n_total)
            proj = Projections(
                means2d=payload[:, 0:2], depths=payload[:, 9],
                radii=radii_full, conics=payload[:, 2:5],
                compensations=torch.ones(n_total, dtype=payload.dtype,
                                         device=dev),
                mask=radii_full > 0)
            img_nobg, alpha, _ = rasterize(
                proj, payload[:, 5], payload[:, 6:9], img_height, img_width,
                tile_size)
            img = img_nobg + (1.0 - alpha)[..., None] * bg[None, None]
            loss, _ = train_loss(img, gt, mask_hw=mask,
                                 lambda_dssim=lambda_dssim)
            mark("fwd")
            fields = leaves.fields()
            grads = torch.autograd.grad(
                loss, [getattr(leaves, k) for k in fields] + [tap])
            mark("bwd")
        # the dp rows hold the same shard: sum their contributions, all
        # gradients in one call
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = all_reduce(mesh, flat, mesh.dp_group)
        sizes = [g.numel() for g in grads]
        parts = torch.split(flat, sizes)
        pgrads = GaussianParams(**{
            k: parts[i].reshape(grads[i].shape)
            for i, k in enumerate(fields)})
        tap_grads = parts[-1].reshape(grads[-1].shape)
        # the reported loss is the world's mean; the overflow its sum
        scalars = all_reduce(mesh, torch.stack([
            loss.detach(), overflow.to(torch.float32)]), None)
        tap_grad_sum = tap_grads.sum(dim=0)
        radii_max = broadcast_from_dp0(mesh, radii.max(dim=0).values)
        with torch.no_grad():
            updates, opt_state = tx.update(pgrads, opt_state)
            params = params.map(lambda k, x: x + getattr(updates, k))
        mark("reduce_update")
        return (params, opt_state, scalars[0] / n_dev, tap_grad_sum,
                radii_max, scalars[1].round().to(torch.int64))

    return step


def exchange_bytes_per_step(n_devices: int, n_mp: int, k_eff: int,
                            payload_dim: int = PAYLOAD_DIM) -> int:
    """Bytes between ranks per step in the splat exchange: every rank ships
    (n_mp - 1)/n_mp of its [n_mp, K, D] payload + [n_mp, K] radii (the
    diagonal block stays local)."""
    per_dev = n_mp * k_eff * (payload_dim + 1) * 4
    return n_devices * per_dev * (n_mp - 1) // n_mp


def rebalance_permutation(alive: torch.Tensor, n_mp: int) -> torch.Tensor:
    """A permutation `perm` ([CAP] int64, use as ``new_x = x[perm]``) that
    deals the alive slots round-robin over the n_mp equal shard segments,
    so every shard holds within +-1 of the mean alive count; dead slots
    fill the rest in slot order."""
    cap = alive.shape[0]
    S = cap // n_mp
    dev = alive.device
    n_alive = alive.to(torch.int64).sum()
    # slot ids, alive first (stable: relative order kept)
    order = torch.argsort((~alive).to(torch.int8), stable=True)
    # position p = s*S + k holds alive rank k*n_mp + s while that exists
    p = torch.arange(cap, device=dev)
    s = p // S
    k = p % S
    alive_rank = k * n_mp + s
    is_alive_pos = alive_rank < n_alive
    dead_pos_rank = torch.cumsum((~is_alive_pos).to(torch.int64), 0) - 1
    src_sorted = torch.where(is_alive_pos, alive_rank,
                             n_alive + dead_pos_rank)
    return order[src_sorted]


def _take_rows(x, perm, cap: int):
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == cap:
        return x[perm]
    return x


def apply_permutation(perm: torch.Tensor, params: GaussianParams,
                      alive: torch.Tensor, opt_state: AdamState,
                      density: Optional[DensityControlState] = None):
    """Every [CAP, ...] tensor (parameters, Adam moments, density
    statistics) gathered by `perm`."""
    cap = alive.shape[0]
    params = params.map(lambda _, x: _take_rows(x, perm, cap))
    opt_state = dataclasses.replace(
        opt_state,
        exp_avg={k: _take_rows(v, perm, cap)
                 for k, v in opt_state.exp_avg.items()},
        exp_avg_sq={k: _take_rows(v, perm, cap)
                    for k, v in opt_state.exp_avg_sq.items()})
    if density is not None:
        density = DensityControlState(**{
            f.name: _take_rows(getattr(density, f.name), perm, cap)
            for f in dataclasses.fields(density)})
    return params, alive[perm], opt_state, density


def shard_alive_counts(alive: torch.Tensor, n_mp: int) -> np.ndarray:
    """[n_mp] alive rows per shard of the global `alive` (host side)."""
    a = alive.detach().cpu().numpy().astype(np.int64)
    return a.reshape(n_mp, -1).sum(axis=1)


def shard_rows(mesh: Mesh, x):
    """This rank's rows [mp_index * cap_local, ... + cap_local) of a
    [CAP, ...] tensor, on its device; anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    cap_local = x.shape[0] // mesh.mp
    lo = mesh.mp_index * cap_local
    return x[lo:lo + cap_local].to(mesh.device)


def shard_params(mesh: Mesh, params: GaussianParams, alive: torch.Tensor,
                 opt_state: AdamState):
    """This rank's shard of the global state: rows split over mp,
    replicated over dp."""
    return (params.map(lambda _, x: shard_rows(mesh, x)),
            shard_rows(mesh, alive),
            dataclasses.replace(
                opt_state,
                exp_avg={k: shard_rows(mesh, v)
                         for k, v in opt_state.exp_avg.items()},
                exp_avg_sq={k: shard_rows(mesh, v)
                            for k, v in opt_state.exp_avg_sq.items()}))


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mp shards of `x` joined in shard order: [CAP, ...] on every
    rank of the row (the inverse of `shard_rows`)."""
    g = all_gather(mesh, x, mesh.mp_group)
    return g.reshape((g.shape[0] * x.shape[0],) + tuple(x.shape[1:]))


def gather_params(mesh: Mesh, params: GaussianParams, alive: torch.Tensor,
                  opt_state: AdamState):
    """The inverse of `shard_params`."""
    return (params.map(lambda _, x: gather_rows(mesh, x)),
            gather_rows(mesh, alive),
            dataclasses.replace(
                opt_state,
                exp_avg={k: gather_rows(mesh, v)
                         for k, v in opt_state.exp_avg.items()},
                exp_avg_sq={k: gather_rows(mesh, v)
                            for k, v in opt_state.exp_avg_sq.items()}))
