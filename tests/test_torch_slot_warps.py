"""The count of (slot, warp)s in which some pixel composites the slot: the
units in which the backward kernels K3s and K7 sum a gradient row over a
warp (`ops.rasterize.slot_warps`, reported by the plain versions' `stats`).
CPU only."""
import numpy as np
import torch

from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.surfel import project_surfels
from gsl_tpu_torch.utils.convert import state_from_raw_arrays


def test_slot_warps_counts_each_warp_of_a_tile_once():
    comp = torch.zeros((2, 72, 3), dtype=torch.bool)   # 72 pixels: 3 warps
    comp[0, 0, 0] = comp[0, 31, 0] = True     # one warp, twice
    comp[0, 32, 1] = comp[0, 70, 1] = True    # the second and the ragged third
    comp[1, 64, 2] = True
    assert int(R.slot_warps(comp)) == 4
    assert int(R.slot_warps(torch.zeros((1, 64, 16), dtype=torch.bool))) == 0


def test_stp_plain_backward_counts_the_warps_a_slot_composites_in():
    """An 8x8 tile is two warps of four rows. A small Gaussian at row 1
    composites in the first alone, one at row 4 in both."""
    means2d = torch.tensor([[4.0, 1.0], [4.0, 4.0]])
    conics = torch.tensor([[2.0, 0.0, 2.0], [2.0, 0.0, 2.0]])
    opac = torch.tensor([0.9, 0.9])
    ch = torch.rand((2, 3), generator=torch.Generator().manual_seed(0))
    depths, kz = torch.tensor([1.0, 2.0]), torch.zeros((2, 2))
    gids = torch.tensor([0, 1], dtype=torch.int32)
    bounds = torch.tensor([0, 2], dtype=torch.int64)
    args = (means2d, conics, opac, ch, depths, kz, gids, bounds)
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp_plain(*args, 8, 8, 8,
                                                   checkpoints=True)
    stats = {}
    STP.rasterize_bwd_stp_plain(*args, torch.ones((8, 8, 3)),
                                torch.ones((8, 8)), t_fin, ckpt, 8,
                                stats=stats)
    assert stats["composited_slot_warps"] == 3
    assert 0 < stats["composited_pairs"] <= 2 * 64


def test_surfel_plain_backward_counts_slot_warps_between_pairs_and_slots():
    """Each composited (slot, warp) holds 1 to 32 composited pairs."""
    rng = np.random.RandomState(4)
    n = 60
    arrays = {k: v.astype(np.float32) for k, v in dict(
        means=np.concatenate([rng.uniform(-1, 1, (n, 2)),
                              rng.uniform(2, 6, (n, 1))], 1),
        scales=rng.uniform(-3.0, -1.5, (n, 2)),
        rotations=rng.normal(size=(n, 4)),
        opacities=rng.uniform(-1, 2, (n, 1)),
        shs_dc=rng.normal(size=(n, 1, 3)) * 0.3,
        shs_rest=rng.normal(size=(n, 15, 3)) * 0.1).items()}
    state = state_from_raw_arrays(arrays, device="cpu")
    h, w, ts = 32, 48, 16
    c2w = np.eye(4)
    proj = project_surfels(
        state.get_means(), state.get_scales(), state.get_rotations(),
        torch.tensor(np.linalg.inv(c2w), dtype=torch.float32), 40.0, 40.0,
        w / 2, h / 2, w, h)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    ch = torch.rand((geom.shape[0], 3),
                    generator=torch.Generator().manual_seed(1))
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii, h,
                                    w, ts)
    keys, gids = SR.surfel_expand_plain(isects, proj.depths, -(-w // ts),
                                        -(-h // ts))
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, -(-w // ts) * -(-h // ts))
    _, aux, stop = SR.rasterize_surfels_fwd_plain(geom, ch, gs, bounds, h, w,
                                                  ts)
    stats = {}
    SR.rasterize_surfels_bwd_plain(geom, ch, gs, bounds, torch.ones((h, w, 3)),
                                   torch.ones((3, h, w)), aux, stop, ts,
                                   stats=stats)
    pairs, warps = stats["composited_pairs"], stats["composited_slot_warps"]
    assert 0 < warps <= pairs <= 32 * warps
    assert warps <= int(bounds[-1]) * (ts * ts // 32)
