"""The slot kernels K1 (`csrc/expand.cu`), K4 (`csrc/reduce_grads.cu`) and
K5 (`csrc/surfel_expand.cu`), their CUDA sources run on the CPU with the
stand-in runtime of `test_torch_kernel_emulation.py` (one host thread per
CUDA thread, the blocks one after another, no multiply-add contraction).

K1's keys and ids must equal `expand_plain` bit for bit, with and without
StopThePop keys: the kernel rounds as PyTorch does (-fmad=false on the
card). K4's sums must equal, bit for bit, float32 sums taken in slot order
(`reduce_grads_slot_order`): that is the order one thread walking a
Gaussian's slots adds them in, and the kernel's runs and staging passes
must keep it. They must also agree with `reduce_grads_plain` (`index_add_`,
another order) within chip_smoke's SUM_RTOL of the summed magnitudes. The
edge cases: a Gaussian count that fills no run evenly, empty rectangles
(one dummy slot each), a rectangle of 40 x 40 tiles (more slots than a
staging pass of K4 and a run of K1 hold), every slot without a row, fewer
valid rows than slots, and R = 9, 14, 19, 33 and 300 columns (more than
a block has threads) with no or two absolute columns.

K5's keys and ids must equal `surfel_expand_plain` bit for bit (integer
work and one max) on K1's projections as surfels and on the cases of
`slot_cases.K5_CASES` made by hand: rectangles whose rows pass tiles_y
(the row clamp), one surfel, none. It must refuse a rect that is not
16-byte aligned and tiles that could overflow a run's int slot count."""
import ctypes

import pytest
import torch

import slot_cases
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import surfel_rasterize as SR
from test_torch_kernel_emulation import build_host_libs

SUM_RTOL = 1e-5   # chip_smoke.SUM_RTOL


@pytest.fixture(scope="module")
def slot_libs(tmp_path_factory):
    return build_host_libs(("expand", "reduce_grads", "surfel_expand"),
                           tmp_path_factory.mktemp("emulated_slots"))


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _expand_code(lib, args):
    """gsl_expand's return code and the keys and ids it wrote."""
    isects, m2d, con, op, depths, tiles_x, tiles_y, ts, cull, stp, kz = args
    keys = torch.full((isects.total,), -1, dtype=torch.int64)
    gids = torch.full((isects.total,), -1, dtype=torch.int32)
    fn = lib.gsl_expand
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 3
    code = fn(_p(isects.offsets), _p(isects.rect), _p(depths), _p(m2d),
              _p(con), _p(op), _p(kz), m2d.shape[0], ts, tiles_x, tiles_y,
              int(cull), int(stp), _p(keys), _p(gids), None)
    return code, keys, gids


def _expand(lib, args):
    code, keys, gids = _expand_code(lib, args)
    assert code == 0
    return keys, gids


@pytest.mark.parametrize("stp", [False, True], ids=["depth", "stp"])
@pytest.mark.parametrize("case", sorted(slot_cases.K1_CASES))
def test_k1_source_equals_plain(slot_libs, case, stp):
    args = slot_cases.expand_args(case, stp=stp)
    isects = args[0]
    hits = isects.rect[:, 2] * isects.rect[:, 3]
    assert bool((hits == 0).any())          # dummy slots
    keys, gids = _expand(slot_libs["expand"], args)
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    culled = (keys == R.INVALID_KEY).sum() - (hits == 0).sum()
    assert int(culled) > 0                  # the cull decided something
    if case == "tile4-big":
        assert int(hits.max()) == 1600


def test_k1_source_equals_plain_without_culling(slot_libs):
    args = slot_cases.expand_args("tile16", culling=False)
    keys, gids = _expand(slot_libs["expand"], args)
    keys_p, gids_p = R.expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)


def _reduce_fn(lib):
    fn = lib.gsl_reduce_grads
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _reduce(lib, rows, offsets, inv_order, n_valid, n, n_abs):
    out = torch.full((n, rows.shape[1] + n_abs), float("nan"))
    assert _reduce_fn(lib)(_p(rows), rows.shape[1], n_abs, _p(offsets),
                           inv_order.numel(), _p(inv_order), _p(n_valid), n,
                           _p(out), None) == 0
    return out


@pytest.mark.parametrize("n_abs", [0, 2])
@pytest.mark.parametrize("n_cols", [9, 14, 19, 33, 300])
def test_k4_source_sums_in_slot_order(slot_libs, n_cols, n_abs):
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(n_cols)
    got = _reduce(slot_libs["reduce_grads"], rows, offsets, inv, n_valid, n,
                  n_abs)
    want = R.reduce_grads_slot_order(rows, offsets, inv, n_valid, n, n_abs)
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())  # never -0.0
    plain = R.reduce_grads_plain(rows, gids, n, n_abs)
    into = R.reduce_grads_plain(rows.abs(), gids, n, n_abs)
    assert bool(((got - plain).abs() <= SUM_RTOL * into).all())


@pytest.mark.parametrize("n_cols", [9, 33, 300])
def test_k4_source_with_gaussians_without_slots(slot_libs, n_cols):
    """Zeros for a Gaussian without slots where a staging pass begins or a
    run of several passes ends, not what the output held before."""
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(
        n_cols, without_slots=True)
    got = _reduce(slot_libs["reduce_grads"], rows, offsets, inv, n_valid, n,
                  2)
    want = R.reduce_grads_slot_order(rows, offsets, inv, n_valid, n, 2)
    assert torch.equal(got, want)
    assert torch.equal(got[1::2], torch.zeros_like(got[1::2]))
    assert not bool(torch.signbit(got[1::2]).any())


def test_k4_source_with_no_valid_slot(slot_libs):
    rows, gids, offsets, inv, n_valid, n = slot_cases.reduce_args(
        9, all_invalid=True)
    got = _reduce(slot_libs["reduce_grads"], rows, offsets, inv, n_valid, n,
                  2)
    assert torch.equal(got, torch.zeros_like(got))
    assert not bool(torch.signbit(got).any())


def test_k4_source_refuses_what_it_does_not_take(slot_libs):
    rows, _, offsets, inv, n_valid, n = slot_cases.reduce_args(9)
    fn = _reduce_fn(slot_libs["reduce_grads"])
    out = torch.empty((n, 12))
    # absolute sums of more columns than the geometry's
    assert fn(_p(rows), 9, 7, _p(offsets), inv.numel(), _p(inv),
              _p(n_valid), n, _p(out), None) != 0
    # rows too wide for a pass of one slot in 48 KB of shared memory
    assert fn(_p(rows), 5000, 0, _p(offsets), inv.numel(), _p(inv),
              _p(n_valid), n, _p(out), None) != 0


def test_k1_source_refuses_a_misaligned_rect(slot_libs):
    args = slot_cases.expand_args("tile16")
    isects = args[0]
    rect = torch.empty(isects.rect.numel() + 1, dtype=torch.int32)[1:]
    rect = rect.view(-1, 4).copy_(isects.rect)
    assert rect.is_contiguous() and rect.data_ptr() % 16 != 0
    code, _, _ = _expand_code(slot_libs["expand"],
                              (isects._replace(rect=rect), *args[1:]))
    assert code != 0


def _misaligned(rect):
    """A copy of rect that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(rect.numel() + 1, dtype=torch.int32)[1:]
    out = out.view(-1, 4).copy_(rect)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def _surfel_expand_code(lib, isects, depths, tiles_x, tiles_y):
    """gsl_expand_surfel's return code and the keys and ids it wrote."""
    keys = torch.full((isects.total,), -1, dtype=torch.int64)
    gids = torch.full((isects.total,), -1, dtype=torch.int32)
    fn = lib.gsl_expand_surfel
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    code = fn(_p(isects.offsets), _p(isects.rect), _p(depths),
              depths.shape[0], tiles_x, tiles_y, _p(keys), _p(gids), None)
    return code, keys, gids


@pytest.mark.parametrize("case", slot_cases.K5_CASES)
def test_k5_source_equals_plain(slot_libs, case):
    args = slot_cases.surfel_expand_args(case)
    code, keys, gids = _surfel_expand_code(slot_libs["surfel_expand"], *args)
    assert code == 0
    keys_p, gids_p = SR.surfel_expand_plain(*args)
    assert torch.equal(keys, keys_p) and torch.equal(gids, gids_p)
    rect = args[0].rect
    hits = rect[:, 2] * rect[:, 3]
    # only the empty rectangles' dummy slots are invalid: no cull
    assert int((keys == R.INVALID_KEY).sum()) == int((hits == 0).sum())
    if case in slot_cases.K1_CASES:
        assert bool((hits == 0).any())
    if case == "tile4-big":
        assert int(hits.max()) == 1600
    if case == "one-surfel":
        assert keys.numel() > 128           # more slots than threads
    if case == "rows-past-tiles_y":         # the clamp decided rows
        rows = (keys[keys != R.INVALID_KEY] >> 32) // args[2]
        assert int(rows.max()) == args[3] - 1
        assert int((keys & 0xFFFFFFFF == 0).sum()) > 0   # depths below 0


def test_k5_source_refuses_what_it_does_not_take(slot_libs):
    lib = slot_libs["surfel_expand"]
    isects, depths, tiles_x, tiles_y = slot_cases.surfel_expand_args(
        "tile16")
    code, keys, _ = _surfel_expand_code(
        lib, isects._replace(rect=_misaligned(isects.rect)), depths,
        tiles_x, tiles_y)
    assert code != 0 and bool((keys == -1).all())
    # a run of 128 surfels over 2^24 tiles could hold more than 2^31 slots
    code, keys, _ = _surfel_expand_code(lib, isects, depths, 4096, 4097)
    assert code != 0 and bool((keys == -1).all())
