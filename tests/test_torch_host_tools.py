"""gsl_tpu_torch's last host tools against the repo-root tools on the same
files: eval_scenes (its aggregation, and a real validate of a port run),
sfm_outlier_detection and meganerf2colmap; the PLY reader against
gsl_tpu's on every layout; and the native points3D.bin reader against its
plain Python version."""
import csv
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gsl_tpu_torch import cli, native
from gsl_tpu_torch.data import colmap_io
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, qvec_to_rotmat,
                                          read_model, rotmat_to_qvec,
                                          write_model_bin)
from gsl_tpu_torch.tools import eval_scenes, meganerf2colmap
from gsl_tpu_torch.tools import sfm_outlier_detection

import torch_port_utils  # noqa: F401  (one intra-op thread)
from test_torch_fit_e2e import REPO, make_dataset

sys.path.insert(0, os.path.join(REPO, "tools"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---- eval_scenes ----------------------------------------------------------

def _write_metrics(run_dir, rows, lpips):
    os.makedirs(os.path.join(run_dir, "metrics"))
    with open(os.path.join(run_dir, "metrics", "val.csv"), "w",
              newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["name", "psnr", "ssim",
                     "lpips" if lpips else "lpips(unavailable)"])
        wr.writerows(rows)
        m = np.mean(np.asarray([r[1:] for r in rows], float), axis=0) \
            if lpips else np.mean(np.asarray([r[1:3] for r in rows], float),
                                  axis=0)
        wr.writerow(["MEAN", *m] if lpips else ["MEAN", *m, ""])


def test_eval_scenes_aggregation_writes_the_root_tools_bytes(
        tmp_path, capsys):
    """--skip-validate over one scene with LPIPS and one without: the
    same summary CSV and table as tools/eval_scenes.py."""
    import eval_scenes as root_eval_scenes

    runs = str(tmp_path / "runs")
    rng = np.random.RandomState(0)
    _write_metrics(os.path.join(runs, "a"),
                   [[f"v{i}", *rng.uniform(20, 30, 1), *rng.uniform(0.5, 1,
                                                                    1),
                     *rng.uniform(0.1, 0.3, 1)] for i in range(3)], True)
    _write_metrics(os.path.join(runs, "b"),
                   [[f"v{i}", *rng.uniform(20, 30, 1),
                     *rng.uniform(0.5, 1, 1), ""] for i in range(2)], False)
    args = ["--output", runs, "--scenes", "a", "b", "--skip-validate"]
    root_eval_scenes.main(args + ["--out", str(tmp_path / "root.csv")])
    want = capsys.readouterr().out
    got_rows = eval_scenes.main(args + ["--out", str(tmp_path / "port.csv"),
                                        "--device", "cpu"])
    got = capsys.readouterr().out
    assert _bytes(tmp_path / "port.csv") == _bytes(tmp_path / "root.csv")
    assert got.replace("port.csv", "root.csv") == want
    assert [r[0] for r in got_rows] == ["a", "b"] and got_rows[1][3] != \
        got_rows[1][3]      # no LPIPS: NaN


def test_eval_scenes_validates_a_port_run_on_the_cpu(tmp_path):
    """Without --skip-validate the port's `cli validate` scores the run
    again on the CPU, and its MEAN row is the summary's."""
    data = str(tmp_path / "ds")
    make_dataset(data)
    runs = str(tmp_path / "runs")
    cli.main(["fit", "--config", os.path.join(
        REPO, "gsl_tpu_torch", "configs", "blender.yaml"),
        "--data.path", data, "--output", runs, "-n", "scene_a",
        "--max_steps", "4", "--device", "cpu",
        "data.parser.init_args.random_point_count=200",
        "data.parser.init_args.white_background=false",
        "trainer.background_color=[0,0,0]", "fit.min_capacity=1024",
        "model.gaussian.sh_degree=0"])
    csv_path = os.path.join(runs, "scene_a", "metrics", "val.csv")
    os.remove(csv_path)
    (row,) = eval_scenes.main(["--output", runs, "--scenes", "scene_a",
                               "--device", "cpu"])
    assert row[:3] == ("scene_a",) + eval_scenes.read_mean_row(csv_path)[:2]
    assert 5.0 < row[1] < 60.0
    with open(os.path.join(runs, "eval_summary.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["scene", "psnr", "ssim", "lpips"]
    assert rows[1][0] == "scene_a" and rows[-1][0] == "MEAN"


# ---- sfm_outlier_detection ------------------------------------------------

def _ring_scene(root, n=14, planted=2):
    """n cameras on a ring of radius 4 looking at a cloud at the origin,
    and `planted` mis-registered ones far off; -> their centres."""
    rng = np.random.RandomState(3)
    images, centres = {}, {}
    for i in range(n + planted):
        if i < n:
            a = 2 * np.pi * i / n
            pos = np.array([4 * np.sin(a), rng.uniform(-0.3, 0.3),
                            -4 * np.cos(a)])
        else:
            pos = np.array([300.0 + 40 * i, 250.0, -400.0])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        if i >= n:
            R = np.eye(3)                  # looking away from the cloud
        name = f"img_{i:03d}.png"
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(R), -R @ pos, 1,
                                    name)
        centres[name] = pos
    pts = rng.normal(scale=0.8, size=(3000, 3))
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", 64, 48,
                                 np.array([50.0, 50.0, 32.0, 24.0]))},
        images=images, points_xyz=pts,
        points_rgb=rng.randint(0, 256, (3000, 3)).astype(np.uint8),
        points_err=rng.uniform(0, 1, 3000)),
        os.path.join(root, "sparse", "0"))
    return centres


@pytest.mark.parametrize("gps", [False, True])
def test_sfm_outlier_detection_matches_the_root_tool(tmp_path, gps,
                                                     monkeypatch, capsys):
    """The planted cameras and nothing else are flagged, and the file is
    the root tool's; with GPS priors (a similarity transform of the
    centres, one prior moved) the moved image is flagged too."""
    import sfm_outlier_detection as root_sfm

    root = str(tmp_path)
    centres = _ring_scene(root)
    args = [root]
    if gps:
        c, s = np.cos(0.4), np.sin(0.4)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        priors = {k: (2.5 * R @ v + [10.0, -3.0, 7.0]).tolist()
                  for k, v in centres.items()
                  if not k.startswith(("img_014", "img_015"))}
        priors["img_005.png"][0] += 30.0
        with open(os.path.join(root, "gps.json"), "w") as f:
            import json
            json.dump(priors, f)
        args += ["--gps-priors", os.path.join(root, "gps.json")]
    monkeypatch.setattr(sys, "argv", ["sfm_outlier_detection"] + args)
    root_sfm.main()
    want = _bytes(os.path.join(root, "sfm_outliers.txt"))
    capsys.readouterr()
    os.remove(os.path.join(root, "sfm_outliers.txt"))
    flagged = sfm_outlier_detection.main(args)
    assert _bytes(os.path.join(root, "sfm_outliers.txt")) == want
    expect = ["img_014.png", "img_015.png"]
    if gps:
        expect = ["img_005.png"] + expect
    assert flagged == expect
    with pytest.raises(SystemExit):
        sfm_outlier_detection.main(args + ["--device", "cpu"])


# ---- meganerf2colmap ------------------------------------------------------

def _mega_capture(root, rng):
    torch.save({"pose_scale_factor": 2.5,
                "origin_drb": torch.tensor([1.0, -2.0, 3.0],
                                           dtype=torch.float64)},
               os.path.join(root, "coordinates.pt"))
    poses = {}
    for split, n in (("train", 4), ("val", 2)):
        os.makedirs(os.path.join(root, split, "metadata"))
        os.makedirs(os.path.join(root, split, "rgbs"))
        for i in range(n):
            q = rng.normal(size=4)
            c2w = np.concatenate([qvec_to_rotmat(q / np.linalg.norm(q)),
                                  rng.normal(size=(3, 1))], 1)
            name = f"{split}{i:02d}"
            intr = [50.0, 50.0, 16.0, 12.0] if i % 2 else [60.0, 60.0, 16.0,
                                                            12.0]
            torch.save({"c2w": torch.tensor(c2w, dtype=torch.float64),
                        "intrinsics": torch.tensor(intr),
                        "W": 32, "H": 24},
                       os.path.join(root, split, "metadata", name + ".pt"))
            ext = ".jpg" if i % 2 else ".png"
            Image.fromarray(np.zeros((24, 32, 3), np.uint8)).save(
                os.path.join(root, split, "rgbs", name + ext))
            poses[name + ext] = c2w
    return poses


def mega_pose(qvec, tvec, scale, origin):
    """COLMAP's (qvec, tvec) -> Mega-NeRF's c2w [3, 4]: convert_pose
    undone."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec_to_rotmat(qvec)
    w2c[:3, 3] = tvec
    M = meganerf2colmap.C2W_TRANSFORM @ meganerf2colmap.RDF_TO_DRB
    c2w = meganerf2colmap.RDF_TO_DRB @ np.linalg.inv(w2c) @ np.linalg.inv(M)
    c2w[:3, 3] = (c2w[:3, 3] - origin) / scale
    return c2w[:3]


def test_meganerf2colmap_writes_the_root_tools_bytes(tmp_path, monkeypatch):
    """The three .bin files byte for byte, the same image links, and poses
    that convert back to the capture's within 1e-9."""
    import meganerf2colmap as root_mega

    root = str(tmp_path)
    poses = _mega_capture(root, np.random.RandomState(7))
    monkeypatch.setattr(sys, "argv", ["meganerf2colmap", root, "--out",
                                      "root", "--seed-points", "300"])
    root_mega.main()
    meganerf2colmap.main([root, "--out", "port", "--seed-points", "300"])
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert _bytes(os.path.join(root, "port", "sparse", "0", f)) == \
            _bytes(os.path.join(root, "root", "sparse", "0", f)), f
    links = sorted(os.listdir(os.path.join(root, "port", "images")))
    assert links == sorted(os.listdir(os.path.join(root, "root", "images")))
    assert links == sorted(poses)
    for name in links:
        assert os.readlink(os.path.join(root, "port", "images", name)) == \
            os.readlink(os.path.join(root, "root", "images", name))
    model = read_model(os.path.join(root, "port", "sparse", "0"))
    assert len(model.cameras) == 2 and model.points_xyz.shape == (300, 3)
    for im in model.images.values():
        np.testing.assert_allclose(
            mega_pose(im.qvec, im.tvec, 2.5, np.array([1.0, -2.0, 3.0])),
            poses[im.name], atol=1e-9, rtol=0)
    with pytest.raises(SystemExit):
        meganerf2colmap.main([root, "--device", "cpu"])


# ---- the PLY reader --------------------------------------------------------

def _ply_bytes(layout, n, seed):
    """A Gaussian PLY in `layout`: its properties' names, types and
    values, as a file's bytes."""
    rng = np.random.RandomState(seed)
    n_rest = 0 if layout == "degree0" else 45
    n_scale = 2 if layout == "surfel" else 3
    names = (["x", "y", "z"] + ([] if layout == "no_normals"
                                else ["nx", "ny", "nz"])
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(n_rest)] + ["opacity"]
             + [f"scale_{i}" for i in range(n_scale)]
             + [f"rot_{i}" for i in range(4)]
             + (["extra_label"] if layout == "extra" else []))
    types = ["double" if layout == "mixed" and nm in "xyz" else "float"
             for nm in names]
    if layout == "extra":
        types[-1] = "uchar"
    values = rng.normal(size=(n, len(names)))
    if layout == "extra":
        values[:, -1] = rng.randint(0, 255, n)
    fmt = {"ascii": "ascii", "big": "binary_big_endian"}.get(
        layout, "binary_little_endian")
    head = (["ply", f"format {fmt} 1.0", f"element vertex {n}"]
            + [f"property {t} {nm}" for t, nm in zip(types, names)]
            + ["end_header"])
    body = "\n".join(head).encode() + b"\n"
    if fmt == "ascii":
        return body + "".join(" ".join(f"{v:.9g}" for v in row) + "\n"
                              for row in values).encode()
    code = {"float": "f4", "double": "f8", "uchar": "u1"}
    end = ">" if fmt == "binary_big_endian" else "<"
    rec = np.empty(n, dtype=[(nm, end + code[t]) for nm, t in
                             zip(names, types)])
    for i, nm in enumerate(names):
        rec[nm] = values[:, i]
    return body + rec.tobytes()


@pytest.mark.parametrize("layout", ["float", "ascii", "mixed", "big",
                                    "surfel", "degree0", "no_normals",
                                    "extra"])
def test_ply_reader_matches_jax_on_every_layout(tmp_path, layout):
    """The port's reader (one [n, P] view of an all-float32 file, a
    gather per property group) gives gsl_tpu's arrays on every layout its
    reader takes."""
    from gsl_tpu.utils.ply import load_gaussian_ply as jax_load
    from gsl_tpu_torch.utils.ply import load_gaussian_ply

    path = str(tmp_path / "g.ply")
    with open(path, "wb") as f:
        f.write(_ply_bytes(layout, 37, seed=len(layout)))
    got, want = load_gaussian_ply(path), jax_load(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- the native points3D.bin reader ---------------------------------------

def _write_points_with_tracks(path, n, seed):
    rng = np.random.RandomState(seed)
    xyz = rng.normal(size=(n, 3))
    rgb = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, n)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<q", 1000 + i))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *rgb[i]))
            f.write(struct.pack("<d", err[i]))
            k = int(rng.randint(0, 6))
            f.write(struct.pack("<Q", k))
            f.write(struct.pack(f"<{2 * k}i", *rng.randint(0, 99, 2 * k)))
    return xyz, rgb, err


@pytest.mark.parametrize("n", [0, 1, 2500])
def test_native_reader_equals_the_plain_reader(tmp_path, n):
    path = str(tmp_path / "points3D.bin")
    want = _write_points_with_tracks(path, n, seed=n)
    got = colmap_io.read_points3d_bin(path)
    plain = colmap_io.read_points3d_bin_plain(path)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)


def test_native_reader_raises_on_a_short_file(tmp_path):
    path = str(tmp_path / "points3D.bin")
    _write_points_with_tracks(path, 50, seed=1)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="ends early"):
        colmap_io.read_points3d_bin(path)
    with pytest.raises(OSError, match="cannot read"):
        colmap_io.read_points3d_bin(str(tmp_path / "missing.bin"))


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler-gsl"])
def test_native_reader_raises_when_the_build_fails(tmp_path, monkeypatch,
                                                   compiler):
    """A failing g++ (or none) raises with what it said; nothing falls
    back to the Python reader."""
    path = str(tmp_path / "points3D.bin")
    _write_points_with_tracks(path, 5, seed=2)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", compiler)
    with pytest.raises(RuntimeError, match="native reader build failed"):
        colmap_io.read_points3d_bin(path)
    assert not list((tmp_path / "build").glob("*.so"))
