"""The port's map-building front ends against the JAX package's.

An 8-image ``utils/synth.py`` corridor scene (256 keypoints per image,
C = 128) is written to HDF5 once. Each port CLI runs with ``--device cpu``
beside its JAX counterpart: ``pairs_from`` (covisibility, poses, retrieval)
→ ``match_features`` (NNM and NNR) → ``triangulation --export_database``.
Pair files and the database tables must be equal, matches equal (the
scene has no exact ties) and the map must meet the bars of
``tests/test_torch_map_build.py``. The port's ``reconstruction`` CLI is
held to ground truth with the bars of that file: the JAX run of an
incremental reconstruction spends ~25 s compiling on the CPU, which this
file's time budget does not hold.
"""

import sqlite3

import numpy as np
import pytest
import torch

from sfd2_torch.cli import match_features as t_match
from sfd2_torch.cli import pairs_from as t_pairs
from sfd2_torch.cli import reconstruction as t_recon
from sfd2_torch.cli import triangulation as t_tri
from sfd2_torch.geometry.np_pose import camera_center
from sfd2_torch.io.colmap_model import Image, read_model, write_model
from sfd2_torch.io.feature_store import FeatureStore, MatchStore, names_to_pair
from sfd2_torch.io import pairs as t_io_pairs
from sfd2_torch.io.pairs import read_pairs
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu.cli import match_features as j_match
from sfd2_tpu.cli import pairs_from as j_pairs
from sfd2_tpu.cli import triangulation as j_tri
from sfd2_tpu.io import pairs as j_io_pairs
from test_torch_map_build import _umeyama

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_cli")
    with FeatureStore(base / "feats.h5", "w") as fs:
        scene = build_corridor_scene(fs, n_images=8, n_queries=0, n_points=600, desc_dim=128,
                                     kp_per_image=256, seed=5)
    mi = scene.map_index
    write_model(mi.cameras, mi.images, mi.points3d, base / "gt_model")
    stripped = {iid: Image(iid, im.qvec, im.tvec, im.camera_id, im.name, np.zeros((0, 2)),
                           np.zeros(0, np.int64)) for iid, im in mi.images.items()}
    write_model(mi.cameras, stripped, {}, base / "ref_model")
    rng = np.random.default_rng(11)
    names = [mi.images[i].name for i in sorted(mi.images)]
    np.savez(base / "global.npz", names=np.array(names),
             descriptors=rng.normal(size=(len(names), 32)).astype(np.float32))
    return dict(base=base, scene=scene, names=names)


def _run(main, *args):
    main([str(a) for a in args])


def _pair_args(base, mode, out):
    if mode == "retrieval":
        return ["retrieval", "--query_descriptors", base / "global.npz",
                "--db_descriptors", base / "global.npz", "--output", out, "--num_matched", "3"]
    return [mode, "--model", base / "gt_model", "--output", out, "--num_matched", "3"]


@pytest.mark.parametrize("mode", ["covisibility", "poses", "retrieval"])
def test_pairs_from_writes_the_jax_pair_file(cli_scene, mode):
    base = cli_scene["base"]
    _run(t_pairs.main, *_pair_args(base, mode, base / f"pairs_{mode}_port.txt"))
    _run(j_pairs.main, *_pair_args(base, mode, base / f"pairs_{mode}_jax.txt"))
    port = (base / f"pairs_{mode}_port.txt").read_text()
    assert port == (base / f"pairs_{mode}_jax.txt").read_text()
    assert len(read_pairs(base / f"pairs_{mode}_port.txt")) == 8 * 3


@pytest.fixture(scope="module")
def matched(cli_scene):
    """Covisibility pairs, then both packages' match_features, NNM and NNR."""
    base = cli_scene["base"]
    _run(t_pairs.main, *_pair_args(base, "covisibility", base / "pairs.txt"))
    for conf in ("NNM", "NNR"):
        common = ["--features", base / "feats.h5", "--pairs", base / "pairs.txt", "--conf", conf,
                  "--max_keypoints", "256", "--batch_size", "8"]
        _run(t_match.main, *common, "--export_fn", base / f"m_{conf}_port.h5", "--device", "cpu")
        _run(j_match.main, *common, "--export_fn", base / f"m_{conf}_jax.h5")
    return base


@pytest.mark.parametrize("conf", ["NNM", "NNR"])
def test_match_features_matches_jax(cli_scene, matched, conf):
    base = matched
    pairs = read_pairs(base / "pairs.txt")
    with MatchStore(base / f"m_{conf}_port.h5") as mp, MatchStore(base / f"m_{conf}_jax.h5") as mj:
        n_match = 0
        for a, b in pairs:
            if not mj.has_pair(a, b):
                continue
            key = (a, b) if names_to_pair(a, b) in mj._store() else (b, a)
            m_p, s_p = mp.read(*key)
            m_j, s_j = mj.read(*key)
            np.testing.assert_array_equal(m_p, m_j)
            np.testing.assert_allclose(s_p, s_j, atol=1e-3)  # stored as float16
            n_match += int((m_p >= 0).sum())
    assert n_match > 8 * 100


def test_triangulation_matches_jax_and_the_bars(cli_scene, matched):
    base = matched
    common = ["--reference_sfm_model", base / "ref_model", "--pairs", base / "pairs.txt",
              "--features", base / "feats.h5", "--export_database"]
    _run(t_tri.main, "--sfm_dir", base / "sfm_port", "--matches", base / "m_NNM_port.h5",
         *common, "--device", "cpu")
    _run(j_tri.main, "--sfm_dir", base / "sfm_jax", "--matches", base / "m_NNM_jax.h5", *common)
    tables = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")
    with sqlite3.connect(base / "sfm_port" / "database.db") as dp, \
            sqlite3.connect(base / "sfm_jax" / "database.db") as dj:
        for t in tables:
            rows = dp.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
            assert rows == dj.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall(), t
        assert len(dp.execute("SELECT * FROM keypoints").fetchall()) == 8

    _, _, points_j = read_model(base / "sfm_jax")
    _, images, points = read_model(base / "sfm_port")
    assert abs(len(points) - len(points_j)) <= 0.01 * len(points_j)
    assert len(points) > 200
    lens = [len(p.image_ids) for p in points.values()]
    assert np.mean(lens) > 3.0
    assert np.mean([p.error for p in points.values()]) < 1.0
    gt = cli_scene["scene"].map_index.point_xyz
    xyz = np.stack([p.xyz for p in points.values()])
    d = np.linalg.norm(xyz[:, None] - gt[None], axis=-1).min(axis=1)
    assert np.median(d) < 0.05, np.median(d)
    assert (d < 0.2).mean() > 0.95


def test_reconstruction_recovers_the_scene(cli_scene, matched):
    base, scene = matched, cli_scene["scene"]
    cam = " ".join(["PINHOLE", str(scene.width), str(scene.height), *map(str, scene.cam_params)])
    _run(t_recon.main, "--sfm_dir", base / "recon_port", "--features", base / "feats.h5",
         "--matches", base / "m_NNR_port.h5", "--pairs", base / "pairs.txt", "--camera", cam,
         "--device", "cpu")
    _, images, points = read_model(base / "recon_port")
    assert len(images) == 8 and len(points) > 150
    mi = scene.map_index
    rec, gt = [], []
    for p in points.values():
        iid, k = int(p.image_ids[0]), int(p.point2D_idxs[0])
        gid = int(mi.images[mi.name_to_image_id[images[iid].name]].point3D_ids[k])
        if gid >= 0:
            rec.append(p.xyz)
            gt.append(mi.point_xyz[mi.point_row[gid]])
    rec, gt = np.array(rec), np.array(gt)
    s, rot, tr = _umeyama(rec, gt)
    d = np.linalg.norm((s * (rot @ rec.T)).T + tr - gt, axis=1)
    assert np.median(d) < 0.05, np.median(d)
    assert (d < 0.2).mean() > 0.9
    for im in images.values():
        ref = mi.images[mi.name_to_image_id[im.name]]
        c_al = s * (rot @ camera_center(im.qvec, im.tvec)) + tr
        assert np.linalg.norm(c_al - camera_center(ref.qvec, ref.tvec)) < 0.1, im.name


@pytest.mark.parametrize("a,b", [("db/1.jpg", "query/2.jpg"), ("a/b/c.png", "a/b/c.png"),
                                 ("x y.jpg", "z/w.jpg")])
def test_io_pairs_names_to_pair_matches_jax(a, b):
    """``io/pairs.py::names_to_pair`` (re-exported from ``io/feature_store``)
    gives the JAX package's hloc key, the one a match file is read by."""
    assert t_io_pairs.names_to_pair is names_to_pair
    assert t_io_pairs.names_to_pair(a, b) == j_io_pairs.names_to_pair(a, b)
