"""Store files between the port and the JAX package.

The port's ``FeatureStore`` / ``MatchStore`` read and write HDF5 through
``io/h5file.py``; the JAX package's through h5py. Files cross both ways with
equal ``read``, ``read_padded``, ``keys()`` and ``has_pair`` (reversed pairs
and ``as_half`` included). The port's CLI chain ``pairs_from →
match_features → triangulation → localizer`` (``--device cpu``) runs in a
subprocess with h5py blocked (``sys.modules["h5py"] = None``) and in one
with h5py importable: pair files, matches, database tables and poses are
equal. The JAX ``match_features`` gives the same matches on a port-written
feature file as on its own.
"""

import json
import os
import sqlite3
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from sfd2_torch.io import feature_store as tfs
from sfd2_torch.io.colmap_model import Image, write_model
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu.io import feature_store as jfs

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["db/0.jpg", "db/1.jpg", "query/night/q0.jpg", "empty.jpg", "x"]


def features(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(NAMES):
        n = 0 if name == "empty.jpg" else 40 + 7 * i
        labels = rng.integers(0, 5, n).astype(np.int32) if i % 2 else None
        size = np.array([640, 480]) if i != 4 else None
        out[name] = tfs.ImageFeatures(rng.random((n, 2), np.float32) * 600,
                                      rng.normal(size=(n, 32)).astype(np.float32),
                                      rng.random(n, np.float32), size, labels)
    return out


def matches(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for a, b in [("db/0.jpg", "db/1.jpg"), ("query/night/q0.jpg", "db/0.jpg"), ("x", "db/1.jpg")]:
        m = rng.integers(-1, 47, 40).astype(np.int32)
        out[(a, b)] = (m, rng.random(40).astype(np.float32))
    return out


def write_stores(pkg, feat_path, match_path, feats, pairs, as_half):
    with pkg.FeatureStore(feat_path, "w") as fs:
        for name, f in feats.items():
            fs.write(name, f, as_half=as_half)
    with pkg.MatchStore(match_path, "w") as ms:
        for (a, b), (m, s) in pairs.items():
            ms.write(a, b, m, s)


def same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("as_half", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_files_cross_both_ways(tmp_path, writer, as_half):
    feats, pairs = features(3), matches(4)
    write_stores(jfs if writer == "jax" else tfs, tmp_path / "f.h5", tmp_path / "m.h5", feats,
                 pairs, as_half)
    with tfs.FeatureStore(tmp_path / "f.h5") as tf_, jfs.FeatureStore(tmp_path / "f.h5") as jf, \
            tfs.MatchStore(tmp_path / "m.h5") as tm, jfs.MatchStore(tmp_path / "m.h5") as jm:
        assert tf_.keys() == jf.keys() == sorted(NAMES)
        for name in NAMES:
            assert name in tf_ and name in jf
            a, b = tf_.read(name), jf.read(name)
            for fa, fb in zip(a, b):
                same(fa, fb)
            if not as_half:
                same(a.descriptors, feats[name].descriptors)
            for k in (8, 64):
                for x, y in zip(tf_.read_padded(name, k, with_labels=True),
                                jf.read_padded(name, k, with_labels=True)):
                    same(x, y)
        assert "db/9.jpg" not in tf_ and "db/9.jpg" not in jf
        for (a, b), (m, _) in pairs.items():
            for x, y in ((a, b), (b, a)):
                assert tm.has_pair(x, y) and jm.has_pair(x, y)
            for x, y in zip(tm.read(a, b), jm.read(a, b)):
                same(x, y)
            same(tm.read(a, b)[0], m.astype(np.int64))
            for k in (None, 60):
                for x, y in zip(tm.read(b, a, k), jm.read(b, a, k)):
                    same(x, y)
        assert not tm.has_pair("db/0.jpg", "x") and not jm.has_pair("db/0.jpg", "x")


# --- the CLI chain, with and without h5py ---------------------------------

CHAIN = r"""
import json, sys
from pathlib import Path
if {block}:
    sys.modules["h5py"] = None
from sfd2_torch.cli import localizer, match_features, pairs_from, triangulation
base, out = Path(sys.argv[1]), Path(sys.argv[2])
pairs_from.main(["covisibility", "--model", str(base / "gt_model"), "--output",
                 str(out / "pairs.txt"), "--num_matched", "4"])
match_features.main(["--features", str(base / "feats.h5"), "--pairs", str(out / "pairs.txt"),
                     "--export_fn", str(out / "m.h5"), "--max_keypoints", "256",
                     "--device", "cpu"])
triangulation.main(["--sfm_dir", str(out / "sfm"), "--reference_sfm_model",
                    str(base / "ref_model"), "--pairs", str(out / "pairs.txt"),
                    "--features", str(base / "feats.h5"), "--matches", str(out / "m.h5"),
                    "--export_database", "--device", "cpu"])
stats = localizer.main(["--reference_sfm", str(out / "sfm"), "--queries",
                        str(base / "queries.txt"), "--retrieval", str(base / "retrieval.txt"),
                        "--features", str(base / "feats.h5"), "--results",
                        str(out / "poses.txt"), "--gt_pose_fn", str(base / "gt.txt"),
                        "--ransac_thresh", "8", "--opt_thresh", "8", "--covisibility_frame", "5",
                        "--iters", "2", "--radius", "12", "--obs_thresh", "2",
                        "--max_keypoints", "256", "--device", "cpu"])
print(json.dumps({{"h5py": "h5py" in sys.modules and sys.modules["h5py"] is not None,
                  "recall": stats["recall"]}}))
"""


@pytest.fixture(scope="module")
def chain_scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("chain")
    with tfs.FeatureStore(base / "feats.h5", "w") as fs:
        scene = build_corridor_scene(fs, n_images=10, n_queries=2, n_points=700, desc_dim=128,
                                     kp_per_image=256, kp_per_query=256, retrieval_k=4, seed=5)
    mi = scene.map_index
    write_model(mi.cameras, mi.images, mi.points3d, base / "gt_model")
    stripped = {iid: Image(iid, im.qvec, im.tvec, im.camera_id, im.name, np.zeros((0, 2)),
                           np.zeros(0, np.int64)) for iid, im in mi.images.items()}
    write_model(mi.cameras, stripped, {}, base / "ref_model")
    cam = " ".join([scene.cam_model, str(scene.width), str(scene.height),
                    *map(str, scene.cam_params)])
    (base / "queries.txt").write_text("".join(f"{q} {cam}\n" for q, _, _, _ in scene.queries))
    (base / "retrieval.txt").write_text("".join(
        f"{q} {mi.images[j].name}\n" for q, _, _, near in scene.queries for j in near))
    (base / "gt.txt").write_text("".join(
        f"{q.split('/')[-1]} " + " ".join(map(str, [*qv, *tv])) + "\n"
        for q, qv, tv, _ in scene.queries))

    def chain(block: bool):
        out = base / ("blocked" if block else "h5py")
        out.mkdir()
        res = subprocess.run([sys.executable, "-c", CHAIN.format(block=block), str(base), str(out)],
                             cwd=ROOT, capture_output=True, text=True, timeout=400,
                             env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"})
        assert res.returncode == 0, res.stderr[-3000:]
        return out, json.loads(res.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(2) as pool:
        runs = dict(zip(("blocked", "h5py"), pool.map(chain, (True, False))))
    return base, scene, runs


def test_cli_chain_runs_without_h5py(chain_scene):
    _, _, runs = chain_scene
    (blocked, info_b), (free, info_f) = runs["blocked"], runs["h5py"]
    assert not info_b["h5py"]
    assert info_b["recall"] == info_f["recall"] and info_b["recall"][0] == 1.0
    assert (blocked / "pairs.txt").read_text() == (free / "pairs.txt").read_text()
    assert (blocked / "poses.txt").read_text() == (free / "poses.txt").read_text()
    assert len((blocked / "poses.txt").read_text().splitlines()) == 2
    tables = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")
    with sqlite3.connect(blocked / "sfm" / "database.db") as db, \
            sqlite3.connect(free / "sfm" / "database.db") as df:
        for t in tables:
            rows = db.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
            assert rows == df.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall(), t
            # The CLI exports cameras, images and keypoints (no verified matches).
            assert bool(rows) == (t in ("cameras", "images", "keypoints")), t


def test_cli_chain_matches_read_by_h5py(chain_scene):
    """The blocked run's matches file, read by the JAX store (h5py), equals
    the other run's read by the port's store."""
    _, _, runs = chain_scene
    pairs = [tuple(ln.split()) for ln in (runs["blocked"][0] / "pairs.txt").read_text().splitlines()]
    with jfs.MatchStore(runs["blocked"][0] / "m.h5") as jm, \
            tfs.MatchStore(runs["h5py"][0] / "m.h5") as tm:
        n = 0
        for a, b in pairs:
            assert jm.has_pair(a, b) and tm.has_pair(a, b)
            for x, y in zip(jm.read(a, b, 256), tm.read(a, b, 256)):
                same(x, y)
            n += int((tm.read(a, b, 256)[0] >= 0).sum())
        assert n > 100 * len(pairs) // 2


def test_jax_match_features_reads_port_features(chain_scene, tmp_path):
    """The JAX CLI on the port-written feature file and on the same
    features written by the JAX store: the same matches."""
    from sfd2_tpu.cli import match_features as j_match

    base, _, runs = chain_scene
    pairs_txt = runs["blocked"][0] / "pairs.txt"
    with tfs.FeatureStore(base / "feats.h5") as src, \
            jfs.FeatureStore(tmp_path / "jfeats.h5", "w") as dst:
        for name in src.keys():
            dst.write(name, src.read(name))
    for feats, out in ((base / "feats.h5", "port"), (tmp_path / "jfeats.h5", "jax")):
        j_match.main(["--features", str(feats), "--pairs", str(pairs_txt), "--export_fn",
                      str(tmp_path / f"m_{out}.h5"), "--max_keypoints", "256"])
    pairs = [tuple(ln.split()) for ln in pairs_txt.read_text().splitlines()]
    with jfs.MatchStore(tmp_path / "m_port.h5") as mp, jfs.MatchStore(tmp_path / "m_jax.h5") as mj:
        for a, b in pairs:
            for x, y in zip(mp.read(a, b, 256), mj.read(a, b, 256)):
                same(x, y)


def test_localize_many_reads_one_file(chain_scene):
    """Four worker threads of ``localize_many`` share one feature file with
    cold bank caches: the answers equal the sequential loop's on a dict
    copy of the same store, bit for bit."""
    from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig

    base, scene, _ = chain_scene
    cfg = LocalizerConfig(ransac_thresh=8.0, opt_thresh=8.0, covisibility_frame=5, iters=2,
                          radius=12.0, obs_thresh=2, max_keypoints=256, num_hypotheses=256)
    jobs = [(q, scene.qinfo, [[j] for j in near]) for q, _, _, near in scene.queries] * 2
    copy = tfs.FeatureStore()
    with tfs.FeatureStore(base / "feats.h5") as fs:
        for name in fs.keys():
            copy.write(name, fs.read(name))
        par = LocalizationEngine(scene.map_index, fs, cfg, device="cpu").localize_many(
            jobs, workers=4)
    eng = LocalizationEngine(scene.map_index, copy, cfg, device="cpu")
    seq = [eng.localize(*j) for j in jobs]
    for a, b in zip(seq, par):
        same(a.qvec, b.qvec)
        same(a.tvec, b.tvec)
        assert (a.num_inliers, a.source) == (b.num_inliers, b.source)
