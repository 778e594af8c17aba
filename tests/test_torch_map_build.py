"""The map build and the incremental reconstruction of the port.

``triangulate_map`` on the 6-camera scene of ``tests/test_map_building.py``
keeps the JAX package's point count within 1 % and meets that test's bars
(> 200 points, mean track length > 3, mean reprojection error < 1 px,
median distance to the nearest ground-truth point < 0.05, 95 % within
0.2). The 5-camera ``incremental_reconstruction`` is held against ground
truth with the bars of ``tests/test_reconstruction.py`` (the JAX run of
that scene is marked slow, so it is not the reference here).
"""

import numpy as np
import pytest
import torch

from sfd2_torch.geometry.cameras import Camera as TCamera
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_torch.sfm import pairs as tpairs
from sfd2_torch.sfm.map_index import MapIndex as TMapIndex
from sfd2_torch.sfm.pipeline import TriangulationConfig, triangulate_map
from sfd2_torch.sfm.reconstruction import ReconstructionConfig, incremental_reconstruction
from sfd2_torch.sfm.stats import analyze_model, format_stats
from sfd2_tpu.geometry.np_pose import camera_center
from sfd2_tpu.io import colmap_model as jcm
from sfd2_tpu.io import feature_store as jfs
from sfd2_tpu.sfm import pairs as jpairs
from sfd2_tpu.sfm import pipeline as jpipe
from sfd2_tpu.sfm import stats as jstats
from sfd2_tpu.sfm.map_index import MapIndex
from test_torch_sfm import CAM_PARAMS, H, W, build_scene, scene  # noqa: F401  (fixture)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def built_map(scene):
    out = scene["base"] / "port_model"
    cams, images, points3d, stats = triangulate_map(
        scene["base"] / "ref_model", scene["port_feats"], scene["port_matches"],
        scene["pairs"], out, TriangulationConfig(verify_batch=8), device="cpu")
    return dict(out=out, cams=cams, images=images, points3d=points3d, stats=stats)


def test_triangulate_map_meets_the_reference_bars(scene, built_map):
    with jfs.FeatureStore(scene["base"] / "f.h5", "r") as fs, \
            jfs.MatchStore(scene["base"] / "m.h5", "r") as ms:
        _, _, _, ref_stats = jpipe.triangulate_map(scene["base"] / "ref_model", fs, ms,
                                                   scene["pairs"], None,
                                                   jpipe.TriangulationConfig(verify_batch=8))
    stats, points3d = built_map["stats"], built_map["points3d"]
    assert abs(stats["num_points3D"] - ref_stats["num_points3D"]) <= 0.01 * ref_stats["num_points3D"]
    assert stats["num_points3D"] > 200, stats
    assert stats["mean_track_length"] > 3.0, stats
    assert stats["mean_reprojection_error"] < 1.0, stats
    xyz = np.stack([p.xyz for p in points3d.values()])
    d = np.linalg.norm(xyz[:, None] - scene["pts"][None], axis=-1).min(axis=1)
    assert np.median(d) < 0.05, np.median(d)
    assert (d < 0.2).mean() > 0.95
    for pid, pt in points3d.items():  # images' point3D_ids round-trip with the tracks
        assert len(pt.image_ids) >= 2
        for iid, k in zip(pt.image_ids, pt.point2D_idxs):
            assert built_map["images"][int(iid)].point3D_ids[int(k)] == pid


def test_written_model_reads_back_with_the_jax_reader(built_map):
    cams, images, points = jcm.read_model(built_map["out"])
    assert len(points) == built_map["stats"]["num_points3D"]
    assert (built_map["out"] / "statics.txt").read_text() == format_stats(built_map["stats"]) + "\n"
    pid = next(iter(points))
    np.testing.assert_array_equal(points[pid].xyz, built_map["points3d"][pid].xyz)


def test_pairs_and_stats_match_jax(scene, built_map, rng):
    mi = TMapIndex(built_map["cams"], built_map["images"], built_map["points3d"])
    mi_j = MapIndex(built_map["cams"], built_map["images"], built_map["points3d"])
    assert tpairs.pairs_from_covisibility(mi, 3) == jpairs.pairs_from_covisibility(mi_j, 3)
    assert tpairs.pairs_from_poses(scene["ref_images"], 2) == \
        jpairs.pairs_from_poses(scene["ref_images"], 2)
    q = rng.normal(size=(2, 16)).astype(np.float32)
    db = np.concatenate([q + 0.01, rng.normal(size=(5, 16)).astype(np.float32)])
    args = (["q0", "d1"], q, [f"d{i}" for i in range(7)], db, 3)
    assert tpairs.pairs_from_retrieval(*args) == jpairs.pairs_from_retrieval(*args)
    stats = analyze_model(built_map["cams"], built_map["images"], built_map["points3d"])
    assert stats == jstats.analyze_model(built_map["cams"], built_map["images"],
                                         built_map["points3d"])
    assert format_stats(stats) == jstats.format_stats(stats)


def _umeyama(src, dst):
    """Similarity transform aligning src→dst (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(dc.T @ sc / len(src))
    s_fix = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s_fix[2, 2] = -1
    rot = u @ s_fix @ vt
    scale = np.trace(np.diag(d) @ s_fix) / ((sc ** 2).sum() / len(src))
    return scale, rot, mu_d - scale * rot @ mu_s


def test_incremental_reconstruction_recovers_the_scene():
    """The 5-camera scene and bars of tests/test_reconstruction.py, held
    against ground truth after a Umeyama alignment fitted on points."""
    pts, poses, feats, kp_to_gt = build_scene(5, 260, 5, 0.8, -1.6, 0.05, 0.04, 0.25, False)
    names = sorted(feats)
    fs = FeatureStore()
    for n, (kp, de, sc) in feats.items():
        fs.write(n, ImageFeatures(kp, de, sc, None))
    pairs = [(a, b) for ai, a in enumerate(names) for b in names[ai + 1:]]
    ms = MatchStore()
    match_pairs(fs, pairs, ms, MatchConfig(max_keypoints=512, batch_size=8), device="cpu")
    cams = {n: TCamera(1, "PINHOLE", W, H, np.array(CAM_PARAMS)) for n in names}
    _, images, points, stats = incremental_reconstruction(
        fs, ms, pairs, cams, ReconstructionConfig(tri=TriangulationConfig(verify_batch=8)),
        device="cpu")
    assert stats["num_reg_images"] == 5, stats
    assert stats["num_points3D"] > 150, stats
    name_by_id = {iid: im.name for iid, im in images.items()}
    recon = np.array([p.xyz for p in points.values()])
    gt = np.array([pts[kp_to_gt[name_by_id[int(p.image_ids[0])]][int(p.point2D_idxs[0])]]
                   for p in points.values()])
    s, rot, tr = _umeyama(recon, gt)
    d = np.linalg.norm((s * (rot @ recon.T)).T + tr - gt, axis=1)
    assert np.median(d) < 0.05, np.median(d)
    assert (d < 0.2).mean() > 0.9, (d < 0.2).mean()
    for im in images.values():
        c_al = s * (rot @ camera_center(im.qvec, im.tvec)) + tr
        assert np.linalg.norm(c_al - camera_center(*poses[im.name])) < 0.1, im.name
