"""The scale rehearsal's stages (``sfd2_torch/scripts/bench_scale.py``) at
the JAX script's ``--tiny`` sizes on the CPU, against the JAX package's
functions on the same inputs.

One scene, built by the port's stage 1 from ``np.random.default_rng(404)``
and the stage's fixed ``torch.Generator`` seeds. Pairs, tracks, the
stride-sampled track tables, the map arrays and the map index are integer
or copied data and must be identical; triangulation and BA run the same
float32 arithmetic with sums in another order (points within 1e-4
relative, BA costs within 1e-4 relative); F-RANSAC fed the JAX sampler's
indices keeps ≥ 99 % identical inlier edges in float64, where
``tests/test_torch_sfm.py`` holds it. The JAX script itself is never run
here: it would overwrite ``SCALE_tiny.json``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.scripts import bench_scale as bs
from sfd2_torch.sfm.twoview import verify_fundamental_ransac_core
from sfd2_tpu.geometry.cameras import Camera as JCamera
from sfd2_tpu.io.colmap_model import Image as JImage
from sfd2_tpu.sfm import ba as jba
from sfd2_tpu.sfm import twoview as jtv
from sfd2_tpu.sfm.map_index import MapIndex as JMapIndex
from sfd2_tpu.sfm.pairs import pairs_from_poses as jpairs_from_poses
from sfd2_tpu.sfm.tracks import build_tracks_arrays as jbuild_tracks_arrays
from sfd2_tpu.sfm.triangulation import triangulate_tracks as jtriangulate_tracks

torch.set_num_threads(2)

CFG = bs.ScaleConfig(**bs.TINY)


@pytest.fixture(scope="module")
def stages():
    """The port's stages 1-8 on the CPU, in the order ``run`` takes them."""
    rng = np.random.default_rng(bs.POSE_SEED)
    scene = bs.make_scene(CFG, "cpu", rng)
    pij = bs.pairs_stage(CFG, scene.db_q, scene.db_t)
    edges, counts = bs.match_verify(CFG, scene.bank, scene.valid, scene.xy, pij)
    tracks = bs.build_tracks_arrays(CFG.n_db, CFG.kp, edges, min_track_length=2)
    tables = bs.track_tables(*tracks, CFG.t_cap)
    tri = bs.triangulate_stage(CFG, scene.xy, scene.db_q, scene.db_t, tables)
    arrays = bs.map_arrays(tables, tri[0], tri[1], tri[3])
    problem, upts, window = bs.ba_problem(CFG, rng, arrays, scene.xy, scene.db_q, scene.db_t)
    return dict(scene=scene, pij=pij, edges=edges, counts=counts, tracks=tracks, tables=tables,
                tri=tri, arrays=arrays, problem=problem, upts=upts, window=window)


def test_scene_is_the_jax_scripts_ground_truth(stages):
    """Points and poses are the JAX script's draws from rng(404); the
    device-born features are in frame, unit and near their projections."""
    scene = stages["scene"]
    rng = np.random.default_rng(bs.POSE_SEED)
    pts = np.stack([rng.uniform(-2, CFG.span + 2, CFG.n_pts), rng.uniform(-2.5, 2.5, CFG.n_pts),
                    rng.uniform(8, 15, CFG.n_pts)], 1).astype(np.float32)
    np.testing.assert_array_equal(scene.pts, pts)
    assert scene.bank.shape == (CFG.n_db, CFG.kp, CFG.c) and scene.bank.dtype == torch.bfloat16
    assert scene.db_valid.all() and scene.q_va.all()
    norms = torch.linalg.norm(scene.bank.float(), dim=-1)
    assert float((norms - 1).abs().max()) < 1e-2
    xy = scene.xy.numpy()
    assert (xy[..., 0] > 6).all() and (xy[..., 0] < CFG.width - 6).all()
    assert scene.q_de.shape == (CFG.n_q, CFG.kp, CFG.c)


def test_pairs_equal_jax(stages):
    scene = stages["scene"]
    images = {i + 1: JImage(i + 1, scene.db_q[i], scene.db_t[i], 1, bs.db_name(i),
                            np.zeros((0, 2)), np.zeros(0, np.int64)) for i in range(CFG.n_db)}
    name2row = {bs.db_name(i): i for i in range(CFG.n_db)}
    ref = np.array([[name2row[a], name2row[b]] for a, b in jpairs_from_poses(images, CFG.pairs)])
    ref = np.unique(np.sort(ref, axis=1), axis=0)
    np.testing.assert_array_equal(stages["pij"], ref)
    assert len(ref) == 123  # SCALE_tiny.json's n_pairs


def test_tracks_equal_jax(stages):
    ref = jbuild_tracks_arrays(CFG.n_db, CFG.kp, stages["edges"], min_track_length=2)
    for got, want in zip(stages["tracks"], ref):
        np.testing.assert_array_equal(got, want)
    assert stages["tracks"][3] > 1000


def _jax_tables(obs_img, obs_kp, obs_track, n_tracks, t_cap):
    """``scripts/bench_scale.py:358-379`` restated."""
    lens = np.bincount(obs_track, minlength=n_tracks)
    starts = np.zeros(n_tracks + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(len(obs_track)) - starts[obs_track]
    slot = (pos * t_cap) // np.maximum(lens[obs_track], 1)
    first_in_slot = np.ones(len(obs_track), bool)
    first_in_slot[1:] = (obs_track[1:] != obs_track[:-1]) | (slot[1:] != slot[:-1])
    t_sel, i_sel, k_sel = (a[first_in_slot] for a in (obs_track, obs_img, obs_kp))
    new_track_start = np.ones(len(t_sel), bool)
    new_track_start[1:] = t_sel[1:] != t_sel[:-1]
    run = np.arange(len(t_sel))
    pos_sel = run - np.maximum.accumulate(np.where(new_track_start, run, 0))
    cam_tab = np.zeros((n_tracks, t_cap), np.int32)
    kp_tab = np.zeros((n_tracks, t_cap), np.int32)
    mask_tab = np.zeros((n_tracks, t_cap), bool)
    cam_tab[t_sel, pos_sel] = i_sel
    kp_tab[t_sel, pos_sel] = k_sel
    mask_tab[t_sel, pos_sel] = True
    return dict(cam=cam_tab, kp=kp_tab, mask=mask_tab, t_sel=t_sel, i_sel=i_sel, k_sel=k_sel,
                pos_sel=pos_sel)


def _jax_map_arrays(tables, xyz, tvalid, obs_ok_tab):
    """``scripts/bench_scale.py:424-436`` restated."""
    t_sel, pos_sel = tables["t_sel"], tables["pos_sel"]
    final_row = np.cumsum(tvalid) - 1
    keep_obs = tvalid[t_sel] & obs_ok_tab[t_sel, pos_sel]
    f_pt = final_row[t_sel[keep_obs]]
    n_points = int(tvalid.sum())
    return dict(f_img=tables["i_sel"][keep_obs], f_kp=tables["k_sel"][keep_obs], f_pt=f_pt,
                point_xyz=xyz[tvalid],
                track_len=np.bincount(f_pt, minlength=n_points).astype(np.int32))


def test_track_tables_and_map_arrays_equal_the_jax_lines(stages):
    ref = _jax_tables(*stages["tracks"], CFG.t_cap)
    assert ref.keys() == stages["tables"].keys()
    for k in ref:
        np.testing.assert_array_equal(stages["tables"][k], ref[k], err_msg=k)
    xyz, tvalid, _, obs_ok = stages["tri"]
    ref = _jax_map_arrays(stages["tables"], xyz, tvalid, obs_ok)
    for k in ref:
        np.testing.assert_array_equal(stages["arrays"][k], ref[k], err_msg=k)


def test_triangulation_matches_jax(stages):
    """The JAX script's ``tri_chunk`` on the same tables and resident xy."""
    scene, tables = stages["scene"], stages["tables"]
    cam, kp, mask = tables["cam"], tables["kp"], tables["mask"]
    xyflat = scene.xy.numpy().reshape(-1, 2)
    cam8 = bs._cam8(CFG, "cpu").numpy()
    ref = jtriangulate_tracks(
        jnp.asarray(xyflat[cam.astype(np.int64) * CFG.kp + kp]), jnp.asarray(mask),
        jnp.asarray(scene.db_q.astype(np.float32)[cam]),
        jnp.asarray(scene.db_t.astype(np.float32)[cam]),
        jnp.asarray(np.broadcast_to(cam8, (*cam.shape, 8))))
    xyz, tvalid, terr, obs_ok = stages["tri"]
    np.testing.assert_array_equal(tvalid, np.asarray(ref.valid))
    np.testing.assert_array_equal(obs_ok, np.asarray(ref.obs_inlier))
    want = np.asarray(ref.xyz)[tvalid]
    gap = np.linalg.norm(xyz[tvalid] - want, axis=1) / np.linalg.norm(want, axis=1)
    assert gap.max() <= 1e-4, gap.max()
    np.testing.assert_allclose(terr[tvalid], np.asarray(ref.errors)[tvalid], atol=1e-4)
    assert tvalid.mean() >= 0.5


def test_bundle_adjust_matches_jax(stages):
    """The stage's problem through both packages at the script's LM and CG
    iterations: initial and final costs within 1e-4 relative."""
    problem = stages["problem"]
    assert stages["window"] == {} and len(stages["upts"]) == len(stages["arrays"]["point_xyz"])
    res = bs.ba_stage(CFG, problem, stages["upts"], stages["arrays"]["point_xyz"])[3]
    ref = jba.bundle_adjust(jba.BAProblem(*(jnp.asarray(t.numpy()) for t in problem)),
                            lm_iters=CFG.lm_iters, cg_iters=CFG.cg_iters)
    np.testing.assert_allclose(res["ba_initial_cost"], float(ref.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(res["ba_final_cost"], float(ref.final_cost), rtol=1e-4)
    assert res["ba_final_cost"] < res["ba_initial_cost"]


def test_ba_window_and_subsample_follow_the_jax_rule(stages):
    """Above ``ba_max_obs`` the observations are drawn with the run's rng as
    the JAX script draws them; above ``ba_max_pts`` points only the first
    ``ba_cams`` cameras' observations stay, their points renumbered."""
    import dataclasses

    arrays, scene = stages["arrays"], stages["scene"]
    cfg = dataclasses.replace(CFG, ba_max_obs=4000, ba_max_pts=1000, ba_cams=20)
    problem, upts, window = bs.ba_problem(cfg, np.random.default_rng(5), arrays, scene.xy,
                                          scene.db_q, scene.db_t)
    rng = np.random.default_rng(5)
    sub = np.sort(rng.choice(len(arrays["f_img"]), 4000, replace=False))
    bi, bp = arrays["f_img"][sub], arrays["f_pt"][sub]
    keep = bi < 20
    want_pts, want_inv = np.unique(bp[keep], return_inverse=True)
    np.testing.assert_array_equal(upts, want_pts)
    np.testing.assert_array_equal(problem.obs_point.numpy(), want_inv)
    np.testing.assert_array_equal(problem.obs_cam.numpy(), bi[keep])
    assert window == dict(ba_window_cams=20, ba_window_pts=len(want_pts))
    assert bool(problem.fixed_cams[:2].all()) and not bool(problem.fixed_cams[2:].any())


def test_map_index_equals_jax(stages):
    scene, arrays = stages["scene"], stages["arrays"]
    got = bs.map_index_stage(CFG, arrays, arrays["point_xyz"], scene.db_q, scene.db_t)
    prow = np.full((CFG.n_db, CFG.kp), -1, np.int64)
    prow[arrays["f_img"], arrays["f_kp"]] = arrays["f_pt"]
    ref = JMapIndex.from_arrays(
        {1: JCamera(1, "PINHOLE", CFG.width, CFG.height, np.array(CFG.cam_params))},
        {i + 1: JImage(i + 1, scene.db_q[i], scene.db_t[i], 1, bs.db_name(i),
                       np.zeros((0, 2)), None) for i in range(CFG.n_db)},
        {i + 1: prow[i] for i in range(CFG.n_db)}, arrays["point_xyz"], arrays["track_len"])
    for k in ("image_ids", "point_xyz", "track_len", "qvecs", "tvecs", "point_ids"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.names == ref.names and got.image_row == ref.image_row
    for a, b in zip(got.p3d_rows_per_image, ref.p3d_rows_per_image):
        np.testing.assert_array_equal(a, b)
    assert (got.incidence != ref.incidence).nnz == 0
    assert (got._incidence_t != ref._incidence_t).nnz == 0


def _jax_sample_idx(key, valid, num_hypotheses):
    """The sampler of sfd2_tpu/sfm/twoview.py::verify_fundamental_ransac."""
    fvalid = valid.astype(jnp.float32)

    def sample_one(k):
        g = jax.random.gumbel(k, (valid.shape[0],)) + jnp.log(fvalid + 1e-30)
        return jax.lax.top_k(g, 8)[1]

    return jax.vmap(sample_one)(jax.random.split(key, num_hypotheses))


def test_verification_matches_jax_on_the_same_samples(stages):
    """Every pair's candidates through the JAX F-RANSAC (one key per pair)
    and through the port's core fed that key's samples, both in float64
    as ``tests/test_torch_sfm.py`` holds them (in float32 the JAX lanes
    solve loses 10 of these 123 pairs that float64 verifies): the same
    pairs verified and ≥ 99 % identical inlier edges. The JAX side is one
    program for one pair, run pair by pair: it compiles in less time than
    the program of the whole batch."""
    scene, pij = stages["scene"], stages["pij"]
    ii, jj = (torch.from_numpy(pij[:, k]) for k in (0, 1))
    _, _, selv, xy1, xy2 = bs.match_candidates(CFG, scene.bank, scene.valid, scene.xy, ii, jj)
    xy1, xy2, selv = xy1.double(), xy2.double(), selv.numpy()
    keys = jax.random.split(jax.random.PRNGKey(23), len(pij))

    def one_pair(a, b, v, k):
        res = jtv.verify_fundamental_ransac(a, b, v, 4.0, k, num_hypotheses=CFG.hyp)
        return res.success, res.inliers, _jax_sample_idx(k, v, CFG.hyp)

    with jax.enable_x64(True):
        one_pair = jax.jit(one_pair)
        outs = [one_pair(jnp.asarray(xy1[p].numpy()), jnp.asarray(xy2[p].numpy()),
                         jnp.asarray(selv[p]), keys[p]) for p in range(len(pij))]
    want_ok, want_inl, idx = (np.stack([np.asarray(o[i]) for o in outs]) for i in range(3))
    got = verify_fundamental_ransac_core(xy1, xy2, torch.from_numpy(selv),
                                         torch.from_numpy(idx).long())
    np.testing.assert_array_equal(got.success.numpy(), want_ok)
    want = want_inl & selv & want_ok[:, None]
    have = got.inliers.numpy() & selv & want_ok[:, None]
    assert (have != want).sum() <= 0.01 * want.sum(), ((have != want).sum(), want.sum())
    # The stage's own samples, from its generator, verify as many pairs.
    assert abs(stages["counts"]["n_pairs_verified"] - int(want_ok.sum())) <= 0.05 * len(pij)


def test_tiny_run_localizes_on_the_cpu(tmp_path):
    """The whole ``--tiny`` run through ``main``: every stage recorded in
    the JSON, BA lowers its cost, recall@(0.25 m, 2°) ≥ 0.875 (the JAX run
    reached 1.0, SCALE_tiny.json)."""
    out = tmp_path / "scale.json"
    bs.main(["--tiny", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["phase"] == "done" and "error" not in rec
    assert list(rec["stages_s"]) == ["scene_gen", "pairs", "match_verify", "tracks",
                                     "triangulate", "map_arrays", "ba", "map_index",
                                     "engine_setup", "localize"]
    c = rec["counts"]
    assert c["n_pairs"] == 123
    assert c["n_points_triangulated"] / c["n_tracks"] >= 0.5
    assert c["ba_final_cost"] < c["ba_initial_cost"]
    assert rec["recall_025m_2deg"] >= 0.875, rec
    assert rec["scale"]["n_db"] == 60 and rec["scale"]["kp"] == 512


def test_arguments_keep_the_jax_defaults():
    args = bs.parse_args([])
    cfg = bs.config_from_args(args)
    assert cfg == bs.ScaleConfig()
    assert (cfg.n_db, cfg.n_pts, cfg.n_q, cfg.topq, cfg.pairs, cfg.kp, cfg.c) == \
        (5000, 600_000, 50, 50, 10, 4096, 128)
    assert (cfg.nm, cfg.hyp, cfg.gen_b, cfg.pb, cfg.tri_p, cfg.t_cap) == \
        (1024, 2048, 50, 16, 65_536, 12)
    assert (cfg.ba_max_obs, cfg.ba_cams, cfg.ba_max_pts, cfg.lm_iters, cfg.cg_iters) == \
        (4_000_000, 1024, 400_000, 2, 8)
    assert args.device == "cuda" and str(args.out) == "chiprun_out/SCALE_torch.json"
    tiny = bs.config_from_args(bs.parse_args(["--tiny", "--n_q", "3"]))
    assert (tiny.n_db, tiny.n_pts, tiny.n_q, tiny.kp, tiny.c) == (60, 6000, 3, 512, 64)
    assert (cfg.width, cfg.height, tiny.width, tiny.height) == (1024, 768, 640, 480)
    with pytest.raises(SystemExit):  # the image size is fixed, as in the JAX script
        bs.parse_args(["--width", "640"])
