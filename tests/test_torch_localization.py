"""The port's PnP, RANSAC, map index and engine against the JAX package.

PnP solvers and LM refinement run float32 in both packages from the same
numpy inputs, so poses agree to float32 rounding amplified by the solve
(1e-4 rad / 1e-3 m on a well-conditioned scene); a DLT null vector may
come out with the other sign, so poses are compared, never vectors.
RANSAC is fed the hypotheses JAX's own sampler draws, and must end with
the same inlier count. The engine runs ``bench.py``'s quick corridor
configuration in both packages on scenes drawn from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization import pnp as tpnp
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig, _bucket
from sfd2_torch.localization.ransac import pnp_ransac, pnp_ransac_core, sample_minimal_sets
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu.geometry.cameras import project_points
from sfd2_tpu.io.feature_store import FeatureStore as JFeatureStore
from sfd2_tpu.localization import engine as jengine
from sfd2_tpu.localization import pnp as jpnp
from sfd2_tpu.localization.ransac import pnp_ransac as jpnp_ransac
from sfd2_tpu.utils.synth import build_corridor_scene as jbuild_corridor_scene

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)

CAM = np.array([520.0, 515.0, 320.0, 240.0, -0.05, 0.01, 5e-4, -2e-4], np.float32)


def _scene(seed, n=200, outliers=0.0, noise=0.3):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(5, 12, n)], 1).astype(np.float32)
    q = np.array([0.99, 0.05, -0.08, 0.03])
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = np.array([0.3, -0.2, 0.5], np.float32)
    xy = np.asarray(project_points(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(CAM))[0])
    xy = xy + rng.normal(size=xy.shape).astype(np.float32) * noise
    bad = rng.random(n) < outliers
    xy[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2)).astype(np.float32)
    return pts, xy.astype(np.float32), q, t, rng


def _tt(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _jj(*a):
    return [jnp.asarray(x) for x in a]


def _close_pose(qa, ta, qb, tb, rot_deg=1e-2, t_m=1e-3):
    q_err, t_err = pose_error(np.asarray(qa, float), np.asarray(ta, float),
                              np.asarray(qb, float), np.asarray(tb, float))
    assert q_err < rot_deg and t_err < t_m, (q_err, t_err)


def _norm(xy):
    """Undistorted normalised coordinates through the JAX package (both
    solvers then see the same input)."""
    from sfd2_tpu.geometry.cameras import unproject_normalized

    return np.asarray(unproject_normalized(jnp.asarray(xy), jnp.asarray(CAM)))


@pytest.mark.parametrize("weighted", [False, True])
def test_pnp_dlt_matches_jax(weighted):
    pts, xy, q, t, rng = _scene(0, noise=0.1)
    xn = _norm(xy)
    w = (rng.random(len(pts)) > 0.3).astype(np.float32) if weighted else None
    args = (pts, xn) if w is None else (pts, xn, w)
    q_t, t_t = tpnp.pnp_dlt(*_tt(*args))
    q_j, t_j = jpnp.pnp_dlt(*_jj(*args))
    _close_pose(q_t.numpy(), t_t.numpy(), q_j, t_j)
    _close_pose(q_t.numpy(), t_t.numpy(), q, t, rot_deg=0.2, t_m=0.05)


def test_pnp_dlt_fast_lanes_matches_jax():
    pts, xy, _, _, rng = _scene(1, noise=0.0)
    xn = _norm(xy)
    idx = np.stack([rng.choice(len(pts), 6, replace=False) for _ in range(64)])
    q_t, t_t = tpnp.pnp_dlt_fast_lanes(*_tt(pts[idx], xn[idx]))
    q_j, t_j = jpnp.pnp_dlt_fast_lanes(*_jj(pts[idx], xn[idx]))
    q_j, t_j = np.asarray(q_j), np.asarray(t_j)
    ok = np.isfinite(q_j).all(1) & np.isfinite(t_j).all(1)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(q_t.numpy()).all(1), ok)
    # Minimal samples are conditioned far worse than a 200-point fit.
    errs = np.array([pose_error(q_t.numpy()[i].astype(float), t_t.numpy()[i].astype(float),
                                q_j[i].astype(float), t_j[i].astype(float))
                     for i in np.nonzero(ok)[0]])
    assert np.median(errs[:, 0]) < 0.05 and np.median(errs[:, 1]) < 0.01, errs


def test_refine_pose_lm_matches_jax():
    pts, xy, q, t, rng = _scene(2)
    w = (rng.random(len(pts)) > 0.2).astype(np.float32)
    q0 = (q + np.array([0.0, 0.01, -0.01, 0.0], np.float32)).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.04], np.float32)).astype(np.float32)
    q_t, t_t = tpnp.refine_pose_lm(*_tt(q0, t0, pts, xy, CAM, w))
    q_j, t_j = jpnp.refine_pose_lm(*_jj(q0, t0, pts, xy, CAM, w))
    _close_pose(q_t.numpy(), t_t.numpy(), q_j, t_j)
    _close_pose(q_t.numpy(), t_t.numpy(), q, t, rot_deg=0.05, t_m=0.01)


def test_refine_pose_iterative_matches_jax():
    pts, xy, q, t, rng = _scene(3, outliers=0.2)
    base = rng.random(len(pts)) > 0.1
    q0 = (q + np.array([0.0, 0.004, 0.0, -0.003], np.float32)).astype(np.float32)
    q_t, t_t, n_t, nums_t = tpnp.refine_pose_iterative(*_tt(q0, t, pts, xy, CAM, base), 4.0,
                                                       iters=3)
    q_j, t_j, n_j, nums_j = jpnp.refine_pose_iterative(*_jj(q0, t, pts, xy, CAM, base), 4.0,
                                                       iters=3)
    np.testing.assert_array_equal(nums_t.numpy(), np.asarray(nums_j))
    assert int(n_t) == int(n_j) > 100
    _close_pose(q_t.numpy(), t_t.numpy(), q_j, t_j)


def test_refine_pose_iterative_stops_below_six():
    pts, xy, q, t, _ = _scene(4)
    base = np.zeros(len(pts), bool)
    base[:5] = True
    q_t, t_t, n_t, nums_t = tpnp.refine_pose_iterative(*_tt(q, t, pts, xy, CAM, base), 4.0)
    assert int(n_t) == 0 and (nums_t.numpy() == -1).all()
    assert torch.equal(q_t, torch.from_numpy(q)) and torch.equal(t_t, torch.from_numpy(t))


def _jax_hypotheses(valid, num_hypotheses, seed):
    """The sample indices jax pnp_ransac draws from PRNGKey(seed)."""
    fvalid = jnp.asarray(valid, jnp.float32)

    def one(k):
        g = jax.random.gumbel(k, (len(valid),)) + jnp.log(fvalid + 1e-30)
        return jax.lax.top_k(g, 6)[1]

    keys = jax.random.split(jax.random.PRNGKey(seed), num_hypotheses)
    return np.asarray(jax.vmap(one)(keys))


@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_pnp_ransac_matches_jax_on_the_same_hypotheses(outliers):
    pts, xy, q, t, _ = _scene(5, n=256, outliers=outliers)
    valid = np.ones(256, bool)
    valid[230:] = False  # padding rows
    res_j = jpnp_ransac(*_jj(xy, pts, CAM, valid), threshold=4.0,
                        key=jax.random.PRNGKey(3), num_hypotheses=128)
    idx = _jax_hypotheses(valid, 128, 3)
    res_t = pnp_ransac_core(*_tt(xy, pts, CAM, valid, idx), threshold=4.0)
    assert int(res_t.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    assert bool(res_t.success)
    _close_pose(res_t.qvec.numpy(), res_t.tvec.numpy(), res_j.qvec, res_j.tvec)
    _close_pose(res_t.qvec.numpy(), res_t.tvec.numpy(), q, t, rot_deg=0.1, t_m=0.02)


def test_sample_minimal_sets_draws_distinct_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[1, 4, 9, 16, 25, 36, 49]] = True
    gen = torch.Generator().manual_seed(0)
    idx = sample_minimal_sets(valid, 200, gen)
    assert idx.shape == (200, 6)
    assert valid[idx].all()
    assert all(len(set(row.tolist())) == 6 for row in idx)
    again = sample_minimal_sets(valid, 200, torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)  # a seeded Generator reproduces its hypotheses
    pts, xy, *_ = _scene(6)
    res = pnp_ransac(*_tt(xy, pts, CAM, np.ones(len(pts), bool)), threshold=4.0,
                     generator=torch.Generator().manual_seed(1), num_hypotheses=64)
    assert bool(res.success) and int(res.num_inliers) > 180


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """bench.py's quick corridor scene, drawn by both builders from one seed."""
    kw = dict(n_images=20, n_queries=4, n_points=2000, kp_per_image=700, kp_per_query=500,
              retrieval_k=10, seed=7)
    path = tmp_path_factory.mktemp("scene") / "f.h5"
    jscene = jbuild_corridor_scene(path, **kw)
    store = FeatureStore()
    tscene = build_corridor_scene(store, **kw)
    return jscene, tscene, store


def test_synth_scene_matches_jax_builder(scenes):
    jscene, tscene, store = scenes
    assert [q[0] for q in tscene.queries] == [q[0] for q in jscene.queries]
    for (_, qa, ta, na), (_, qb, tb, nb) in zip(tscene.queries, jscene.queries):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)
        assert na == nb
    with JFeatureStore(jscene.feature_path, "r") as js:
        assert sorted(store.keys()) == sorted(js.keys())
        for name in store.keys():
            for a, b in zip(store.read(name)[:3], js.read(name)[:3]):
                np.testing.assert_array_equal(a, b)
    ma, mb = tscene.map_index, jscene.map_index
    np.testing.assert_array_equal(ma.point_xyz, mb.point_xyz)
    np.testing.assert_array_equal(ma.track_len, mb.track_len)
    assert (ma.incidence != mb.incidence).nnz == 0


def test_map_index_covisibility_matches_jax(scenes):
    jscene, tscene, _ = scenes
    ma, mb = tscene.map_index, jscene.map_index
    frames = tscene.queries[0][3]
    assert ma.covisibility_clustering(frames) == mb.covisibility_clustering(frames)
    _, q, t, near = tscene.queries[1]
    for seed in near[:3]:
        assert ma.covis_frames_obs(seed, 10, 3, q, t) == mb.covis_frames_obs(seed, 10, 3, q, t)
        assert ma.covis_frames_pose(seed, q, t, 10) == mb.covis_frames_pose(seed, q, t, 10)


QUICK = dict(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10, covisibility_frame=10,
             iters=2, radius=12.0, obs_thresh=3, max_keypoints=1024, num_hypotheses=512,
             pnp_pad_floor=4096)


def _recall(scene, results):
    errs = np.array([pose_error(r.qvec, r.tvec, q, t)
                     for r, (_, q, t, _) in zip(results, scene.queries)])
    return float(np.mean((errs[:, 1] < 0.25) & (errs[:, 0] < 2.0)))


def test_engine_localize_matches_jax_engine(scenes):
    jscene, tscene, store = scenes
    eng = LocalizationEngine(tscene.map_index, store, LocalizerConfig(**QUICK), device="cpu")
    res_t = [eng.localize(n, tscene.qinfo, [[j] for j in near])
             for n, _, _, near in tscene.queries]
    with JFeatureStore(jscene.feature_path, "r") as js:
        jeng = jengine.LocalizationEngine(jscene.map_index, js,
                                          jengine.LocalizerConfig(**QUICK))
        res_j = [jeng.localize(n, jscene.qinfo, [[j] for j in near])
                 for n, _, _, near in jscene.queries]
    assert _recall(tscene, res_t) == _recall(jscene, res_j) == 1.0
    for a, b in zip(res_t, res_j):
        assert a.source == b.source == "accepted"
        # Same matches; RANSAC draws other hypotheses (torch.Generator vs
        # jax.random), so poses agree to the refinement's noise floor.
        _close_pose(a.qvec, a.tvec, b.qvec, b.tvec, rot_deg=0.05, t_m=0.01)


def test_engine_match_round_matches_jax(scenes):
    """One batched match round: the same [D, K] match table, D padded to
    its bucket with all-invalid banks."""
    jscene, tscene, store = scenes
    eng = LocalizationEngine(tscene.map_index, store, LocalizerConfig(**QUICK), device="cpu")
    name, _, _, near = tscene.queries[2]
    kp, desc, _, valid, _ = store.read_padded(name, 1024, with_labels=True)
    m_t = eng._match_query_to_dbs(torch.from_numpy(desc), torch.from_numpy(valid), near)
    with JFeatureStore(jscene.feature_path, "r") as js:
        jeng = jengine.LocalizationEngine(jscene.map_index, js,
                                          jengine.LocalizerConfig(**QUICK))
        m_j = jeng._match_query_to_dbs(desc, valid, near)
    assert _bucket(len(near)) == 16 and m_t.shape == (10, 1024)
    np.testing.assert_array_equal(m_t, m_j)
    assert (m_t >= 0).sum() > 1000


def test_entry_points_refuse_missing_cuda(scenes):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, tscene, store = scenes
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalizationEngine(tscene.map_index, store, LocalizerConfig(**QUICK))


def test_pnp_dlt_fast_matches_jax_in_float64():
    pts, xy, q, t, rng = _scene(9, noise=0.0)
    xn = _norm(xy).astype(np.float64)
    pts = pts.astype(np.float64)
    with jax.enable_x64(True):
        for _ in range(8):
            idx = rng.choice(len(pts), 6, replace=False)
            q_t, t_t = tpnp.pnp_dlt_fast(*_tt(pts[idx], xn[idx]))
            q_j, t_j = jpnp.pnp_dlt_fast(*_jj(pts[idx], xn[idx]))
            assert q_t.dtype == torch.float64 and q_t.shape == (4,) and t_t.shape == (3,)
            np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0, atol=1e-8)
            np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-8)
            # Noise-free points: the minimal sample recovers the pose.
            _close_pose(q_t.numpy(), t_t.numpy(), q, t, rot_deg=1e-3, t_m=1e-4)
