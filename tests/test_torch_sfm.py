"""The map-building stages of the port against the JAX package.

The 6-camera scene of ``tests/test_map_building.py`` feeds both packages
the same features and matches. Tolerances: F-RANSAC fed the JAX sampler's
indices keeps the same ``success`` flags and inlier masks equal on ≥ 99 %
of matches, with both packages in float64 (in float32 the Gram-matrix fits
of both amplify rounding); F agrees up to scale and sign within 1e-4 on a
well-conditioned pair and within 1e-3 on the scene's near-pure-translation
pairs, whose 8-point systems have two near-null directions; tracks are
identical (integer bookkeeping); triangulated points agree within 1e-4
relative with the same ``valid`` flags and inlier masks; COLMAP models
written by either package read back bit-identical. The whole map build
and the reconstruction are in ``test_torch_map_build.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sfd2_torch.geometry.cameras import Camera as TCamera
from sfd2_torch.io import colmap_model as tcm
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_torch.sfm import tracks as ttracks
from sfd2_torch.sfm.pipeline import TriangulationConfig, geometric_verification
from sfd2_torch.sfm.triangulation import triangulate_tracks
from sfd2_torch.sfm.twoview import (
    _msac,
    _rank2_project,
    _sym3_smallest_eigvec,
    decompose_essential,
    essential_from_fundamental,
    fit_fundamental,
    sampson_error,
    verify_fundamental_ransac,
    verify_fundamental_ransac_core,
)
from sfd2_tpu.geometry.cameras import Camera, canonicalize_params
from sfd2_tpu.io import colmap_model as jcm
from sfd2_tpu.io import feature_store as jfs
from sfd2_tpu.localization.engine import _np_project
from sfd2_tpu.sfm import tracks as jtracks
from sfd2_tpu.sfm import twoview as jtv
from sfd2_tpu.sfm.triangulation import triangulate_tracks as j_triangulate_tracks

torch.set_num_threads(2)

W, H = 640, 480
CAM_PARAMS = [520.0, 520.0, 320.0, 240.0]
CAM8 = canonicalize_params("PINHOLE", CAM_PARAMS)


def build_scene(seed, n_pts, n_cams, baseline, offset, y_step, rot_sigma, kp_noise, subsample):
    """Synthetic cameras over a point field (the scenes of
    tests/test_map_building.py and tests/test_reconstruction.py)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 14, n_pts)], 1)
    pdesc = rng.normal(size=(n_pts, 64)).astype(np.float32)
    pdesc /= np.linalg.norm(pdesc, axis=1, keepdims=True)
    poses, feats, kp_to_gt = {}, {}, {}
    margin = 5 if subsample else 8
    for i in range(n_cams):
        r = Rotation.from_rotvec(rng.normal(size=3) * rot_sigma)
        q = r.as_quat()[[3, 0, 1, 2]]
        t = -r.as_matrix() @ np.array([i * baseline + offset, y_step * i, 0.0])
        xy, depth = _np_project(pts, q, t, CAM8)
        lo_ok = (xy >= margin) if subsample else (xy > margin)
        vis = ((depth > 0) & lo_ok[:, 0] & (xy[:, 0] < W - margin) & lo_ok[:, 1]
               & (xy[:, 1] < H - margin))
        if subsample:
            vis &= rng.random(n_pts) < 0.9
        idx = np.nonzero(vis)[0]
        kp = xy[idx] + rng.normal(size=(len(idx), 2)) * kp_noise
        de = pdesc[idx] + rng.normal(size=(len(idx), 64)).astype(np.float32) * 0.04
        de /= np.linalg.norm(de, axis=1, keepdims=True)
        name = f"db/{i + 1:04d}.jpg" if subsample else f"img_{i}.jpg"
        poses[name] = (q, t)
        feats[name] = (kp.astype(np.float32), de, rng.random(len(idx)).astype(np.float32))
        kp_to_gt[name] = idx
    return pts, poses, feats, kp_to_gt


def make_scene(base):
    """The 6-camera scene written under `base`, matched by the port (NNM)."""
    pts, poses, feats, kp_to_gt = build_scene(11, 300, 6, 0.7, -1.75, 0.0, 0.04, 0.2, True)
    names = sorted(feats)
    cameras = {1: Camera(1, "PINHOLE", W, H, np.array(CAM_PARAMS))}
    ref_images = {i + 1: jcm.Image(i + 1, poses[n][0], poses[n][1], 1, n, np.zeros((0, 2)),
                                   np.zeros(0, np.int64)) for i, n in enumerate(names)}
    jcm.write_model(cameras, ref_images, {}, base / "ref_model", ext=".bin")
    port_feats = FeatureStore()
    with jfs.FeatureStore(base / "f.h5", "w") as fs:
        for n, (kp, de, sc) in feats.items():
            fs.write(n, jfs.ImageFeatures(kp, de, sc, None))
            port_feats.write(n, ImageFeatures(kp, de, sc, None))
    pairs = [(a, b) for ai, a in enumerate(names) for b in names[ai + 1:]]
    port_matches = MatchStore()
    match_pairs(port_feats, pairs, port_matches, MatchConfig(max_keypoints=512, batch_size=8),
                device="cpu")
    with jfs.MatchStore(base / "m.h5", "w") as ms:
        for n0, n1 in pairs:
            ms.write(n0, n1, *port_matches.read(n0, n1))
    return dict(base=base, pts=pts, names=names, pairs=pairs, kp_to_gt=kp_to_gt,
                feats=feats, port_feats=port_feats, port_matches=port_matches,
                ref_images=ref_images, cameras=cameras)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("map"))


def _jax_sample_idx(key, valid, num_hypotheses):
    """The sampler of sfd2_tpu/sfm/twoview.py::verify_fundamental_ransac."""
    fvalid = valid.astype(jnp.float32)

    def sample_one(k):
        g = jax.random.gumbel(k, (valid.shape[0],)) + jnp.log(fvalid + 1e-30)
        return jax.lax.top_k(g, 8)[1]

    return jax.vmap(sample_one)(jax.random.split(key, num_hypotheses))


def _padded_pair(scene, n0, n1, max_matches=256):
    m, _ = scene["port_matches"].read(n0, n1)
    src = np.nonzero(m >= 0)[0][:max_matches]
    xy1 = np.zeros((max_matches, 2), np.float32)
    xy2 = np.zeros((max_matches, 2), np.float32)
    val = np.zeros(max_matches, bool)
    xy1[:len(src)] = scene["feats"][n0][0][src]
    xy2[:len(src)] = scene["feats"][n1][0][m[src]]
    val[:len(src)] = True
    return xy1, xy2, val


def f_ransac_on_scene_pairs(scene, x64: bool, h: int = 512):
    """Pairs 0, 4 and 9 of the scene, the last with a fifth of its matches
    scrambled, through both packages' F-RANSAC fed the same samples, both
    in float64 (`x64`) or both in float32. Returns (port result, JAX
    results [(F, inliers, num_inliers, success)] per pair)."""
    batch = [_padded_pair(scene, *scene["pairs"][i]) for i in (0, 4, 9)]
    rng = np.random.default_rng(2)
    xy2_bad = batch[2][1].copy()
    bad = rng.choice(np.nonzero(batch[2][2])[0], batch[2][2].sum() // 5, replace=False)
    xy2_bad[bad] = rng.uniform(0, 480, size=(len(bad), 2))
    batch[2] = (batch[2][0], xy2_bad, batch[2][2])
    jdt = jnp.float64 if x64 else jnp.float32
    idx, ref = [], []
    with jax.enable_x64(x64):
        for bi, (xy1, xy2, val) in enumerate(batch):
            key = jax.random.PRNGKey(bi)
            idx.append(np.asarray(_jax_sample_idx(key, jnp.asarray(val), h)))
            r = jtv.verify_fundamental_ransac(jnp.asarray(xy1, jdt), jnp.asarray(xy2, jdt),
                                              jnp.asarray(val), 4.0, key, num_hypotheses=h)
            ref.append([np.asarray(a) for a in r])
    xy1, xy2, val = (torch.from_numpy(np.stack(a)) for a in zip(*batch))
    tdt = torch.float64 if x64 else torch.float32
    got = verify_fundamental_ransac_core(xy1.to(tdt), xy2.to(tdt), val,
                                         torch.from_numpy(np.stack(idx)).long())
    return got, ref


def f_gap(f_t, f_j) -> float:
    """Largest entry of |F_port − F_jax|, up to sign (both unit-norm)."""
    return float(min(np.abs(f_t - f_j).max(), np.abs(f_t + f_j).max()))


def test_f_ransac_matches_jax_on_the_same_samples(scene):
    """Three pairs of the scene, one with a fifth of its matches scrambled,
    both packages in float64 and fed the same samples. In float32 the
    8-point Gram solves of both packages amplify rounding (condition
    number squared), so the two pick different near-equal hypotheses; in
    float64 the algorithms, not the rounding, decide. F is held to 1e-3
    up to scale and sign: the scene's cameras translate along x with small
    rotations, so each 8-point system has two near-null directions, the
    MSAC winner among near-equal hypotheses can differ, and the final F
    moves. ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sfm.py``
    prints the gaps per pair in float64 and float32."""
    got, ref = f_ransac_on_scene_pairs(scene, x64=True)
    for bi, (f_j, inl_j, _, ok_j) in enumerate(ref):
        assert bool(got.success[bi]) == bool(ok_j)
        assert (got.inliers[bi].numpy() == inl_j).mean() >= 0.99
        assert f_gap(got.fmatrix[bi].numpy(), f_j) <= 1e-3
    assert got.success.all() and got.num_inliers[2] < got.num_inliers[1]
    # float32, the working type: the same verdicts.
    got32, _ = f_ransac_on_scene_pairs(scene, x64=False)
    assert got32.fmatrix.dtype == torch.float32
    assert got32.success.tolist() == [bool(r[3]) for r in ref]


def _wide_baseline_pair(seed, outlier_frac, n=200, n_pad=256):
    """A two-view geometry with rotation and a wide baseline (well
    conditioned for the 8-point fit), 0.3 px noise, some matches scrambled."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 12, n)], 1)
    r = Rotation.from_rotvec(np.array([0.05, -0.25, 0.03]))
    xy1, _ = _np_project(pts, np.array([1.0, 0, 0, 0]), np.zeros(3), CAM8)
    xy2, _ = _np_project(pts, r.as_quat()[[3, 0, 1, 2]], -r.as_matrix() @ np.array([2.5, 0.3, 0.5]),
                         CAM8)
    xy1 += rng.normal(size=xy1.shape) * 0.3
    xy2 += rng.normal(size=xy2.shape) * 0.3
    bad = rng.choice(n, int(outlier_frac * n), replace=False)
    xy2[bad] = rng.uniform(0, 480, size=(len(bad), 2))
    a1, a2, val = np.zeros((n_pad, 2)), np.zeros((n_pad, 2)), np.zeros(n_pad, bool)
    a1[:n], a2[:n], val[:n] = xy1, xy2, True
    return a1, a2, val


@pytest.mark.parametrize("seed,outlier_frac", [(0, 0.0), (1, 0.2), (3, 0.0), (4, 0.2)])
def test_f_ransac_matches_jax_on_a_well_conditioned_pair(seed, outlier_frac):
    """Rotation and a wide baseline, float64, the same samples: F agrees
    within 1e-4 up to scale and sign (measured ≤ 3e-6 here; with 40 %
    outliers two near-equal hypotheses can trade places, 1.7e-4)."""
    xy1, xy2, val = _wide_baseline_pair(seed, outlier_frac)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(seed)
        idx = np.asarray(_jax_sample_idx(key, jnp.asarray(val), 512))
        f_j, inl_j, _, ok_j = (np.asarray(a) for a in jtv.verify_fundamental_ransac(
            jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(val), 4.0, key, num_hypotheses=512))
    got = verify_fundamental_ransac_core(*(torch.from_numpy(a)[None] for a in (xy1, xy2, val)),
                                         torch.from_numpy(idx).long()[None])
    assert bool(got.success[0]) == bool(ok_j)
    assert (got.inliers[0].numpy() == inl_j).mean() >= 0.99
    f_t = got.fmatrix[0].numpy()
    assert min(np.abs(f_t - f_j).max(), np.abs(f_t + f_j).max()) <= 1e-4


def test_f_ransac_samples_from_a_generator(scene):
    xy1, xy2, val = (torch.from_numpy(np.stack(a)) for a in zip(
        *[_padded_pair(scene, *scene["pairs"][i]) for i in (0, 3)]))
    res = verify_fundamental_ransac(xy1, xy2, val, generator=torch.Generator().manual_seed(3),
                                    num_hypotheses=256)
    assert res.fmatrix.shape == (2, 3, 3) and bool(res.success.all())
    assert (res.inliers.sum(1) >= 0.9 * val.sum(1)).all()


def test_fundamental_helpers_match_jax(rng):
    f = rng.normal(size=(5, 3, 3)).astype(np.float32)
    a = f @ np.swapaxes(f, -1, -2)
    v_t = _sym3_smallest_eigvec(torch.from_numpy(a)).numpy()
    v_j = np.asarray(jtv._sym3_smallest_eigvec(jnp.asarray(a)))
    np.testing.assert_allclose(np.abs(np.sum(v_t * v_j, -1)), 1.0, atol=1e-4)
    np.testing.assert_allclose(_rank2_project(torch.from_numpy(f)).numpy(),
                               np.asarray(jtv._rank2_project(jnp.asarray(f))), atol=1e-4)
    xy1 = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    xy2 = xy1 + rng.normal(size=(40, 2)).astype(np.float32)
    f_t = fit_fundamental(torch.from_numpy(xy1), torch.from_numpy(xy2)).numpy()
    f_j = np.asarray(jtv.fit_fundamental(jnp.asarray(xy1), jnp.asarray(xy2)))
    np.testing.assert_allclose(sampson_error(torch.from_numpy(f_t), torch.from_numpy(xy1),
                                             torch.from_numpy(xy2)).numpy(),
                               np.asarray(jtv.sampson_error(jnp.asarray(f_j), jnp.asarray(xy1),
                                                            jnp.asarray(xy2))),
                               rtol=1e-3, atol=1e-3)


def _sampson_matmul(f, xy1, xy2):
    """The matmul form of the Sampson error (homogeneous copies and
    [..., N, 3] products), the reference expression of the element-wise
    ``sampson_error``."""
    ones = torch.ones_like(xy1[..., :1])
    h1, h2 = torch.cat([xy1, ones], dim=-1), torch.cat([xy2, ones], dim=-1)
    fx1 = h1 @ f.transpose(-1, -2)
    ftx2 = h2 @ f
    num = torch.sum(h2 * fx1, dim=-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _f_batch(rng, lead):
    """Fundamental matrices [*lead, 3, 3] of image-scale pairs, and matches
    [B, 1, N, 2] near them, float64."""
    f = rng.normal(size=(*lead, 3, 3))
    f[..., 2, :] *= 100.0
    f[..., :, 2] *= 100.0
    xy1 = rng.uniform(0, 640, size=(lead[0], 1, 300, 2))
    xy2 = xy1 + rng.normal(size=xy1.shape) * 3.0
    return f, xy1, xy2


@pytest.mark.parametrize("lead", [(1, 1), (3, 5)])
def test_sampson_elementwise_matches_matmul_and_jax_float64(rng, lead):
    f, xy1, xy2 = _f_batch(rng, lead)
    ft, x1, x2 = (torch.from_numpy(a) for a in (f, xy1, xy2))
    got = sampson_error(ft, x1, x2)
    assert got.dtype == torch.float64 and got.shape == (*lead, 300)
    ref = _sampson_matmul(ft, x1, x2)
    scale = ref.abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12 * scale)
    with jax.enable_x64(True):
        for b in range(lead[0]):
            for h in range(lead[1]):
                j = np.asarray(jtv.sampson_error(jnp.asarray(f[b, h]), jnp.asarray(xy1[b, 0]),
                                                 jnp.asarray(xy2[b, 0])))
                np.testing.assert_allclose(got[b, h].numpy(), j, rtol=1e-12,
                                           atol=1e-12 * scale)


def test_fused_msac_matches_the_matmul_form_float64(rng):
    f, xy1, xy2 = _f_batch(rng, (2, 4))
    ft, x1, x2 = (torch.from_numpy(a) for a in (f, xy1, xy2))
    valid = torch.from_numpy(rng.random((2, 1, 300)) < 0.8)
    thr2 = 16.0
    got = _msac(ft, x1, x2, valid, thr2)
    ref = torch.sum(torch.where(valid, torch.clamp(_sampson_matmul(ft, x1, x2), max=thr2), thr2),
                    dim=-1)
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    assert (got < thr2 * 300).any()  # some errors fall under the clamp


def test_twoview_scoring_has_no_matmul():
    """The Sampson error and MSAC score are written out over F's entries:
    no `@`/matmul and no homogeneous copy of the points in their source."""
    import inspect

    from sfd2_torch.sfm import twoview

    src = "".join(inspect.getsource(fn) for fn in (twoview._sampson_terms,
                                                   twoview.sampson_error, twoview._msac))
    for banned in ("@", "matmul", "torch.cat", "einsum", "bmm"):
        assert banned not in src, banned


def test_essential_decomposition_matches_jax(scene):
    n0, n1 = scene["pairs"][0]
    xy1, xy2, val = _padded_pair(scene, n0, n1)
    xy1, xy2 = xy1[val] + 0.5, xy2[val] + 0.5
    k = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]], np.float32)
    nrm1 = ((np.c_[xy1, np.ones(len(xy1))] @ np.linalg.inv(k).T)[:, :2]).astype(np.float32)
    nrm2 = ((np.c_[xy2, np.ones(len(xy2))] @ np.linalg.inv(k).T)[:, :2]).astype(np.float32)
    e_t = essential_from_fundamental(fit_fundamental(torch.from_numpy(xy1), torch.from_numpy(xy2)),
                                     torch.from_numpy(k), torch.from_numpy(k))
    rot, t, n_front = decompose_essential(e_t, torch.from_numpy(nrm1), torch.from_numpy(nrm2))
    e_j = jtv.essential_from_fundamental(jtv.fit_fundamental(jnp.asarray(xy1), jnp.asarray(xy2)),
                                         jnp.asarray(k), jnp.asarray(k))
    rot_j, t_j, n_j = jtv.decompose_essential(e_j, jnp.asarray(nrm1), jnp.asarray(nrm2))
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_j), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-4)
    assert float(n_front) == float(n_j) == len(xy1)


@pytest.fixture(scope="module")
def verified(scene):
    cfg = TriangulationConfig(verify_batch=8)
    return geometric_verification(scene["port_feats"], scene["port_matches"], scene["pairs"],
                                  cfg, device="cpu")


def _same_tracks(got, ref):
    """Identical lists where the JAX package runs its C++ union-find (the
    port's rule); the same tracks in another order where it falls back to
    its Python loop, whose roots differ."""
    from sfd2_tpu.native import get_lib

    if get_lib() is not None:
        return got == ref
    return sorted(got) == sorted(ref)


def test_build_tracks_identical(scene, verified):
    name_id = {n: i + 1 for i, n in enumerate(scene["names"])}
    nkp = {name_id[n]: len(f[0]) for n, f in scene["feats"].items()}
    vm = [(name_id[a], name_id[b], m) for a, b, m in verified]
    assert len(vm) == len(scene["pairs"])
    got = ttracks.build_tracks(nkp, vm)
    assert _same_tracks(got, jtracks.build_tracks(nkp, vm)) and len(got) > 200
    assert _same_tracks(ttracks.build_tracks(nkp, vm, min_track_length=4),
                        jtracks.build_tracks(nkp, vm, min_track_length=4))


def test_build_tracks_arrays_identical(rng):
    from sfd2_tpu.native import get_lib

    edges = rng.integers(0, 5 * 40, size=(300, 2))
    got = ttracks.build_tracks_arrays(5, 40, edges, 3)
    ref = jtracks.build_tracks_arrays(5, 40, edges, 3)
    assert got[3] == ref[3]
    if get_lib() is not None:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    canon = lambda r: sorted(zip(r[0].tolist(), r[1].tolist()))  # noqa: E731
    assert canon(got) == canon(ref)


def test_union_find_roots_partition_like_jax(rng):
    from sfd2_tpu.native import get_lib, union_find_roots

    edges = rng.integers(0, 60, size=(40, 2))
    roots = ttracks.union_find_roots(60, edges)
    ref = jtracks.UnionFind(60)
    for a, b in edges.tolist():
        ref.union(a, b)
    ref_roots = np.array([ref.find(i) for i in range(60)])
    assert (np.equal.outer(roots, roots) == np.equal.outer(ref_roots, ref_roots)).all()
    if get_lib() is not None:
        np.testing.assert_array_equal(roots, union_find_roots(60, edges))


def test_triangulate_tracks_matches_jax(scene, verified):
    name_id = {n: i + 1 for i, n in enumerate(scene["names"])}
    id_name = {v: k for k, v in name_id.items()}
    tracks = ttracks.build_tracks({name_id[n]: len(f[0]) for n, f in scene["feats"].items()},
                                  [(name_id[a], name_id[b], m) for a, b, m in verified])
    t_pad = 8
    p = len(tracks)
    obs = np.zeros((p, t_pad, 2), np.float32)
    mask = np.zeros((p, t_pad), bool)
    qv = np.zeros((p, t_pad, 4), np.float32)
    qv[..., 0] = 1
    tv = np.zeros((p, t_pad, 3), np.float32)
    cm = np.ones((p, t_pad, 8), np.float32)
    ref_images = {im.name: im for im in scene["ref_images"].values()}
    for pi, tr in enumerate(tracks):
        for oi, (iid, k) in enumerate(tr[:t_pad]):
            im = ref_images[id_name[iid]]
            obs[pi, oi] = scene["feats"][im.name][0][k] + 0.5
            mask[pi, oi] = True
            qv[pi, oi], tv[pi, oi], cm[pi, oi] = im.qvec, im.tvec, CAM8
    got = triangulate_tracks(*(torch.from_numpy(a) for a in (obs, mask, qv, tv, cm)))
    ref = j_triangulate_tracks(*(jnp.asarray(a) for a in (obs, mask, qv, tv, cm)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    xyz_t, xyz_j = got.xyz.numpy(), np.asarray(ref.xyz)
    assert (np.linalg.norm(xyz_t - xyz_j, axis=1) <= 1e-4 * np.linalg.norm(xyz_j, axis=1)).all()
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(ref.errors), atol=1e-3)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_model_io_round_trips_against_the_jax_codec(rng, tmp_path, ext):
    cams = {1: TCamera(1, "PINHOLE", W, H, np.array(CAM_PARAMS)),
            2: TCamera(2, "SIMPLE_RADIAL", 800, 600, np.array([600.0, 400, 300, 0.01]))}
    images = {i: tcm.Image(i, rng.normal(size=4), rng.normal(size=3), 1 + i % 2, f"im/{i}.jpg",
                           rng.uniform(0, 600, size=(5, 2)), rng.integers(-1, 9, 5))
              for i in (1, 2, 3)}
    points = {p: tcm.Point3D(p, rng.normal(size=3), rng.integers(0, 255, 3).astype(np.uint8), 0.5,
                             np.array([1, 2], np.int32), np.array([0, 4], np.int32))
              for p in (3, 7)}
    tcm.write_model(cams, images, points, tmp_path / "port", ext=ext)
    j_cams, j_images, j_points = jcm.read_model(tmp_path / "port")
    jcm.write_model(j_cams, j_images, j_points, tmp_path / "jax", ext=ext)
    for a, b in zip(tcm.read_model(tmp_path / "jax"), (cams, images, points)):
        assert a.keys() == b.keys()
        for k in a:
            for fa, fb in zip(vars(a[k]).values(), vars(b[k]).values()):
                np.testing.assert_array_equal(fa, fb)
    for name in ("cameras", "images", "points3D"):
        assert (tmp_path / "port" / f"{name}{ext}").read_bytes() == \
            (tmp_path / "jax" / f"{name}{ext}").read_bytes()


if __name__ == "__main__":
    # The readings behind the F tolerance of the scene-pair test: per pair,
    # the F gap (up to sign) and the share of equal inlier flags between
    # the port and the JAX package, both in float64 and both in float32.
    import json
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        sc = make_scene(Path(tmp))
        for x64 in (True, False):
            got, ref = f_ransac_on_scene_pairs(sc, x64)
            print(json.dumps({
                "dtype": "float64" if x64 else "float32",
                "f_gap": [f_gap(got.fmatrix[b].numpy(), r[0]) for b, r in enumerate(ref)],
                "inliers_equal": [float((got.inliers[b].numpy() == r[1]).mean())
                                  for b, r in enumerate(ref)],
                "success": [[bool(got.success[b]), bool(r[3])] for b, r in enumerate(ref)]}))
