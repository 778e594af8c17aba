"""The port's InLoc (RGB-D) localization against the JAX package's.

The synthetic RGB-D scene of ``tests/test_inloc.py`` (a DB frame at the
identity with a splatted scan, NaN elsewhere) plus two more frames. The
port matches all frames in one padded batched launch of K2's plain
version; each frame's matches must equal a per-frame plain call's and the
JAX ``mutual_nn_match``'s (the scene has no exact ties), and the pooled
correspondences the JAX function's loop builds. PnP-RANSAC is fed the
indices the JAX sampler draws from ``PRNGKey(0)``, so it must end with the
JAX inlier count and a pose within 1e-2° / 1e-3 m of the JAX pose (float32
solves in both packages, ``tests/test_torch_localization.py``). With its
own ``torch.Generator`` sampling the port meets the JAX test's bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.localization import inloc as tinloc
from sfd2_torch.localization.ransac import pnp_ransac_core
from sfd2_torch.ops.matching import mutual_nn_match
from sfd2_tpu.geometry.cameras import canonicalize_params
from sfd2_tpu.localization import inloc as jinloc
from sfd2_tpu.localization.engine import _np_project
from sfd2_tpu.localization.ransac import pnp_ransac as jpnp_ransac
from sfd2_tpu.ops.matching import mutual_nn_match as jmutual_nn_match

torch.set_num_threads(2)

CAM_PARAMS = [500.0, 500.0, 320.0, 240.0]
CAM8 = canonicalize_params("PINHOLE", CAM_PARAMS)


def _in_frame(xy, depth):
    return (depth > 0) & (xy[:, 0] > 2) & (xy[:, 0] < 638) & (xy[:, 1] > 2) & (xy[:, 1] < 478)


@pytest.fixture(scope="module")
def rgbd_scene():
    rng = np.random.default_rng(3)
    n_pts = 400
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(5, 9, n_pts)], 1)
    pdesc = rng.normal(size=(n_pts, 32)).astype(np.float32)
    pdesc /= np.linalg.norm(pdesc, axis=1, keepdims=True)
    entries = []
    for k, (rv, c) in enumerate((([0, 0, 0], [0, 0, 0]), ([0.02, 0.01, 0], [0.3, 0, 0]),
                                 ([-0.01, 0.03, 0.01], [-0.25, 0.1, 0]))):
        r = Rotation.from_rotvec(rv)
        q = r.as_quat()[[3, 0, 1, 2]]
        t = -r.as_matrix() @ np.array(c, float)
        xy, depth = _np_project(pts, q, t, CAM8)
        idx = np.nonzero(_in_frame(xy, depth))[0][: 150 + 60 * k]  # ragged frames
        kpts = xy[idx].astype(np.float32)
        scan = np.full((480, 640, 3), np.nan)
        for p, (x, y) in zip(pts[idx], kpts):
            xi, yi = int(round(x)), int(round(y))
            scan[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] = p
        entries.append((kpts, pdesc[idx], scan))
    r = Rotation.from_rotvec([0.02, -0.03, 0.01])
    q_gt = r.as_quat()[[3, 0, 1, 2]]
    t_gt = -r.as_matrix() @ np.array([0.2, 0.1, -0.2])
    xy_q, depth_q = _np_project(pts, q_gt, t_gt, CAM8)
    qi = np.nonzero(_in_frame(xy_q, depth_q))[0][:220]
    q_kpts = (xy_q[qi] + rng.normal(size=(len(qi), 2)) * 0.3).astype(np.float32)
    q_desc = pdesc[qi] + rng.normal(size=(len(qi), 32)).astype(np.float32) * 0.05
    q_desc /= np.linalg.norm(q_desc, axis=1, keepdims=True)
    return q_kpts, q_desc, entries, q_gt, t_gt


def test_interpolate_scan_matches_jax():
    rng = np.random.default_rng(0)
    scan = rng.normal(size=(30, 40, 3))
    scan[rng.random((30, 40)) < 0.1] = np.nan
    kpts = np.stack([rng.uniform(-2, 42, 500), rng.uniform(-2, 32, 500)], 1)
    a, va = tinloc.interpolate_scan(scan, kpts)
    b, vb = jinloc.interpolate_scan(scan, kpts)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(a[va], b[vb])


def test_padded_batch_matches_per_frame_calls(rgbd_scene):
    """One padded launch over ragged frames = a plain call per frame = the
    JAX matcher per frame."""
    q_kpts, q_desc, entries, _, _ = rgbd_scene
    batched = tinloc.match_frames(q_desc, [d for _, d, _ in entries], "cpu")
    for m, (_, desc, _) in zip(batched, entries):
        single, _ = mutual_nn_match(torch.from_numpy(q_desc), torch.from_numpy(desc))
        np.testing.assert_array_equal(m, single.numpy())
        ref, _ = jmutual_nn_match(jnp.asarray(q_desc), jnp.asarray(desc))
        np.testing.assert_array_equal(m, np.asarray(ref))
        assert (m >= 0).sum() > 50


def _jax_hypotheses(valid, num_hypotheses, seed):
    """The sample indices the JAX pnp_ransac draws from PRNGKey(seed)."""
    fvalid = jnp.asarray(valid, jnp.float32)

    def one(k):
        g = jax.random.gumbel(k, (len(valid),)) + jnp.log(fvalid + 1e-30)
        return jax.lax.top_k(g, 6)[1]

    keys = jax.random.split(jax.random.PRNGKey(seed), num_hypotheses)
    return np.asarray(jax.vmap(one)(keys))


@pytest.mark.parametrize("thresh", [8.0, 48.0])
def test_localize_rgbd_matches_jax_on_the_same_samples(rgbd_scene, thresh):
    q_kpts, q_desc, entries, q_gt, t_gt = rgbd_scene
    ref = jinloc.localize_rgbd(q_kpts, q_desc, entries, "PINHOLE", CAM_PARAMS,
                               ransac_thresh=thresh)
    p2d, p3d = tinloc.rgbd_correspondences(q_kpts, q_desc, entries, "cpu")
    xy, pw, va = tinloc.pad_correspondences(p2d, p3d)
    # The JAX function's pooled input, rebuilt here from its own matcher.
    res_j = jpnp_ransac(jnp.asarray(xy), jnp.asarray(pw), jnp.asarray(CAM8, jnp.float32),
                        jnp.asarray(va), threshold=thresh, key=jax.random.PRNGKey(0))
    assert int(res_j.num_inliers) == ref["num_inliers"]
    idx = _jax_hypotheses(va, 1024, 0)
    got = pnp_ransac_core(torch.from_numpy(xy), torch.from_numpy(pw),
                          torch.from_numpy(CAM8.astype(np.float32)), torch.from_numpy(va),
                          torch.from_numpy(idx.copy()), threshold=thresh)
    assert bool(got.success) == ref["success"]
    assert int(got.num_inliers) == ref["num_inliers"]
    q_err, t_err = pose_error(got.qvec.double().numpy(), got.tvec.double().numpy(),
                              ref["qvec"], ref["tvec"])
    assert q_err < 1e-2 and t_err < 1e-3, (q_err, t_err)


def test_localize_rgbd_meets_the_jax_bars(rgbd_scene):
    q_kpts, q_desc, entries, q_gt, t_gt = rgbd_scene
    res = tinloc.localize_rgbd(q_kpts, q_desc, entries, "PINHOLE", CAM_PARAMS,
                               ransac_thresh=8.0, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    assert res["success"], res
    qe, te = pose_error(res["qvec"], res["tvec"], q_gt, t_gt)
    assert qe < 1.0 and te < 0.15, (qe, te)


def test_localize_rgbd_too_few_matches():
    rng = np.random.default_rng(1)
    desc = rng.normal(size=(4, 16)).astype(np.float32)
    res = tinloc.localize_rgbd(rng.uniform(0, 100, (4, 2)).astype(np.float32), desc,
                               [(rng.uniform(0, 100, (4, 2)).astype(np.float32), desc,
                                 np.zeros((120, 120, 3)))], "PINHOLE", CAM_PARAMS, device="cpu")
    assert res == {"success": False, "num_inliers": 0, "qvec": None, "tvec": None}
