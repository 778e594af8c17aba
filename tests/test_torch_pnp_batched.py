"""The port's PnP-RANSAC and LM with a leading query axis.

* LM's analytic 2×6 Jacobian against ``torch.func.jacfwd`` of the same
  residual in float64 (at δ = 0, at a random δ, below the Taylor guard,
  distortion on): relative 1e-6.
* Batched ``refine_pose_lm``, ``refine_pose_iterative`` and
  ``pnp_ransac_core`` at Q = 3 queries with different numbers of valid
  rows, padded to one N, against Q single calls on the same rows.
* The batched RANSAC and refinement against the JAX engine's vmapped
  programs (``sfd2_tpu/localization/engine.py::_packed_pnp_batch``,
  ``_packed_refine_batch``), fed the hypotheses JAX's own sampler draws,
  within the tolerances of ``tests/test_torch_localization.py``: the same
  inliers and counts, poses within 1e-2° / 1e-3 m.
* The eager run of a program equals ``graphs.run`` on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_localization import CAM, _close_pose, _scene

from sfd2_torch.localization import graphs
from sfd2_torch.localization import pnp as tpnp
from sfd2_torch.localization.ransac import (fold_seed, pnp_ransac_core, pnp_ransac_program,
                                            sample_minimal_sets)
from sfd2_torch.utils import profiling
from sfd2_tpu.localization import engine as jengine

torch.set_num_threads(2)

Q_N = (150, 220, 90)  # valid rows of the three queries
N = 256  # padded rows


def _batch(outliers=0.0, noise=0.3, seed=10):
    """Three scenes of Q_N valid rows padded to N: (pts [3,N,3], xy [3,N,2],
    valid [3,N], cams [3,8], poses [(q, t)])."""
    pts = np.zeros((3, N, 3), np.float32)
    xy = np.zeros((3, N, 2), np.float32)
    valid = np.zeros((3, N), bool)
    poses = []
    for i, n in enumerate(Q_N):
        p, x, q, t, _ = _scene(seed + i, n=n, outliers=outliers, noise=noise)
        pts[i, :n], xy[i, :n], valid[i, :n] = p, x, True
        poses.append((q, t))
    return pts, xy, valid, np.tile(CAM, (3, 1)), poses


def _perturbed(poses, scale=1.0):
    q0 = np.stack([q + np.array([0.0, 0.01, -0.01, 0.0]) * scale for q, _ in poses])
    t0 = np.stack([t + np.array([0.05, -0.03, 0.04]) * scale for _, t in poses])
    return q0.astype(np.float32), t0.astype(np.float32)


def _residual_args(seed, dtype=torch.float64):
    pts, xy, q, t, rng = _scene(seed, n=60)
    w = (rng.random(60) > 0.2).astype(np.float64)
    cam = torch.tensor(CAM, dtype=dtype)[None]
    rot0 = tpnp.qvec_to_rotmat(torch.tensor(q, dtype=dtype))[None]
    return (rot0, torch.tensor(t, dtype=dtype)[None], torch.tensor(pts, dtype=dtype)[None],
            torch.tensor(xy, dtype=dtype)[None], cam, torch.tensor(w, dtype=dtype)[None])


@pytest.mark.parametrize("delta", ["zero", "random", "below_taylor_guard"])
def test_analytic_jacobian_matches_jacfwd(delta):
    args = _residual_args(20)
    d = {"zero": np.zeros(6),
         "random": np.array([0.04, -0.07, 0.03, 0.2, -0.1, 0.15]),
         "below_taylor_guard": np.array([3e-5, -4e-5, 5e-5, 1e-3, 2e-3, -1e-3])}[delta]
    d = torch.tensor(d, dtype=torch.float64)
    if delta == "below_taylor_guard":
        assert float(torch.sum(d[:3] ** 2)) < 1e-8

    def residual(x):
        return tpnp.lm_linearize(x[None], *args, jacobian=False)[0].reshape(-1)

    ref = torch.func.jacfwd(residual)(d)
    r, jac = tpnp.lm_linearize(d[None], *args)
    assert torch.equal(r[0].reshape(-1), residual(d))
    jac = jac[0].reshape(-1, 6)
    assert (ref.abs() > 0).any() and torch.isfinite(jac).all()
    rel = float((jac - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-6, rel
    # Rows of weight 0 have zero Jacobians, as with jacfwd.
    dead = (args[-1][0] == 0).repeat_interleave(2)
    assert dead.any() and float(jac[dead].abs().max()) == 0.0


def test_analytic_jacobian_columns_by_finite_differences():
    """A second, independent check: central differences in float64."""
    args = _residual_args(21)
    d = torch.tensor([0.02, 0.01, -0.03, 0.05, 0.02, -0.04], dtype=torch.float64)
    _, jac = tpnp.lm_linearize(d[None], *args)
    jac = jac[0].reshape(-1, 6)
    for k in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[k] = 1e-6
        fd = (tpnp.lm_linearize((d + e)[None], *args, jacobian=False)
              - tpnp.lm_linearize((d - e)[None], *args, jacobian=False)).reshape(-1) / 2e-6
        assert float((fd - jac[:, k]).abs().max()) <= 1e-5 * float(jac[:, k].abs().max())


def test_spd_solve_lanes_matches_linalg():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 6, 6))
    m = torch.from_numpy(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(6))
    b = torch.from_numpy(rng.normal(size=(5, 6, 2)))
    got = tpnp._cholesky_solve_lanes(tpnp._cholesky_lanes(m), b)
    np.testing.assert_allclose(got.numpy(), torch.linalg.solve(m, b).numpy(), rtol=1e-9, atol=1e-9)


def test_refine_pose_lm_batched_equals_single_calls():
    pts, xy, valid, cams, poses = _batch()
    q0, t0 = _perturbed(poses)
    w = valid.astype(np.float32)
    t = [torch.from_numpy(a) for a in (q0, t0, pts, xy, cams, w)]
    q_b, t_b = tpnp.refine_pose_lm(*t)
    assert q_b.shape == (3, 4) and t_b.shape == (3, 3)
    for i in range(3):
        q_s, t_s = tpnp.refine_pose_lm(*(a[i] for a in t))
        np.testing.assert_allclose(q_b[i].numpy(), q_s.numpy(), atol=1e-6)
        np.testing.assert_allclose(t_b[i].numpy(), t_s.numpy(), atol=1e-6)
        _close_pose(q_s.numpy(), t_s.numpy(), *poses[i], rot_deg=0.05, t_m=0.01)


def test_refine_pose_iterative_batched_equals_single_calls():
    pts, xy, valid, cams, poses = _batch(outliers=0.2, seed=30)
    q0, t0 = _perturbed(poses, scale=0.3)
    base = valid.copy()
    base[2, 5:] = False  # query 2 stops at once: 5 rows < 6
    t = [torch.from_numpy(a) for a in (q0, t0, pts, xy, cams, base)]
    q_b, t_b, n_b, nums_b = tpnp.refine_pose_iterative(*t, 4.0, iters=3)
    assert nums_b.shape == (3, 3) and n_b.dtype == torch.int32
    assert int(n_b[2]) == 0 and (nums_b[2] == -1).all()
    for i in range(3):
        q_s, t_s, n_s, nums_s = tpnp.refine_pose_iterative(*(a[i] for a in t), 4.0, iters=3)
        assert int(n_s) == int(n_b[i])
        assert torch.equal(nums_s, nums_b[i])
        np.testing.assert_allclose(q_b[i].numpy(), q_s.numpy(), atol=1e-6)
        np.testing.assert_allclose(t_b[i].numpy(), t_s.numpy(), atol=1e-6)


def test_pnp_ransac_core_batched_equals_single_calls():
    pts, xy, valid, cams, poses = _batch(outliers=0.3, seed=40)
    gens = [torch.Generator().manual_seed(fold_seed(5, i)) for i in range(3)]
    idx = sample_minimal_sets(torch.from_numpy(valid), 128, gens)
    assert idx.shape == (3, 128, 6)
    for i in range(3):  # query i's draws do not depend on the others
        again = sample_minimal_sets(torch.from_numpy(valid[i]), 128,
                                    torch.Generator().manual_seed(fold_seed(5, i)))
        assert torch.equal(again, idx[i]) and valid[i][again.numpy()].all()
    t = [torch.from_numpy(a) for a in (xy, pts, cams, valid)]
    res_b = pnp_ransac_core(*t, idx, threshold=4.0)
    assert res_b.inliers.shape == (3, N) and bool(res_b.success.all())
    for i in range(3):
        res_s = pnp_ransac_core(*(a[i] for a in t), idx[i], threshold=4.0)
        assert int(res_s.num_inliers) == int(res_b.num_inliers[i])
        assert torch.equal(res_s.inliers, res_b.inliers[i])
        np.testing.assert_allclose(res_b.qvec[i].numpy(), res_s.qvec.numpy(), atol=1e-5)
        np.testing.assert_allclose(res_b.tvec[i].numpy(), res_s.tvec.numpy(), atol=1e-5)
        _close_pose(res_s.qvec.numpy(), res_s.tvec.numpy(), *poses[i], rot_deg=0.1, t_m=0.02)
        assert not res_s.inliers[Q_N[i]:].any()  # padding rows are never inliers


def test_program_eager_run_equals_graphs_run_on_cpu():
    pts, xy, valid, cams, _ = _batch(seed=50)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    idx = sample_minimal_sets(torch.from_numpy(valid), 64, gens)
    t = [torch.from_numpy(a) for a in (xy, pts, cams, valid)]
    prog = pnp_ransac_program(*t, idx, 4.0)
    assert [c for c, _ in prog.segments] == [True, False, True, False, True]
    captures = profiling.counter("graphs.captures")
    with profiling.recording() as recs:
        assert torch.equal(graphs.run(prog), graphs.run_eager(prog))
    # Nothing is captured on the CPU; the two eager segments run as such.
    assert profiling.counter("graphs.captures") == captures
    assert [r.tags["captured"] for r in recs if r.name == "graphs.run"] == [0]
    assert sum(r.name == "graphs.eager" for r in recs) == 4


def _jax_hypotheses(valid, num_hypotheses, key):
    """The sample indices JAX's pnp_ransac draws from `key`."""
    fvalid = jnp.asarray(valid, jnp.float32)

    def one(k):
        g = jax.random.gumbel(k, (len(valid),)) + jnp.log(fvalid + 1e-30)
        return jax.lax.top_k(g, 6)[1]

    return np.asarray(jax.vmap(one)(jax.random.split(key, num_hypotheses)))


def test_batched_ransac_matches_jax_vmapped_program():
    pts, xy, valid, cams, poses = _batch(outliers=0.3, seed=60)
    base = jax.random.PRNGKey(11)
    out_j = np.asarray(jengine._packed_pnp_batch(128)(
        jnp.asarray(xy), jnp.asarray(pts), jnp.asarray(cams), jnp.asarray(valid),
        jnp.float32(4.0), base))
    idx = np.stack([_jax_hypotheses(valid[i], 128, jax.random.fold_in(base, i))
                    for i in range(3)])
    res = pnp_ransac_core(*(torch.from_numpy(a) for a in (xy, pts, cams, valid, idx)),
                          threshold=4.0)
    for i in range(3):
        assert int(res.num_inliers[i]) == int(out_j[i, 7]) > 0.5 * Q_N[i]
        assert bool(res.success[i]) and out_j[i, 8] == 1.0
        np.testing.assert_array_equal(res.inliers[i].numpy(), out_j[i, 9:] > 0.5)
        _close_pose(res.qvec[i].numpy(), res.tvec[i].numpy(), out_j[i, :4], out_j[i, 4:7])


def test_batched_refinement_matches_jax_vmapped_program():
    pts, xy, valid, cams, poses = _batch(outliers=0.2, seed=70)
    q0, t0 = _perturbed(poses, scale=0.3)
    args = (q0, t0, pts, xy, cams, valid)
    out_j = np.asarray(jengine._packed_refine_batch(3)(*(jnp.asarray(a) for a in args),
                                                       jnp.float32(4.0)))
    q_t, t_t, n_t, nums_t = tpnp.refine_pose_iterative(*(torch.from_numpy(a) for a in args),
                                                       4.0, iters=3)
    np.testing.assert_array_equal(nums_t.numpy(), out_j[:, 8:].astype(np.int32))
    np.testing.assert_array_equal(n_t.numpy(), out_j[:, 7].astype(np.int32))
    assert (n_t.numpy() > 50).all()
    for i in range(3):
        _close_pose(q_t[i].numpy(), t_t[i].numpy(), out_j[i, :4], out_j[i, 4:7])
