"""sfd2_torch geometry against the JAX package on the same numpy inputs.

Rotations, projection with distortion, fixed-point undistortion,
reprojection errors and the numpy pose helpers. All arithmetic is float32
in both packages; the tolerances (1e-5 absolute on unit-scale values,
1e-3 px on pixel coordinates of ~500 px) cover float32 rounding in a
different evaluation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.geometry import cameras as tc
from sfd2_torch.geometry import np_pose as tp
from sfd2_torch.geometry import rotations as tr
from sfd2_tpu.geometry import cameras as jc
from sfd2_tpu.geometry import np_pose as jp
from sfd2_tpu.geometry import rotations as jr

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _pose_scene(rng, n=64):
    """Points in front of a slightly rotated camera, OPENCV intrinsics."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    q = np.array([1.0, 0.03, -0.02, 0.01], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    cam = np.array([520.0, 515.0, 320.0, 240.0, -0.08, 0.01, 1e-3, -5e-4], np.float32)
    return pts, q, t, cam


def test_qvec_rotmat_roundtrip_matches_jax(rng):
    q = _quats(rng, 32)
    q[0] = [0.0, 1.0, 0.0, 0.0]  # w = 0: exercises the non-w Shepperd branches
    q[1] = [0.0, 0.0, 0.0, 1.0]
    r_t = tr.qvec_to_rotmat(_t(q)).numpy()
    r_j = np.asarray(jr.qvec_to_rotmat(_j(q)))
    np.testing.assert_allclose(r_t, r_j, atol=1e-6)
    q_t = tr.rotmat_to_qvec(_t(r_j)).numpy()
    q_j = np.asarray(jr.rotmat_to_qvec(_j(r_j)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-5)
    # Round trip up to the quaternion sign.
    np.testing.assert_allclose(np.abs(np.sum(q_t * q, axis=1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["quat_multiply", "quat_angular_error_deg"])
def test_quaternion_binary_ops_match_jax(rng, name):
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    got = getattr(tr, name)(_t(q1), _t(q2)).numpy()
    ref = np.asarray(getattr(jr, name)(_j(q1), _j(q2)))
    # The angle goes through arccos, whose slope near |<q1,q2>| = 1 turns
    # 1e-7 of rounding into ~1e-3 degrees.
    np.testing.assert_allclose(got, ref, atol=2e-3 if "error" in name else 1e-6)


def test_quat_conjugate_and_rotate_points_match_jax(rng):
    q = _quats(rng, 4)
    pts = rng.normal(size=(4, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(tr.quat_conjugate(_t(q)).numpy(),
                               np.asarray(jr.quat_conjugate(_j(q))), atol=0)
    np.testing.assert_allclose(tr.rotate_points(_t(q), _t(pts)).numpy(),
                               np.asarray(jr.rotate_points(_j(q), _j(pts))), atol=1e-5)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_PINHOLE", [500.0, 320.0, 240.0]),
    ("PINHOLE", [500.0, 510.0, 320.0, 240.0]),
    ("SIMPLE_RADIAL", [500.0, 320.0, 240.0, 0.01]),
    ("RADIAL", [500.0, 320.0, 240.0, 0.01, -0.002]),
    ("OPENCV", [500.0, 510.0, 320.0, 240.0, 0.01, -0.002, 1e-3, 2e-4]),
])
def test_canonicalize_params_matches_jax(model, params):
    np.testing.assert_array_equal(tc.canonicalize_params(model, params),
                                  jc.canonicalize_params(model, params))


def test_project_points_with_distortion_matches_jax(rng):
    pts, q, t, cam = _pose_scene(rng)
    xy_t, z_t = tc.project_points(_t(pts), _t(q), _t(t), _t(cam))
    xy_j, z_j = jc.project_points(_j(pts), _j(q), _j(t), _j(cam))
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), atol=1e-3)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)


def test_unproject_normalized_matches_jax_and_inverts_projection(rng):
    pts, q, t, cam = _pose_scene(rng)
    xy = np.asarray(jc.project_points(_j(pts), _j(q), _j(t), _j(cam))[0])
    un_t = tc.unproject_normalized(_t(xy), _t(cam)).numpy()
    un_j = np.asarray(jc.unproject_normalized(_j(xy), _j(cam)))
    np.testing.assert_allclose(un_t, un_j, atol=1e-6)
    # Five fixed-point rounds undistort to ~1e-4 of a normalised unit at
    # k1 = -0.08 (the JAX package's fixed iteration count).
    pc = pts @ np.asarray(jr.qvec_to_rotmat(_j(q))).T + t
    np.testing.assert_allclose(un_t, pc[:, :2] / pc[:, 2:], atol=1e-4)


def test_reprojection_errors_match_jax(rng):
    pts, q, t, cam = _pose_scene(rng)
    obs = rng.normal(size=(len(pts), 2)).astype(np.float32) * 3 + 320
    e_t, d_t = tc.reprojection_errors(_t(pts), _t(obs), _t(q), _t(t), _t(cam))
    e_j, d_j = jc.reprojection_errors(_j(pts), _j(obs), _j(q), _j(t), _j(cam))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-3)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_np_pose_helpers_match_jax_package(rng):
    for _ in range(5):
        q1, q2 = rng.normal(size=4), rng.normal(size=4)
        t1, t2 = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_array_equal(tp.qvec_to_rotmat(q1), jp.qvec_to_rotmat(q1))
        np.testing.assert_array_equal(tp.camera_center(q1, t1), jp.camera_center(q1, t1))
        assert tp.pose_error(q1, t1, q2, t2) == jp.pose_error(q1, t1, q2, t2)
