"""Fixed-pose multi-view triangulation (batched DLT + filtering).

Port of ``sfd2_tpu/sfm/triangulation.py`` (parity with COLMAP's
``point_triangulator`` with bundle refinements off,
``hloc/triangulation.py:129-147``): triangulate every feature track
against known camera poses, refine the points by Gauss–Newton, then
filter by reprojection error (4 px), cheirality and the minimum
triangulation angle (1.5°), COLMAP's defaults.

Tracks are padded to a fixed length T with observation masks, and all P
tracks of a call solve at once: the weighted DLT is the null vector of
each track's 4×4 Gram matrix (the JAX package's lanes algorithm, with
batched ``torch.linalg`` in place of scalar-unrolled lanes, see
``twoview._smallest_eigvec_spd``), and Gauss–Newton uses analytic 2×3
Jacobians and closed-form 3×3 inverses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfd2_torch.geometry.cameras import project_points, unproject_normalized
from sfd2_torch.geometry.rotations import qvec_to_rotmat
from sfd2_torch.sfm.twoview import _shifted_gram, _smallest_eigvec_spd


class TriangulationResult(NamedTuple):
    xyz: torch.Tensor  # [P, 3]
    valid: torch.Tensor  # [P] bool — survived all filters
    errors: torch.Tensor  # [P] mean reproj error over inlier observations
    obs_inlier: torch.Tensor  # [P, T] per-observation inlier flags
    tri_angle_deg: torch.Tensor  # [P] max pairwise triangulation angle


def _inv3_lanes(m):
    """Closed-form inverse of [..., 3, 3] via the adjugate."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1)[..., None, None]
    return torch.stack([c0, c1, c2], dim=-1) / det


def _triangulate_dlt_lanes(norm_xy, rots, tvecs, w):
    """Weighted linear triangulation of all P tracks at once: rows
    x·(P3) − P1 and y·(P3) − P2 per observation, solved as the null vector
    of the 4×4 Gram matrix. norm_xy [P, T, 2] normalised observations,
    rots [P, T, 3, 3], tvecs [P, T, 3], w [P, T] → xyz [P, 3].

    Translations are rescaled per track by their mean magnitude τ so the
    Gram entries are O(1) in float32; the solution is scaled back by τ."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    tau = torch.clamp(torch.sum(torch.linalg.norm(tvecs, dim=-1) * w, dim=-1) / wsum, min=1e-6)
    ts = tvecs / tau[:, None, None]
    x, y = norm_xy[..., 0:1], norm_xy[..., 1:2]
    row_x = torch.cat([x * rots[..., 2, :] - rots[..., 0, :], x * ts[..., 2:3] - ts[..., 0:1]], -1)
    row_y = torch.cat([y * rots[..., 2, :] - rots[..., 1, :], y * ts[..., 2:3] - ts[..., 1:2]], -1)
    rows = torch.cat([row_x, row_y], dim=-2) * torch.cat([w, w], dim=-1)[..., None]  # [P, 2T, 4]
    h = _smallest_eigvec_spd(_shifted_gram(rows))
    h3 = h[:, 3:]
    h3 = torch.where(torch.abs(h3) < 1e-12, torch.where(h3 < 0, -1e-12, 1e-12), h3)
    return h[:, :3] / h3 * tau[:, None]


def _refine_points_gn_lanes(xyz, norm_xy, rots, tvecs, w, iters: int = 3):
    """Gauss–Newton on all P 3D points at once (normalised-coordinate
    residuals, analytic 2×3 Jacobians, adjugate 3×3 solves)."""
    p = xyz
    eye3 = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        pc = torch.einsum("ptij,pj->pti", rots, p) + tvecs
        z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        proj = pc[..., :2] / z[..., None]
        r = (proj - norm_xy) * w[..., None]  # [P, T, 2]
        # ∂proj/∂p = (R[:2] − proj ⊗ R[2]) / z, scaled by w.
        jac = ((rots[..., :2, :] - proj[..., None] * rots[..., 2:3, :])
               / z[..., None, None] * w[..., None, None])  # [P, T, 2, 3]
        jtj = torch.einsum("ptci,ptcj->pij", jac, jac) + 1e-8 * eye3
        g = torch.einsum("ptci,ptc->pi", jac, r)
        p_new = p - torch.einsum("pij,pj->pi", _inv3_lanes(jtj), g)
        p = torch.where(torch.isfinite(p_new).all(-1, keepdim=True), p_new, p)
    return p


def triangulate_tracks(obs_xy, obs_mask, qvecs, tvecs, cam_params,
                       max_reproj_error: float = 4.0, min_tri_angle_deg: float = 1.5,
                       refine_iters: int = 3) -> TriangulationResult:
    """Triangulate P padded tracks at once: obs_xy [P, T, 2] pixels,
    obs_mask [P, T] bool, qvecs [P, T, 4] / tvecs [P, T, 3] the pose of each
    observation's camera, cam_params [P, T, 8] canonical intrinsics."""
    t_cnt = obs_mask.shape[1]
    w = obs_mask.to(obs_xy.dtype)
    rots = qvec_to_rotmat(qvecs)  # [P, T, 3, 3]
    norm_xy = unproject_normalized(obs_xy, cam_params)

    xyz = _triangulate_dlt_lanes(norm_xy, rots, tvecs, w)
    xyz = _refine_points_gn_lanes(xyz, norm_xy, rots, tvecs, w, refine_iters)

    # Reprojection + cheirality per observation.
    proj, depth = project_points(xyz[:, None, None, :].expand(-1, t_cnt, 1, 3), qvecs, tvecs,
                                 cam_params)
    err = torch.linalg.norm(proj[:, :, 0] - obs_xy, dim=-1)
    obs_ok = obs_mask & (err <= max_reproj_error) & (depth[:, :, 0] > 0)

    # Triangulation angle: max pairwise angle between viewing rays.
    centers = -torch.einsum("ptji,ptj->pti", rots, tvecs)  # [P, T, 3]
    rays = xyz[:, None, :] - centers
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("pti,psi->pts", rays, rays)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    cosang = torch.where(pair_ok, torch.clamp(cosang, -1.0, 1.0), 1.0)
    max_angle = torch.arccos(torch.amin(cosang, dim=(1, 2))) * (180.0 / math.pi)

    n_inl = obs_ok.sum(1)
    mean_err = torch.sum(torch.where(obs_ok, err, 0.0), dim=1) / torch.clamp(n_inl, min=1)
    valid = (n_inl >= 2) & (max_angle >= min_tri_angle_deg) & torch.isfinite(xyz).all(1)
    return TriangulationResult(xyz=xyz, valid=valid, errors=mean_err, obs_inlier=obs_ok,
                               tri_angle_deg=max_angle)
