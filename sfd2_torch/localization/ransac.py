"""Batched LO-RANSAC PnP (hypotheses as a batch dimension).

Port of ``sfd2_tpu/localization/ransac.py`` (``pycolmap.
absolute_pose_estimation`` parity): H minimal sets are solved at once
(``pnp_dlt_fast_lanes``), all H×N reprojection errors are scored in one
pass, the best hypothesis wins, and local optimisation (least-squares DLT
on its inliers, then masked LM) recovers a sequential LO-RANSAC's
accuracy. Sampling is split from the core: ``sample_minimal_sets`` draws
Gumbel-top-k sets ∝ validity from a ``torch.Generator`` (where the JAX
package used ``jax.random``), and ``pnp_ransac_core`` takes any
``sample_idx [H, 6]``, so both packages can be fed the same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfd2_torch.geometry.cameras import project_points, unproject_normalized
from sfd2_torch.localization.pnp import pnp_dlt, pnp_dlt_fast_lanes, refine_pose_lm

_MIN_SAMPLE = 6  # DLT minimal set


class PnPResult(NamedTuple):
    qvec: torch.Tensor  # [4]
    tvec: torch.Tensor  # [3]
    num_inliers: torch.Tensor  # [] int32
    inliers: torch.Tensor  # [N] bool
    success: torch.Tensor  # [] bool


def _inlier_mask(qvec, tvec, points3d, points2d, cam_params, threshold, valid):
    proj, depth = project_points(points3d, qvec, tvec, cam_params)
    err = torch.linalg.norm(proj - points2d, dim=-1)
    return (err <= threshold) & (depth > 0) & valid


def _finite(*ts):
    return torch.stack([torch.isfinite(t).all() for t in ts]).all()


def sample_minimal_sets(valid: torch.Tensor, num_hypotheses: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """[H, 6] minimal-set indices drawn without replacement ∝ `valid`
    (Gumbel top-k over the mask)."""
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(u)) + torch.log(valid.float() + 1e-30)
    return torch.topk(g, _MIN_SAMPLE, dim=-1).indices


def pnp_ransac_core(points2d, points3d, cam_params, valid, sample_idx,
                    threshold: float = 12.0, lo_iterations: int = 2,
                    min_inliers: int = 6) -> PnPResult:
    """RANSAC on given hypotheses: points2d [N, 2] pixels, points3d [N, 3],
    cam_params [8] canonical intrinsics, valid [N] bool, sample_idx [H, 6]."""
    pts_norm = unproject_normalized(points2d, cam_params)
    h_q, h_t = pnp_dlt_fast_lanes(points3d[sample_idx], pts_norm[sample_idx])

    counts = _inlier_mask(h_q, h_t, points3d[None], points2d[None], cam_params,
                          threshold, valid[None]).sum(-1)
    finite = torch.isfinite(h_q).all(-1) & torch.isfinite(h_t).all(-1)
    best = torch.argmax(torch.where(finite, counts, 0))
    q, t = h_q[best], h_t[best]

    for _ in range(lo_iterations):
        inl = _inlier_mask(q, t, points3d, points2d, cam_params, threshold, valid)
        w = inl.to(points2d.dtype)
        enough = torch.sum(w) >= _MIN_SAMPLE
        q_ls, t_ls = pnp_dlt(points3d, pts_norm, weights=w)
        cnt_ls = _inlier_mask(q_ls, t_ls, points3d, points2d, cam_params, threshold, valid).sum()
        take_ls = enough & _finite(q_ls, t_ls) & (cnt_ls >= inl.sum())
        q = torch.where(take_ls, q_ls, q)
        t = torch.where(take_ls, t_ls, t)
        inl = _inlier_mask(q, t, points3d, points2d, cam_params, threshold, valid)
        q_lm, t_lm = refine_pose_lm(q, t, points3d, points2d, cam_params, inl.to(points2d.dtype))
        cnt_lm = _inlier_mask(q_lm, t_lm, points3d, points2d, cam_params, threshold, valid).sum()
        take_lm = _finite(q_lm, t_lm) & (cnt_lm >= inl.sum())
        q = torch.where(take_lm, q_lm, q)
        t = torch.where(take_lm, t_lm, t)

    inliers = _inlier_mask(q, t, points3d, points2d, cam_params, threshold, valid)
    num = inliers.sum().to(torch.int32)
    success = (num >= min_inliers) & _finite(q, t)
    return PnPResult(qvec=q, tvec=t, num_inliers=num, inliers=inliers, success=success)


def pnp_ransac(points2d, points3d, cam_params, valid, threshold: float = 12.0,
               generator: torch.Generator | None = None, num_hypotheses: int = 1024,
               lo_iterations: int = 2, min_inliers: int = 6) -> PnPResult:
    """Estimate a world→cam pose from padded 2D-3D matches (`threshold` is
    the inlier reprojection threshold in pixels)."""
    if generator is None:
        generator = torch.Generator(device=points2d.device).manual_seed(0)
    sample_idx = sample_minimal_sets(valid, num_hypotheses, generator)
    return pnp_ransac_core(points2d, points3d, cam_params, valid, sample_idx,
                           threshold, lo_iterations, min_inliers)
