"""Perspective-n-Point solvers and nonlinear pose refinement (PyTorch).

Port of ``sfd2_tpu/localization/pnp.py``: normalised DLT on ≥6
correspondences (SVD, cheirality-corrected) for least-squares fits, the
direct minimal solver over a leading hypothesis axis for RANSAC
(``pnp_dlt_fast_lanes``), and masked Levenberg–Marquardt refinement over
an axis-angle + translation update. The fixed-count loops that were
``lax.scan`` are Python loops over tensors with no host synchronisation
inside; the Jacobian comes from ``torch.func.jacfwd``. The DLT null vector
may differ in sign from the JAX package's, which the cheirality flip
makes irrelevant to the pose.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd

from sfd2_torch.geometry.cameras import _distort, project_points
from sfd2_torch.geometry.rotations import qvec_to_rotmat, rotmat_to_qvec

_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)


def _axis_angle_to_rotmat(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues [..., 3] → [..., 3, 3] with Taylor-guarded coefficients
    (differentiable at w = 0, the LM linearisation point)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    km = torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(km.shape)
    return eye + a * km + b * (km @ km)


def _hartley_normalize(points3d, points2d_norm, w):
    """Weighted Hartley normalisation; returns (x3, x2, s3, c3, s2, c2)."""
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    c3 = torch.sum(points3d * w[:, None], dim=0) / wsum
    x3 = points3d - c3
    s3 = _SQRT3 / torch.clamp(torch.sum(torch.linalg.norm(x3, dim=1) * w) / wsum, min=1e-12)
    x3 = x3 * s3
    c2 = torch.sum(points2d_norm * w[:, None], dim=0) / wsum
    x2 = points2d_norm - c2
    s2 = _SQRT2 / torch.clamp(torch.sum(torch.linalg.norm(x2, dim=1) * w) / wsum, min=1e-12)
    x2 = x2 * s2
    return x3, x2, s3, c3, s2, c2


def _dlt_rows(x3, x2, w=None):
    """The 2N×12 DLT system [..., 2N, 12] from normalised correspondences."""
    xh = torch.cat([x3, torch.ones_like(x3[..., :1])], dim=-1)  # [..., N, 4]
    u, v = x2[..., 0:1], x2[..., 1:2]
    zeros = torch.zeros_like(xh)
    row_u = torch.cat([xh, zeros, -u * xh], dim=-1)
    row_v = torch.cat([zeros, xh, -v * xh], dim=-1)
    if w is not None:
        row_u, row_v = row_u * w[..., :, None], row_v * w[..., :, None]
    return torch.cat([row_u, row_v], dim=-2)


def _det3(m):
    return torch.sum(m[..., 0, :] * torch.linalg.cross(m[..., 1, :], m[..., 2, :]), dim=-1)


def _denorm(s3, c3, s2, c2):
    """Batched T2⁻¹ [..., 3, 3] and T3 [..., 4, 4] of the Hartley transforms."""
    one, zero = torch.ones_like(s2), torch.zeros_like(s2)
    t2_inv = torch.stack([
        torch.stack([1 / s2, zero, c2[..., 0]], -1),
        torch.stack([zero, 1 / s2, c2[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    t3 = torch.stack([
        torch.stack([s3, zero, zero, -s3 * c3[..., 0]], -1),
        torch.stack([zero, s3, zero, -s3 * c3[..., 1]], -1),
        torch.stack([zero, zero, s3, -s3 * c3[..., 2]], -1),
        torch.stack([zero, zero, zero, one], -1),
    ], -2)
    return t2_inv, t3


def pnp_dlt(points3d: torch.Tensor, points2d_norm: torch.Tensor,
            weights: torch.Tensor | None = None):
    """DLT PnP on normalised image coordinates.

    points3d [N, 3], points2d_norm [N, 2], weights [N] (0 disables a row).
    Returns (qvec [4], tvec [3]); needs ≥6 effective correspondences (with
    fewer the result is finite garbage; callers gate on inlier counts)."""
    n = points3d.shape[0]
    w = torch.ones(n, dtype=points3d.dtype, device=points3d.device) if weights is None else weights
    x3, x2, s3, c3, s2, c2 = _hartley_normalize(points3d, points2d_norm, w)
    # SVD of A rather than eigh of AᵀA: squaring the condition number is
    # fatal in float32 for near-degenerate samples.
    _, _, vt = torch.linalg.svd(_dlt_rows(x3, x2, w), full_matrices=False)
    p_norm = vt[-1].reshape(3, 4)
    t2_inv, t3 = _denorm(s3, c3, s2, c2)
    p = t2_inv @ p_norm @ t3
    p = torch.where(torch.linalg.det(p[:, :3]) < 0, -p, p)
    uu, ss, vt = torch.linalg.svd(p[:, :3])
    t = p[:, 3] / torch.clamp(torch.mean(ss), min=1e-12)
    return rotmat_to_qvec(uu @ vt), t


def _polar_rotation_lanes(m: torch.Tensor, iters: int = 5):
    """Nearest rotation to each m [H, 3, 3] by Newton polar iteration
    X ← ½(X + X⁻ᵀ) with cofactor inverses; returns (R, mean singular value)."""

    def cof3(x):
        return torch.stack([
            torch.linalg.cross(x[:, 1], x[:, 2]),
            torch.linalg.cross(x[:, 2], x[:, 0]),
            torch.linalg.cross(x[:, 0], x[:, 1]),
        ], dim=1)

    fro = torch.sqrt(torch.sum(m * m, dim=(-2, -1), keepdim=True))
    x = m * (_SQRT3 / torch.clamp(fro, min=1e-12))
    for _ in range(iters):
        det = _det3(x)
        det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        x = 0.5 * (x + cof3(x) / det[:, None, None])
    return x, torch.sum(x * m, dim=(-2, -1)) / 3.0


def pnp_dlt_fast_lanes(points3d: torch.Tensor, points2d_norm: torch.Tensor):
    """Minimal-sample DLT over hypothesis lanes: [H, 6, 3] + [H, 6, 2] →
    (qvec [H, 4], tvec [H, 3]); non-finite where a sample is degenerate.

    The algorithm of the JAX package's lanes solver: AᵀA with a 1e-6
    relative diagonal shift, Cholesky, 2-column inverse subspace
    iteration (4 rounds, Gram–Schmidt), closed-form 2×2 Rayleigh–Ritz,
    denormalisation and a polar rotation. The JAX version unrolls the
    12×12 linear algebra into scalar lanes for the TPU; here it is batched
    ``torch.linalg`` (no host synchronisation)."""
    h = points3d.shape[0]
    dt, dev = points3d.dtype, points3d.device

    c3 = torch.mean(points3d, dim=1)
    x3 = points3d - c3[:, None, :]
    s3 = _SQRT3 / torch.clamp(torch.mean(torch.linalg.norm(x3, dim=-1), dim=1), min=1e-12)
    x3 = x3 * s3[:, None, None]
    c2 = torch.mean(points2d_norm, dim=1)
    x2 = points2d_norm - c2[:, None, :]
    s2 = _SQRT2 / torch.clamp(torch.mean(torch.linalg.norm(x2, dim=-1), dim=1), min=1e-12)
    x2 = x2 * s2[:, None, None]

    a = _dlt_rows(x3, x2)  # [H, 12, 12]
    m = a.transpose(1, 2) @ a
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(12, dtype=dt, device=dev)
    m = m + (1e-6 * (trace / 12.0) + 1e-30)[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(m)

    x = torch.stack([
        torch.full((12,), 1.0 / math.sqrt(12.0), dtype=dt, device=dev),
        torch.tensor([1.0, -1.0] * 6, dtype=dt, device=dev) / math.sqrt(12.0),
    ], dim=1).expand(h, 12, 2)
    for _ in range(4):
        y = torch.linalg.solve_triangular(chol, x, upper=False)
        x = torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True)
        c0 = x[..., 0] / torch.clamp(torch.linalg.norm(x[..., 0], dim=-1, keepdim=True), min=1e-30)
        c1 = x[..., 1] - torch.sum(c0 * x[..., 1], dim=-1, keepdim=True) * c0
        c1 = c1 / torch.clamp(torch.linalg.norm(c1, dim=-1, keepdim=True), min=1e-30)
        x = torch.stack([c0, c1], dim=-1)

    c0, c1 = x[..., 0], x[..., 1]
    mx = m @ x
    baa = torch.sum(c0 * mx[..., 0], -1)
    bab = torch.sum(c0 * mx[..., 1], -1)
    bcc = torch.sum(c1 * mx[..., 1], -1)
    lam = 0.5 * (baa + bcc) - torch.sqrt(torch.square(0.5 * (baa - bcc)) + torch.square(bab))
    use_a = torch.abs(lam - baa) > torch.abs(lam - bcc)
    v0 = torch.where(use_a, bab, lam - bcc)
    v1 = torch.where(use_a, lam - baa, bab)
    tiny = torch.sqrt(v0 * v0 + v1 * v1) < 1e-20
    first = (baa <= bcc).to(dt)
    v0 = torch.where(tiny, first, v0)
    v1 = torch.where(tiny, 1.0 - first, v1)
    vn = torch.sqrt(v0 * v0 + v1 * v1)
    sol = c0 * (v0 / vn)[:, None] + c1 * (v1 / vn)[:, None]
    sol = sol / torch.clamp(torch.linalg.norm(sol, dim=-1, keepdim=True), min=1e-30)

    t2_inv, t3 = _denorm(s3, c3, s2, c2)
    p = t2_inv @ sol.reshape(h, 3, 4) @ t3
    p = torch.where((_det3(p[:, :, :3]) < 0)[:, None, None], -p, p)
    rot, scale = _polar_rotation_lanes(p[:, :, :3])
    t = p[:, :, 3] / torch.clamp(scale, min=1e-12)[:, None]
    q = rotmat_to_qvec(rot)
    bad = (info != 0)[:, None]  # indefinite sample: the unrolled form gives NaN
    return torch.where(bad, float("nan"), q), torch.where(bad, float("nan"), t)


def refine_pose_lm(qvec, tvec, points3d, points2d, cam_params, weights,
                   iterations: int = 10, init_lambda: float = 1e-3):
    """Levenberg–Marquardt pose-only refinement of pixel reprojection error
    (``pycolmap.pose_refinement`` parity). Rows with weight 0 contribute
    nothing. Returns (qvec, tvec)."""
    rot0 = qvec_to_rotmat(qvec)
    dt, dev = qvec.dtype, qvec.device

    def residuals(delta):
        rot = _axis_angle_to_rotmat(delta[:3]) @ rot0
        pc = points3d @ rot.T + (tvec + delta[3:])
        z = pc[:, 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        xd, yd = _distort(pc[:, 0] * inv_z, pc[:, 1] * inv_z, cam_params)
        proj = torch.stack([cam_params[0] * xd + cam_params[2],
                            cam_params[1] * yd + cam_params[3]], dim=-1)
        return ((proj - points2d) * weights[:, None]).reshape(-1)

    eye = torch.eye(6, dtype=dt, device=dev)
    delta = torch.zeros(6, dtype=dt, device=dev)
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    best_cost = torch.sum(residuals(delta) ** 2)
    jac_fn = jacfwd(residuals)
    for _ in range(iterations):
        r = residuals(delta)
        jac = jac_fn(delta)  # [2N, 6]
        jtj = jac.T @ jac
        damped = jtj + lam * torch.diag(torch.diagonal(jtj)) + 1e-9 * eye
        upd = torch.linalg.solve_ex(damped, (jac.T @ r)[:, None])[0][:, 0]
        cand = delta - upd
        new_cost = torch.sum(residuals(cand) ** 2)
        improved = new_cost < best_cost
        delta = torch.where(improved, cand, delta)
        lam = torch.where(improved, lam * 0.3, lam * 4.0)
        best_cost = torch.minimum(best_cost, new_cost)
    rot = _axis_angle_to_rotmat(delta[:3]) @ rot0
    return rotmat_to_qvec(rot), tvec + delta[3:]


def refine_pose_iterative(qvec, tvec, points3d, points2d, cam_params, base_mask,
                          opt_thresh: float, iters: int = 5, lm_iterations: int = 10):
    """Covisibility-refinement inner loop: per iteration reproject,
    re-select inliers (err ≤ opt_thresh AND base_mask), stop for good when
    support < 6, else LM-refine on the selection (the reference's host loop
    ``it_loc/localize_cv2.py:341-370``). Returns (qvec, tvec, num — support
    of the last executed iteration (0 if none ran), nums [iters] — per
    iteration support, −1 where it did not run)."""
    q, t = qvec, tvec
    stopped = torch.zeros((), dtype=torch.bool, device=qvec.device)
    num = torch.zeros((), dtype=torch.int32, device=qvec.device)
    nums = []
    for _ in range(iters):
        proj, _ = project_points(points3d, q, t, cam_params)
        err = torch.linalg.norm(points2d - proj, dim=1)
        mask = (err <= opt_thresh) & base_mask
        n = mask.sum().to(torch.int32)
        run = (~stopped) & (n >= 6)
        q_new, t_new = refine_pose_lm(q, t, points3d, points2d, cam_params,
                                      mask.to(points3d.dtype), iterations=lm_iterations)
        q = torch.where(run, q_new, q)
        t = torch.where(run, t_new, t)
        num = torch.where(run, n, num)
        stopped = stopped | ~run
        nums.append(torch.where(run, n, -1))
    return q, t, num, torch.stack(nums)
