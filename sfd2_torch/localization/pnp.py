"""Perspective-n-Point solvers and nonlinear pose refinement (PyTorch).

Port of ``sfd2_tpu/localization/pnp.py``: normalised DLT on ≥6
correspondences (SVD, cheirality-corrected) for least-squares fits, the
direct minimal solver over a leading hypothesis axis for RANSAC
(``pnp_dlt_fast_lanes``; ``pnp_dlt_fast`` for one sample), and masked
Levenberg–Marquardt refinement over an axis-angle + translation update.
The DLT null vector may differ in sign from the JAX package's, which the
cheirality flip makes irrelevant to the pose.

Every solver takes an optional leading query axis (Q), the port's form of
the JAX engine's ``vmap`` over queries (``sfd2_tpu/localization/engine.py:
93-134``); unbatched arguments are the Q = 1 case. The fixed-count loops
that were ``lax.scan`` are Python loops over tensors with no host
synchronisation inside. LM's 2×6 Jacobian is analytic, taken at the
current update δ as the JAX LM re-linearises there (``jax.jacfwd`` at δ),
and its damped 6×6 system is solved by a Cholesky written in elementwise
tensor ops. So LM and the refinement loop launch the same kernels on
every call and never wait for the host: on CUDA tensors
``refine_pose_lm`` and ``refine_pose_iterative`` run from CUDA graphs
captured once per shape (``localization/graphs.py``); on CPU tensors the
same functions run eagerly.
"""

from __future__ import annotations

import math

import torch

from sfd2_torch.geometry.cameras import _distort, project_points
from sfd2_torch.geometry.rotations import qvec_to_rotmat, rotmat_to_qvec
from sfd2_torch.localization import graphs

_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)


def _so3_terms(w: torch.Tensor):
    """[w]× [..., 3, 3], its square, θ² [..., 1, 1], the Taylor-guard mask
    and the guarded θ², and the coefficients a = sin θ/θ, b = (1−cos θ)/θ²
    (Taylor series below θ² = 1e-8, so the terms are smooth at w = 0)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    km = torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    return km, km @ km, theta2, small, safe, a, b


def _axis_angle_to_rotmat(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues [..., 3] → [..., 3, 3] with Taylor-guarded coefficients
    (differentiable at w = 0, the LM linearisation point)."""
    km, km2, _, _, _, a, b = _so3_terms(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(km.shape)
    return eye + a * km + b * km2


def _so3_exp_and_left_jacobian(w: torch.Tensor):
    """exp([w]×) and the left Jacobian of SO(3), J_l(w) = I + b [w]× +
    c [w]×² with c = (1 − a)/θ² (Taylor 1/6 − θ²/120 below θ² = 1e-8):
    exp([w + dw]×) ≈ exp([J_l(w) dw]×) exp([w]×)."""
    km, km2, theta2, small, safe, a, b = _so3_terms(w)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(km.shape)
    return eye + a * km + b * km2, eye + b * km + c * km2


def _cholesky_lanes(m: torch.Tensor, min_pivot: float | None = None) -> torch.Tensor:
    """Lower Cholesky factor of SPD [..., n, n] in elementwise tensor ops
    (no LAPACK call, no host synchronisation: a CUDA-graph capture takes it
    as it is). ``min_pivot`` clamps the pivots, so a near-singular float32
    matrix gives huge but finite factors; without it an indefinite matrix
    gives NaN, as the JAX package's unrolled Cholesky does."""
    n = m.shape[-1]
    lower = torch.zeros_like(m)
    for j in range(n):
        d = m[..., j, j] - torch.sum(lower[..., j, :j] ** 2, dim=-1)
        if min_pivot is not None:
            d = torch.clamp(d, min=min_pivot)
        ljj = torch.sqrt(d)
        col = (m[..., j + 1:, j] - torch.sum(lower[..., j + 1:, :j] * lower[..., j:j + 1, :j],
                                             dim=-1)) / ljj[..., None]
        lower[..., j, j] = ljj
        lower[..., j + 1:, j] = col
    return lower


def _cholesky_solve_lanes(lower: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L Lᵀ x = b for b [..., n, k], by forward then back
    substitution one row at a time, in elementwise tensor ops."""
    n = lower.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        acc = torch.sum(lower[..., i, :i, None] * y[..., :i, :], dim=-2)
        y[..., i, :] = (b[..., i, :] - acc) / lower[..., i, i:i + 1]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        acc = torch.sum(lower[..., i + 1:, i, None] * x[..., i + 1:, :], dim=-2)
        x[..., i, :] = (y[..., i, :] - acc) / lower[..., i, i:i + 1]
    return x


def _inv6_spd_lanes(m):
    """Inverse of SPD [..., 6, 6] by Cholesky with clamped pivots, so a
    near-singular float32 block gives a huge but finite inverse instead of
    a NaN that would poison every camera through the PCG dot products
    (bundle adjustment's block-Jacobi preconditioner)."""
    n = m.shape[-1]
    lower = _cholesky_lanes(m, min_pivot=1e-20)
    # L⁻¹ by forward substitution, one row at a time, then M⁻¹ = L⁻ᵀ·L⁻¹:
    # elementwise kernels only, which a CUDA-graph capture takes as they are.
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    inv_l = torch.zeros_like(m)
    for i in range(n):
        acc = torch.sum(lower[..., i, :i, None] * inv_l[..., :i, :], dim=-2)
        inv_l[..., i, :] = (eye[i] - acc) / lower[..., i, i:i + 1]
    return inv_l.transpose(-1, -2) @ inv_l


def _hartley_normalize(points3d, points2d_norm, w):
    """Weighted Hartley normalisation over the row axis of [..., N, ·];
    returns (x3, x2, s3 [...], c3 [..., 3], s2 [...], c2 [..., 2])."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    c3 = torch.sum(points3d * w[..., None], dim=-2) / wsum[..., None]
    x3 = points3d - c3[..., None, :]
    s3 = _SQRT3 / torch.clamp(torch.sum(torch.linalg.norm(x3, dim=-1) * w, dim=-1) / wsum,
                              min=1e-12)
    x3 = x3 * s3[..., None, None]
    c2 = torch.sum(points2d_norm * w[..., None], dim=-2) / wsum[..., None]
    x2 = points2d_norm - c2[..., None, :]
    s2 = _SQRT2 / torch.clamp(torch.sum(torch.linalg.norm(x2, dim=-1) * w, dim=-1) / wsum,
                              min=1e-12)
    x2 = x2 * s2[..., None, None]
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


def dlt_system(points3d, points2d_norm, weights):
    """The weighted, Hartley-normalised DLT system of [..., N, ·]
    correspondences: (rows [..., 2N, 12], s3, c3, s2, c2). Elementwise and
    matrix products only: a CUDA graph captures it."""
    x3, x2, s3, c3, s2, c2 = _hartley_normalize(points3d, points2d_norm, weights)
    return _dlt_rows(x3, x2, weights), s3, c3, s2, c2


def dlt_pose(rows, s3, c3, s2, c2):
    """(R [..., 3, 3], t [..., 3]) from a ``dlt_system``: the null vector by
    SVD (of A, not of AᵀA: squaring the condition number is fatal in float32
    for near-degenerate samples), denormalised, cheirality-flipped and
    orthonormalised by a second SVD. ``torch.linalg.svd`` waits for the
    host on CUDA, so this step runs eagerly between CUDA graphs."""
    _, _, vt = torch.linalg.svd(rows, full_matrices=False)
    p_norm = vt[..., -1, :].reshape(*vt.shape[:-2], 3, 4)
    t2_inv, t3 = _denorm(s3, c3, s2, c2)
    p = t2_inv @ p_norm @ t3
    p = torch.where((_det3(p[..., :3]) < 0)[..., None, None], -p, p)
    uu, ss, vt3 = torch.linalg.svd(p[..., :3])
    return uu @ vt3, p[..., 3] / torch.clamp(torch.mean(ss, dim=-1), min=1e-12)[..., None]


def pnp_dlt(points3d: torch.Tensor, points2d_norm: torch.Tensor,
            weights: torch.Tensor | None = None):
    """DLT PnP on normalised image coordinates.

    points3d [..., N, 3], points2d_norm [..., N, 2], weights [..., N] (0
    disables a row). Returns (qvec [..., 4], tvec [..., 3]); needs ≥6
    effective correspondences (with fewer the result is finite garbage;
    callers gate on inlier counts). Runs eagerly on any device."""
    w = torch.ones_like(points3d[..., 0]) if weights is None else weights
    rot, t = dlt_pose(*dlt_system(points3d, points2d_norm, w))
    return rotmat_to_qvec(rot), t


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
    denormalisation and a polar rotation. The 12×12 Cholesky and its
    triangular solves are written in elementwise tensor ops, as the JAX
    version unrolls them into scalar lanes: an indefinite sample gives NaN
    the same way, and a CUDA graph captures the whole solver."""
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
    chol = _cholesky_lanes(m)

    # The two start columns, all ones and alternating signs, / √12 (built
    # on the device: a host-made tensor would be a copy the capture refuses).
    sign = 1.0 - 2.0 * (torch.arange(12, device=dev) % 2).to(dt)
    x = (torch.stack([torch.ones_like(sign), sign], dim=1) / math.sqrt(12.0)).expand(h, 12, 2)
    for _ in range(4):
        x = _cholesky_solve_lanes(chol, x)
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
    return rotmat_to_qvec(rot), t


def pnp_dlt_fast(points3d: torch.Tensor, points2d_norm: torch.Tensor):
    """One sample, [N, 3] + [N, 2] (RANSAC's minimal N = 6) → (qvec [4],
    tvec [3]): the single-sample contract of the JAX package's
    ``pnp_dlt_fast``, on ``pnp_dlt_fast_lanes``'s solver (hypothesis
    generation only; final fits go through ``pnp_dlt``)."""
    q, t = pnp_dlt_fast_lanes(points3d[None], points2d_norm[None])
    return q[0], t[0]


def lm_linearize(delta, rot0, tvec, points3d, points2d, cam_params, weights,
                 jacobian: bool = True):
    """Weighted pixel residuals of pose-only LM at the update δ = (w, dt)
    [Q, 6] about the pose (rot0 [Q, 3, 3], tvec [Q, 3]): r [Q, N, 2] =
    (π(exp([w]×)·rot0·X + tvec + dt) − x)·weight, and with ``jacobian``
    also ∂r/∂δ [Q, N, 2, 6], analytic:

    * ∂pc/∂w = −[exp([w]×)·rot0·X]× · J_l(w) (left Jacobian of SO(3)),
      ∂pc/∂dt = I;
    * ∂π/∂pc through the 1e-8 depth guard (no derivative where it holds),
      the perspective division, ``_distort``'s radial and tangential
      terms and the focal lengths."""
    rot_w, j_l = _so3_exp_and_left_jacobian(delta[:, :3])
    pr = torch.einsum("qij,qnj->qni", rot_w @ rot0, points3d)
    pc = pr + (tvec + delta[:, 3:])[:, None, :]
    z = pc[..., 2]
    far = torch.abs(z) >= 1e-8
    inv_z = 1.0 / torch.where(far, z, torch.full_like(z, 1e-8))
    x, y = pc[..., 0] * inv_z, pc[..., 1] * inv_z
    cam = cam_params[:, None, :]
    xd, yd = _distort(x, y, cam)
    fx, fy = cam[..., 0], cam[..., 1]
    r = torch.stack([(fx * xd + cam[..., 2] - points2d[..., 0]) * weights,
                     (fy * yd + cam[..., 3] - points2d[..., 1]) * weights], dim=-1)
    if not jacobian:
        return r
    k1, k2, p1, p2 = cam[..., 4], cam[..., 5], cam[..., 6], cam[..., 7]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dr = 2.0 * (k1 + 2.0 * k2 * r2)  # ∂radial/∂x = dr·x, ∂radial/∂y = dr·y
    dxd_dx = radial + dr * x * x + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = dr * x * y + 2.0 * p1 * x + 2.0 * p2 * y  # = ∂yd/∂x
    dyd_dy = radial + dr * y * y + 6.0 * p1 * y + 2.0 * p2 * x
    dz = torch.where(far, inv_z, torch.zeros_like(inv_z))  # −∂(1/z)/∂z · z
    du = fx[..., None] * torch.stack([dxd_dx * inv_z, dxd_dy * inv_z,
                                      -(dxd_dx * x + dxd_dy * y) * dz], dim=-1)
    dv = fy[..., None] * torch.stack([dxd_dy * inv_z, dyd_dy * inv_z,
                                      -(dxd_dy * x + dyd_dy * y) * dz], dim=-1)
    jp = torch.stack([du, dv], dim=-2) * weights[..., None, None]  # ∂r/∂pc [Q, N, 2, 3]
    # Row by row, a·(−[p]×) = (p × a)ᵀ.
    jw = torch.einsum("qnij,qjk->qnik", torch.linalg.cross(pr[..., None, :].expand_as(jp), jp),
                      j_l)
    return r, torch.cat([jw, jp], dim=-1)


def _refine_pose_lm(qvec, tvec, points3d, points2d, cam_params, weights,
                    iterations: int, init_lambda: float):
    """LM over a leading query axis: qvec [Q, 4], tvec [Q, 3], points3d
    [Q, N, 3], points2d [Q, N, 2], cam_params [Q, 8], weights [Q, N]."""
    rot0 = qvec_to_rotmat(qvec)
    q_n, dt, dev = qvec.shape[0], qvec.dtype, qvec.device

    def lin(delta, jacobian=True):
        return lm_linearize(delta, rot0, tvec, points3d, points2d, cam_params, weights, jacobian)

    eye = torch.eye(6, dtype=dt, device=dev)
    delta = torch.zeros((q_n, 6), dtype=dt, device=dev)
    lam = torch.full((q_n,), init_lambda, dtype=dt, device=dev)
    best_cost = torch.sum(lin(delta, False) ** 2, dim=(-2, -1))
    for _ in range(iterations):
        r, jac = lin(delta)
        jf = jac.reshape(q_n, -1, 6)
        jft = jf.transpose(1, 2)
        jtj = jft @ jf
        jtr = jft @ r.reshape(q_n, -1, 1)
        damped = (jtj + lam[:, None, None] * torch.diag_embed(torch.diagonal(jtj, dim1=-2, dim2=-1))
                  + 1e-9 * eye)
        cand = delta - _cholesky_solve_lanes(_cholesky_lanes(damped, min_pivot=1e-20), jtr)[..., 0]
        new_cost = torch.sum(lin(cand, False) ** 2, dim=(-2, -1))
        improved = new_cost < best_cost
        delta = torch.where(improved[:, None], cand, delta)
        lam = torch.where(improved, lam * 0.3, lam * 4.0)
        best_cost = torch.minimum(best_cost, new_cost)
    rot = _axis_angle_to_rotmat(delta[:, :3]) @ rot0
    return rotmat_to_qvec(rot), tvec + delta[:, 3:]


def _leading_axis(*ts, rank: int = 1):
    """(True, ts with a leading axis of 1) when ts are one query's
    arguments (the first of rank `rank`: qvec [4], points2d [N, 2]), else
    (False, ts)."""
    if ts[0].ndim == rank:
        return True, tuple(t[None] for t in ts)
    return False, ts


def refine_pose_lm(qvec, tvec, points3d, points2d, cam_params, weights,
                   iterations: int = 10, init_lambda: float = 1e-3):
    """Levenberg–Marquardt pose-only refinement of pixel reprojection error
    (``pycolmap.pose_refinement`` parity). Rows with weight 0 contribute
    nothing. One query (qvec [4], points3d [N, 3], …) or a leading query
    axis (qvec [Q, 4], tvec [Q, 3], points3d [Q, N, 3], points2d [Q, N, 2],
    cam_params [Q, 8], weights [Q, N]). Returns (qvec, tvec)."""
    single, args = _leading_axis(qvec, tvec, points3d, points2d, cam_params, weights)

    def packed(inputs, _):
        q, t = _refine_pose_lm(*inputs, iterations, init_lambda)
        return (torch.cat([q, t], dim=-1),)

    out = graphs.run(graphs.Program(("lm", iterations, init_lambda), ((True, packed),), args))
    q, t = out[:, :4], out[:, 4:7]
    return (q[0], t[0]) if single else (q, t)


def _refine_pose_iterative(qvec, tvec, points3d, points2d, cam_params, base_mask, opt_thresh,
                           iters: int, lm_iterations: int):
    """``refine_pose_iterative`` over a leading query axis; returns the
    packed [Q, 8 + iters] result (qvec, tvec, num, nums)."""
    q, t = qvec, tvec
    q_n, dev = qvec.shape[0], qvec.device
    stopped = torch.zeros(q_n, dtype=torch.bool, device=dev)
    num = torch.zeros(q_n, dtype=torch.int32, device=dev)
    nums = []
    for _ in range(iters):
        proj, _ = project_points(points3d, q, t, cam_params)
        err = torch.linalg.norm(points2d - proj, dim=-1)
        mask = (err <= opt_thresh) & base_mask
        n = mask.sum(-1).to(torch.int32)
        run = (~stopped) & (n >= 6)
        q_new, t_new = _refine_pose_lm(q, t, points3d, points2d, cam_params,
                                       mask.to(points3d.dtype), lm_iterations, 1e-3)
        q = torch.where(run[:, None], q_new, q)
        t = torch.where(run[:, None], t_new, t)
        num = torch.where(run, n, num)
        stopped = stopped | ~run
        nums.append(torch.where(run, n, -1))
    return torch.cat([q, t, num[:, None].to(q.dtype), torch.stack(nums, dim=-1).to(q.dtype)],
                     dim=-1)


def refine_pose_iterative_program(qvec, tvec, points3d, points2d, cam_params, base_mask,
                                  opt_thresh, iters: int = 5,
                                  lm_iterations: int = 10) -> graphs.Program:
    """The refinement over a leading query axis as a one-segment program;
    ``graphs.run`` returns its packed result [Q, 8 + iters]: qvec (4),
    tvec (3), num, nums (iters) — the JAX engine's ``_packed_refine``
    layout. ``opt_thresh`` becomes a device scalar input, so one captured
    graph serves every threshold."""
    thresh = torch.full((), float(opt_thresh), dtype=qvec.dtype, device=qvec.device)

    def packed(inputs, _):
        return (_refine_pose_iterative(*inputs, iters, lm_iterations),)

    return graphs.Program(("refine", iters, lm_iterations), ((True, packed),),
                          (qvec, tvec, points3d, points2d, cam_params, base_mask, thresh))


def refine_pose_iterative(qvec, tvec, points3d, points2d, cam_params, base_mask,
                          opt_thresh: float, iters: int = 5, lm_iterations: int = 10):
    """Covisibility-refinement inner loop: per iteration reproject,
    re-select inliers (err ≤ opt_thresh AND base_mask), stop for good when
    support < 6, else LM-refine on the selection (the reference's host loop
    ``it_loc/localize_cv2.py:341-370``). One query or a leading query axis,
    as ``refine_pose_lm``. Returns (qvec, tvec, num — support of the last
    executed iteration (0 if none ran), nums [iters] — per iteration
    support, −1 where it did not run)."""
    single, args = _leading_axis(qvec, tvec, points3d, points2d, cam_params, base_mask)
    out = graphs.run(refine_pose_iterative_program(*args, opt_thresh, iters, lm_iterations))
    q, t = out[:, :4], out[:, 4:7]
    num, nums = out[:, 7].to(torch.int32), out[:, 8:].to(torch.int32)
    return (q[0], t[0], num[0], nums[0]) if single else (q, t, num, nums)
