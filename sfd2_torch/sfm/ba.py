"""Bundle adjustment: Schur-complement LM with matrix-free PCG (PyTorch).

Port of ``sfd2_tpu/sfm/ba.py`` — the Ceres solves that the reference
delegates to COLMAP: point refinement inside ``point_triangulator``
(``hloc/triangulation.py:140-142``) and the full BA of ``colmap mapper``
(``hloc/reconstruction.py:66-83``).

* Observations are flat arrays (xy, camera index, point index, weight);
  every per-camera or per-point reduction is an ``index_add_`` (the JAX
  package's ``segment_sum``), and every per-observation read of a camera
  or point block goes through the row gather, kernel K3 on the card
  (``ops/cuda_gather.py``; its plain version on CPU tensors).
* The normal equations are never formed: the Schur complement
  S = Hcc − Hcp·Hpp⁻¹·Hpc is applied matrix-free inside preconditioned CG
  (block-Jacobi from the damped Hcc blocks).
* Huber IRLS weights; LM damping with the gain-ratio trust region
  (Madsen–Nielsen, Ceres semantics): λ shrinks by max(1/3, 1−(2ρ−1)³) on
  accept and grows by a doubling ν on reject.
* One linearisation per LM iteration: residuals and Jacobians of all
  observations come from one batched ``torch.func.vmap(jacfwd)`` call,
  and an accepted trial's linearisation is reused by the next iteration.
  The LM and CG loops that were ``lax.scan`` are Python loops whose
  accept/reject stays on the device (``torch.where``): no iteration
  synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from sfd2_torch.geometry.cameras import _distort
from sfd2_torch.geometry.rotations import qvec_to_rotmat, rotmat_to_qvec
from sfd2_torch.localization.pnp import _axis_angle_to_rotmat
from sfd2_torch.ops.cuda_gather import gather_rows_cuda
from sfd2_torch.sfm.triangulation import _inv3_lanes


class BAProblem(NamedTuple):
    """One BA instance. Padded observations have weight 0."""

    obs_xy: torch.Tensor  # [O, 2] pixel observations
    obs_cam: torch.Tensor  # [O] int camera index
    obs_point: torch.Tensor  # [O] int point index
    obs_w: torch.Tensor  # [O] weight (0 = padding)
    qvecs: torch.Tensor  # [C, 4] initial poses (world→cam)
    tvecs: torch.Tensor  # [C, 3]
    cam_params: torch.Tensor  # [C, 8] canonical intrinsics (fixed)
    points: torch.Tensor  # [P, 3] initial points
    fixed_cams: torch.Tensor  # [C] bool — poses to keep fixed (gauge/anchors)


class BAResult(NamedTuple):
    qvecs: torch.Tensor
    tvecs: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _inv6_spd_lanes(m):
    """Inverse of SPD [..., 6, 6] by Cholesky with clamped pivots, so a
    near-singular float32 block gives a huge but finite inverse instead of
    a NaN that would poison every camera through the PCG dot products."""
    n = m.shape[-1]
    lower = torch.zeros_like(m)
    for j in range(n):
        d = m[..., j, j] - torch.sum(lower[..., j, :j] ** 2, dim=-1)
        ljj = torch.sqrt(torch.clamp(d, min=1e-20))
        col = (m[..., j + 1:, j] - torch.sum(lower[..., j + 1:, :j] * lower[..., j:j + 1, :j],
                                             dim=-1)) / ljj[..., None]
        lower[..., j, j] = ljj
        lower[..., j + 1:, j] = col
    eye = torch.eye(n, dtype=m.dtype, device=m.device).expand(m.shape)
    y = torch.linalg.solve_triangular(lower, eye, upper=False)
    return torch.linalg.solve_triangular(lower.transpose(-1, -2), y, upper=True)


def _project_one(cam6, rot0, tvec0, point, cam_params):
    """Pixel projection [2] of one observation with a local (rotvec, dt)
    pose perturbation."""
    rot = _axis_angle_to_rotmat(cam6[:3]) @ rot0
    pc = rot @ point + (tvec0 + cam6[3:])
    # Length-1 slices, not 0-dim elements: under forward-mode AD a 0-dim
    # tensor meeting a Python scalar gets a float64 tangent.
    z = pc[2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    xd, yd = _distort(pc[0:1] / z, pc[1:2] / z, cam_params)
    return torch.cat([cam_params[0] * xd + cam_params[2], cam_params[1] * yd + cam_params[3]])


def _residual_one(cam6, dpoint, rot0, tvec0, point0, cam_params, xy):
    r = _project_one(cam6, rot0, tvec0, point0 + dpoint, cam_params) - xy
    return r, r


# Residual [2] and its Jacobians [2, 6] (pose) and [2, 3] (point) at zero
# perturbation, for all observations in one batched call.
_jac_res = vmap(jacfwd(_residual_one, argnums=(0, 1), has_aux=True),
                in_dims=(None, None, 0, 0, 0, 0, 0))


def _huber_weight(r2, delta):
    """Sqrt-scaled IRLS weight for the Huber kernel."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def _gather(table, idx):
    return gather_rows_cuda(table.contiguous(), idx)


def _segment_sum(values, idx, n):
    return torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                       device=values.device).index_add_(0, idx, values)


def bundle_adjust(problem: BAProblem, lm_iters: int = 10, cg_iters: int = 20,
                  huber_delta: float = 4.0, init_lambda: float = 1e-4,
                  optimize_points: bool = True) -> BAResult:
    """Run LM with Schur-complement PCG steps on the problem's device.
    Returns updated poses, points and costs."""
    # Observations sorted by point once per solve: everything downstream is
    # order-invariant, and the point gathers then read the table in order.
    order = torch.argsort(problem.obs_point, stable=True)
    obs_xy = problem.obs_xy[order]
    obs_cam = problem.obs_cam[order].to(torch.int32)
    obs_point = problem.obs_point[order].to(torch.int32)
    base_w = problem.obs_w[order]
    cam_params_all = problem.cam_params
    n_cam, n_pt = problem.qvecs.shape[0], problem.points.shape[0]
    dt, dev = problem.points.dtype, problem.points.device
    free_cam = (~problem.fixed_cams).to(dt)[:, None]  # [C, 1]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def linearize(rot0, tvecs, points):
        """Residuals, Jacobians, IRLS weights and the true Huber cost at the
        given parameters, from one gather pass."""
        rot_o = _gather(rot0.reshape(n_cam, 9), obs_cam).reshape(-1, 3, 3)
        t_o = _gather(tvecs, obs_cam)
        p_o = _gather(points, obs_point)
        cp_o = _gather(cam_params_all, obs_cam)
        (jc, jp), r = _jac_res(torch.zeros(6, dtype=dt, device=dev),
                               torch.zeros(3, dtype=dt, device=dev), rot_o, t_o, p_o, cp_o,
                               obs_xy)
        r2 = torch.sum(r * r, dim=1)
        w = base_w * _huber_weight(r2, huber_delta)  # IRLS weights [O]
        jc = jc * _gather(free_cam, obs_cam)[:, None, :]  # fixed cameras do not move
        if not optimize_points:
            jp = jp * 0.0
        rr = torch.sqrt(torch.clamp(r2, min=1e-12))
        c = torch.where(rr <= huber_delta, 0.5 * r2, huber_delta * (rr - 0.5 * huber_delta))
        return (r, jc, jp, w), torch.sum(c * base_w)

    def solve(lin, lam):
        """Damped Schur-PCG solve of the carried normal equations.
        Returns (dcam [C,6], dpt [P,3], predicted cost reduction)."""
        r, jc, jp, w = lin
        wj = w[:, None, None]
        jcw, jpw = jc * wj, jp * wj
        hcc = _segment_sum(torch.einsum("oij,oik->ojk", jcw, jc), obs_cam, n_cam)  # [C,6,6]
        hpp = _segment_sum(torch.einsum("oij,oik->ojk", jpw, jp), obs_point, n_pt)  # [P,3,3]
        rw = r * w[:, None]
        bc = _segment_sum(torch.einsum("oij,oi->oj", jc, rw), obs_cam, n_cam)  # [C,6]
        bp = _segment_sum(torch.einsum("oij,oi->oj", jp, rw), obs_point, n_pt)  # [P,3]

        # Damping: multiplicative λ·diag (Marquardt) on both blocks.
        diag_c = torch.clamp(torch.diagonal(hcc, dim1=-2, dim2=-1), min=1e-6)
        diag_p = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), min=1e-6)
        hcc_d = hcc + (lam * diag_c)[:, :, None] * eye6
        hpp_inv = _inv3_lanes(hpp + (lam * diag_p)[:, :, None] * eye3 + 1e-9 * eye3)

        def hcp_apply(vp):  # [P,3] → [C,6]: Σ_o w Jcᵀ Jp v_p(o)
            v = _gather(vp, obs_point)
            return _segment_sum(torch.einsum("oij,oik,ok->oj", jcw, jp, v), obs_cam, n_cam)

        def hpc_apply(vc):  # [C,6] → [P,3]
            v = _gather(vc, obs_cam)
            return _segment_sum(torch.einsum("oik,oij,oj->ok", jpw, jc, v), obs_point, n_pt)

        def s_apply(vc):  # S·v, matrix-free
            tmp = torch.einsum("pjk,pk->pj", hpp_inv, hpc_apply(vc))
            return torch.einsum("cjk,ck->cj", hcc_d, vc) - hcp_apply(tmp)

        # Schur RHS: b̃_c = b_c − Hcp · Hpp⁻¹ · b_p.
        rhs = bc - hcp_apply(torch.einsum("pjk,pk->pj", hpp_inv, bp))
        m_inv = _inv6_spd_lanes(hcc_d + 1e-9 * eye6)  # block-Jacobi preconditioner

        def guard(v):
            return torch.where(torch.abs(v) < 1e-12, 1e-12, v)

        x = torch.zeros_like(rhs)
        rvec = rhs - s_apply(x)
        z = torch.einsum("cjk,ck->cj", m_inv, rvec)
        p = z
        rz = torch.sum(rvec * z)
        for _ in range(cg_iters):
            sp = s_apply(p)
            alpha = rz / guard(torch.sum(p * sp))
            x = x + alpha * p
            rvec = rvec - alpha * sp
            z = torch.einsum("cjk,ck->cj", m_inv, rvec)
            rz_new = torch.sum(rvec * z)
            p = z + (rz_new / guard(rz)) * p
            rz = rz_new
        dcam = -x * free_cam  # GN solves J d = −r with this sign convention
        # Back-substitute points: d_p = −Hpp⁻¹ (b_p + Hpc d_c).
        dpt = -torch.einsum("pjk,pk->pj", hpp_inv, bp + hpc_apply(dcam))
        if not optimize_points:
            dpt = dpt * 0.0
        # Predicted reduction of the quadratic model for the damped solve
        # (H + λD) d = −g: pred = ½(λ dᵀDd − gᵀd), both terms ≥ 0 for a
        # descent step (Madsen–Nielsen eq. 3.21 with D = diag(H)).
        dtd = torch.sum(dcam * diag_c * dcam) + torch.sum(dpt * diag_p * dpt)
        gtd = torch.sum(dcam * bc) + torch.sum(dpt * bp)
        return dcam, dpt, 0.5 * (lam * dtd - gtd)

    rot0 = qvec_to_rotmat(problem.qvecs)
    tvecs, points = problem.tvecs, problem.points
    lin, cost0 = linearize(rot0, tvecs, points)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    nu = torch.tensor(2.0, dtype=dt, device=dev)
    for _ in range(lm_iters):
        dcam, dpt, pred = solve(lin, lam)
        rot_n = _axis_angle_to_rotmat(dcam[:, :3]) @ rot0
        tvec_n, pts_n = tvecs + dcam[:, 3:], points + dpt
        lin_n, new_cost = linearize(rot_n, tvec_n, pts_n)
        finite = torch.isfinite(new_cost) & torch.isfinite(rot_n).all() & torch.isfinite(pts_n).all()
        accept = finite & (new_cost < cost)
        # Gain ratio: actual / model-predicted reduction (on a rejected step
        # it only feeds the discarded accept branch of λ).
        rho = (cost - new_cost) / torch.clamp(pred, min=1e-12)
        rot0 = torch.where(accept, rot_n, rot0)
        tvecs = torch.where(accept, tvec_n, tvecs)
        points = torch.where(accept, pts_n, points)
        cost = torch.where(accept, new_cost, cost)
        lin = tuple(torch.where(accept, a, b) for a, b in zip(lin_n, lin))
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, torch.clamp(lam_acc, 1e-10, 1e8), torch.clamp(lam * nu, max=1e8))
        nu = torch.where(accept, 2.0, torch.clamp(nu * 2.0, max=64.0))
    return BAResult(qvecs=rotmat_to_qvec(rot0), tvecs=tvecs, points=points, initial_cost=cost0,
                    final_cost=cost)
