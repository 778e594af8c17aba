"""Bundle adjustment: Schur-complement LM with matrix-free PCG (PyTorch).

Port of ``sfd2_tpu/sfm/ba.py`` — the Ceres solves that the reference
delegates to COLMAP: point refinement inside ``point_triangulator``
(``hloc/triangulation.py:140-142``) and the full BA of ``colmap mapper``
(``hloc/reconstruction.py:66-83``).

* Observations are flat arrays (xy, camera index, point index, weight);
  every per-camera or per-point reduction is a segmented sum in a fixed
  order (``SegmentPlan``, the JAX package's ``segment_sum``): no float
  atomics, so a run on the card gives the same bits every time, and
  every per-observation read of a camera
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
* One LM iteration is a function of its state (``lm_setup`` returns it
  with the first state; ``LMState``). On CPU tensors ``bundle_adjust``
  calls it ``lm_iters`` times. On CUDA tensors it runs the first iteration
  eagerly, which loads every kernel, cuBLAS's workspace and K3's library,
  then captures one iteration (the Schur-PCG solve with its whole CG loop,
  the trial linearisation, accept/reject and the copy back into static
  state tensors) as a CUDA graph and replays it for the other
  ``lm_iters − 1``: a few hundred launches per iteration become one.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from sfd2_torch.geometry.cameras import _distort
from sfd2_torch.geometry.rotations import qvec_to_rotmat, rotmat_to_qvec
from sfd2_torch.localization.pnp import _axis_angle_to_rotmat, _inv6_spd_lanes
from sfd2_torch.ops.cuda_gather import (count_graph_replays, gather_rows_cuda,
                                        graph_capture_record)
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


SEGMENT_WIDTH = 32  # rows summed per step of a SegmentPlan


class SegmentPlan:
    """A segmented sum over rows in one fixed order: no atomics, so the
    same input gives the same bits on every run (``index_add_``'s float
    atomics on CUDA add in a different order each time).

    Built once from the segment id of each row (a host sync); ``__call__``
    then launches the same fixed-shape work every time, so a CUDA graph
    can capture it. Each level gathers the rows of every segment, in
    order, into blocks of ``width`` (short blocks padded with a zero row)
    and sums each block; a segment with more than ``width`` rows leaves
    several block sums, which the next level reduces the same way, so a
    segment of d rows takes ⌈log_width d⌉ levels and memory stays within
    (rows + segments·width) per level. The last level lays out one block
    per segment, in segment order, as wide as the largest remaining
    segment (empty segments sum the zero row)."""

    def __init__(self, seg: torch.Tensor, n: int, width: int = SEGMENT_WIDTH):
        import numpy as np

        seg_np = seg.detach().cpu().numpy().astype(np.int64)
        rows = np.argsort(seg_np, kind="stable")  # row ids, grouped by segment
        seg_sorted = seg_np[rows]
        self.n = n
        self.levels = []  # [n_blocks, width] int64 index into (prev rows + zero row)
        while True:
            counts = np.bincount(seg_sorted, minlength=n)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            m = len(seg_sorted)
            if counts.max(initial=0) <= width:
                j = np.arange(max(int(counts.max(initial=0)), 1))
                idx = np.where(j[None, :] < counts[:, None], starts[:, None] + j[None, :], m)
                self.levels.append(np.where(idx < m, rows[np.minimum(idx, m - 1)], m)
                                   if m else np.zeros((n, 1), np.int64))
                break
            n_blocks = -(-counts // width)  # blocks per segment
            block_seg = np.repeat(np.arange(n), n_blocks)
            first = np.repeat(starts, n_blocks) + width * (
                np.arange(len(block_seg)) - np.repeat(np.cumsum(n_blocks) - n_blocks, n_blocks))
            end = np.repeat(starts + counts, n_blocks)
            idx = first[:, None] + np.arange(width)[None, :]
            self.levels.append(np.where(idx < end[:, None], rows[np.minimum(idx, m - 1)], m))
            # The next level reduces the block sums, already in segment order.
            rows, seg_sorted = np.arange(len(block_seg)), block_seg
        self.levels = [torch.from_numpy(np.ascontiguousarray(lv)).to(seg.device)
                       for lv in self.levels]

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        """[rows, ...] → [n, ...]: the sum of each segment's rows."""
        for idx in self.levels:
            padded = torch.cat([values, values.new_zeros((1, *values.shape[1:]))])
            values = padded[idx].sum(dim=1)
        return values


class LMState(NamedTuple):
    """What one LM iteration carries from the last: the parameters (poses as
    rotation matrices), the cost and linearisation at them, and λ, ν."""

    rot: torch.Tensor  # [C, 3, 3]
    tvecs: torch.Tensor  # [C, 3]
    points: torch.Tensor  # [P, 3]
    cost: torch.Tensor  # [] true Huber cost
    r: torch.Tensor  # [O, 2] residuals
    jc: torch.Tensor  # [O, 2, 6] pose Jacobians (0 on fixed cameras)
    jp: torch.Tensor  # [O, 2, 3] point Jacobians
    w: torch.Tensor  # [O] IRLS weights
    lam: torch.Tensor  # [] damping λ
    nu: torch.Tensor  # [] rejection growth ν
    initial_cost: torch.Tensor  # [] cost before the first iteration


def lm_setup(problem: BAProblem, cg_iters: int = 20, huber_delta: float = 4.0,
             init_lambda: float = 1e-4,
             optimize_points: bool = True) -> Tuple[Callable[[LMState], LMState], LMState]:
    """(iterate, state): one LM iteration as a function of its state, and
    the state before the first. ``iterate`` launches the same device work
    on every call and never synchronises with the host, so a CUDA graph
    can capture it; ``lm_result(state)`` gives the ``BAResult``."""
    # Observations sorted by point once per solve: everything downstream is
    # order-invariant, and the point gathers then read the table in order.
    order = torch.argsort(problem.obs_point, stable=True)
    obs_xy = problem.obs_xy[order]
    obs_cam = problem.obs_cam[order].to(torch.int32)
    obs_point = problem.obs_point[order].to(torch.int32)
    base_w = problem.obs_w[order]
    cam_params_all = problem.cam_params
    n_cam, n_pt = problem.qvecs.shape[0], problem.points.shape[0]
    # The fixed summation orders of the per-camera and per-point reductions.
    cam_sum, pt_sum = SegmentPlan(obs_cam, n_cam), SegmentPlan(obs_point, n_pt)
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
        hcc = cam_sum(torch.einsum("oij,oik->ojk", jcw, jc))  # [C,6,6]
        hpp = pt_sum(torch.einsum("oij,oik->ojk", jpw, jp))  # [P,3,3]
        rw = r * w[:, None]
        bc = cam_sum(torch.einsum("oij,oi->oj", jc, rw))  # [C,6]
        bp = pt_sum(torch.einsum("oij,oi->oj", jp, rw))  # [P,3]

        # Damping: multiplicative λ·diag (Marquardt) on both blocks.
        diag_c = torch.clamp(torch.diagonal(hcc, dim1=-2, dim2=-1), min=1e-6)
        diag_p = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), min=1e-6)
        hcc_d = hcc + (lam * diag_c)[:, :, None] * eye6
        hpp_inv = _inv3_lanes(hpp + (lam * diag_p)[:, :, None] * eye3 + 1e-9 * eye3)

        def hcp_apply(vp):  # [P,3] → [C,6]: Σ_o w Jcᵀ Jp v_p(o)
            v = _gather(vp, obs_point)
            return cam_sum(torch.einsum("oij,oik,ok->oj", jcw, jp, v))

        def hpc_apply(vc):  # [C,6] → [P,3]
            v = _gather(vc, obs_cam)
            return pt_sum(torch.einsum("oik,oij,oj->ok", jpw, jc, v))

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

    def iterate(s: LMState) -> LMState:
        """One LM iteration: solve, trial linearisation, accept/reject."""
        lin = (s.r, s.jc, s.jp, s.w)
        dcam, dpt, pred = solve(lin, s.lam)
        rot_n = _axis_angle_to_rotmat(dcam[:, :3]) @ s.rot
        tvec_n, pts_n = s.tvecs + dcam[:, 3:], s.points + dpt
        lin_n, new_cost = linearize(rot_n, tvec_n, pts_n)
        finite = torch.isfinite(new_cost) & torch.isfinite(rot_n).all() & torch.isfinite(pts_n).all()
        accept = finite & (new_cost < s.cost)
        # Gain ratio: actual / model-predicted reduction (on a rejected step
        # it only feeds the discarded accept branch of λ).
        rho = (s.cost - new_cost) / torch.clamp(pred, min=1e-12)
        lam_acc = s.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        r, jc, jp, w = (torch.where(accept, a, b) for a, b in zip(lin_n, lin))
        return LMState(
            rot=torch.where(accept, rot_n, s.rot), tvecs=torch.where(accept, tvec_n, s.tvecs),
            points=torch.where(accept, pts_n, s.points),
            cost=torch.where(accept, new_cost, s.cost), r=r, jc=jc, jp=jp, w=w,
            lam=torch.where(accept, torch.clamp(lam_acc, 1e-10, 1e8),
                            torch.clamp(s.lam * s.nu, max=1e8)),
            nu=torch.where(accept, 2.0, torch.clamp(s.nu * 2.0, max=64.0)),
            initial_cost=s.initial_cost)

    rot0 = qvec_to_rotmat(problem.qvecs)
    (r, jc, jp, w), cost0 = linearize(rot0, problem.tvecs, problem.points)
    state = LMState(rot=rot0, tvecs=problem.tvecs, points=problem.points, cost=cost0, r=r, jc=jc,
                    jp=jp, w=w, lam=torch.tensor(init_lambda, dtype=dt, device=dev),
                    nu=torch.tensor(2.0, dtype=dt, device=dev), initial_cost=cost0)
    return iterate, state


def lm_result(state: LMState) -> BAResult:
    """The ``BAResult`` of an LM state (poses back to quaternions)."""
    return BAResult(qvecs=rotmat_to_qvec(state.rot), tvecs=state.tvecs, points=state.points,
                    initial_cost=state.initial_cost, final_cost=state.cost)


# device index → (the side stream BA captures and replays on, the last
# call's graph: kept until the next capture, which takes over its memory pool)
_graph_state: dict = {}


def _replay_in_graph(iterate, state: LMState, lm_iters: int) -> LMState:
    """The LM loop on the card, on a side stream of its own (a capture
    cannot run on the legacy default stream, and cuBLAS keeps a workspace
    per stream, which the eager iteration creates before the capture):
    iteration 1 eagerly, then one iteration captured over static copies of
    the state, the copy back into them inside the graph, replayed
    lm_iters − 1 times. K3's launches are counted per replay. The call
    waits for its replays. Each capture draws on the memory pool of the
    previous call's graph, kept alive until then and never replayed again:
    a fresh pool per capture pays cudaMalloc on every call, and a pool no
    graph holds cannot be reused."""
    dev = state.points.get_device()
    if dev not in _graph_state:
        _graph_state[dev] = torch.cuda.Stream(dev), None
    side, last = _graph_state[dev]
    caller = torch.cuda.current_stream(dev)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        if lm_iters >= 1:
            state = iterate(state)
        if lm_iters >= 2:
            static = LMState(*(t.clone() for t in state))
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with graph_capture_record() as captured:
                graph.capture_begin(pool=None if last is None else last.pool())
                try:
                    for dst, src in zip(static, iterate(static)):
                        dst.copy_(src)
                finally:
                    graph.capture_end()
            bundle_adjust.capture_s += time.perf_counter() - t0
            bundle_adjust.graph_captures += 1
            for _ in range(lm_iters - 1):
                graph.replay()
            count_graph_replays(captured, lm_iters - 1)
            bundle_adjust.graph_replays += lm_iters - 1
            side.synchronize()
            _graph_state[dev] = side, graph
            state = static
    caller.wait_stream(side)
    for t in state:
        t.record_stream(caller)
    return state


def bundle_adjust(problem: BAProblem, lm_iters: int = 10, cg_iters: int = 20,
                  huber_delta: float = 4.0, init_lambda: float = 1e-4,
                  optimize_points: bool = True) -> BAResult:
    """Run LM with Schur-complement PCG steps on the problem's device (on
    the card, replayed from a CUDA graph). Returns updated poses, points
    and costs."""
    iterate, state = lm_setup(problem, cg_iters, huber_delta, init_lambda, optimize_points)
    if state.points.is_cuda:
        state = _replay_in_graph(iterate, state, lm_iters)
    else:
        for _ in range(lm_iters):
            state = iterate(state)
    return lm_result(state)


# Graph statistics since the caller last set them to 0: captures, replays
# and the host seconds the captures took.
bundle_adjust.graph_captures = 0
bundle_adjust.graph_replays = 0
bundle_adjust.capture_s = 0.0
