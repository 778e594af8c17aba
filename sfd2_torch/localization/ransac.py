"""Batched LO-RANSAC PnP (hypotheses as a batch dimension).

Port of ``sfd2_tpu/localization/ransac.py`` (``pycolmap.
absolute_pose_estimation`` parity): H minimal sets are solved at once
(``pnp_dlt_fast_lanes``), all H×N reprojection errors are scored in one
pass, the best hypothesis wins, and local optimisation (least-squares DLT
on its inliers, then masked LM) recovers a sequential LO-RANSAC's
accuracy. Every step takes a leading query axis Q: the port's form of
the JAX engine's ``vmap`` of PnP-RANSAC over queries.

Sampling is split from the core: ``sample_minimal_sets`` draws
Gumbel-top-k sets ∝ validity from ``torch.Generator``s (where the JAX
package used ``jax.random``), eagerly and outside any graph (a capture
would freeze a generator's offset), and ``pnp_ransac_core`` takes any
``sample_idx [Q, H, 6]``, so both packages can be fed the same hypotheses.
The core is a ``graphs.Program``: on CUDA tensors it replays CUDA graphs
captured once per shape, with the LO refits' SVDs (``pnp.dlt_pose``) run
eagerly between them; on CPU tensors it runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sfd2_torch.geometry.cameras import project_points, unproject_normalized
from sfd2_torch.geometry.rotations import rotmat_to_qvec
from sfd2_torch.localization import graphs
from sfd2_torch.localization.pnp import (_leading_axis, _refine_pose_lm, dlt_pose, dlt_system,
                                         pnp_dlt_fast_lanes)

_MIN_SAMPLE = 6  # DLT minimal set
_SCORE_CHUNK = 256  # hypotheses scored per pass: bounds the [Q, chunk, N, 3] temporaries


class PnPResult(NamedTuple):
    qvec: torch.Tensor  # [4] (or [Q, 4])
    tvec: torch.Tensor  # [3]
    num_inliers: torch.Tensor  # [] int32
    inliers: torch.Tensor  # [N] bool
    success: torch.Tensor  # [] bool


def _inlier_mask(qvec, tvec, points3d, points2d, cam_params, threshold, valid):
    proj, depth = project_points(points3d, qvec, tvec, cam_params)
    err = torch.linalg.norm(proj - points2d, dim=-1)
    return (err <= threshold) & (depth > 0) & valid


def _finite(q, t):
    return torch.isfinite(q).all(-1) & torch.isfinite(t).all(-1)


def fold_seed(base: int, index: int) -> int:
    """The seed of query `index`'s generator in a batch seeded `base`: the
    port's counterpart of ``jax.random.fold_in(key(base), index)``, so a
    query draws the same hypotheses wherever it sits in a batch."""
    return (base << 32) | index


def sample_minimal_sets(valid: torch.Tensor, num_hypotheses: int,
                        generator: torch.Generator | Sequence[torch.Generator] | None = None
                        ) -> torch.Tensor:
    """Minimal-set indices drawn without replacement ∝ `valid` (Gumbel top-k
    over the mask): valid [N] and one generator → [H, 6]; valid [Q, N] and
    one generator per query → [Q, H, 6], query q's rows drawn from
    generator q alone."""
    if valid.ndim == 1:
        u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator,
                       device=valid.device)
    else:
        u = torch.stack([torch.rand((num_hypotheses, valid.shape[1]), generator=g,
                                    device=valid.device) for g in generator])
        valid = valid[:, None, :]
    g = -torch.log(-torch.log(u)) + torch.log(valid.float() + 1e-30)
    return torch.topk(g, _MIN_SAMPLE, dim=-1).indices


def _best_hypothesis(points2d, points3d, cam, valid, sample_idx, threshold, pts_norm):
    """The minimal solver on every sampled set, each hypothesis scored by
    its inlier count (non-finite ones score 0); the best pose per query."""
    q_n, h = sample_idx.shape[:2]
    rows = torch.arange(q_n, device=sample_idx.device)[:, None, None]
    h_q, h_t = pnp_dlt_fast_lanes(points3d[rows, sample_idx].reshape(q_n * h, _MIN_SAMPLE, 3),
                                  pts_norm[rows, sample_idx].reshape(q_n * h, _MIN_SAMPLE, 2))
    h_q, h_t = h_q.reshape(q_n, h, 4), h_t.reshape(q_n, h, 3)
    counts = torch.cat([
        _inlier_mask(h_q[:, s:s + _SCORE_CHUNK], h_t[:, s:s + _SCORE_CHUNK], points3d[:, None],
                     points2d[:, None], cam[:, None, None], threshold, valid[:, None]).sum(-1)
        for s in range(0, h, _SCORE_CHUNK)], dim=1)
    best = torch.argmax(torch.where(_finite(h_q, h_t), counts, 0), dim=-1)
    pick = torch.arange(q_n, device=best.device)
    return h_q[pick, best], h_t[pick, best]


def pnp_ransac_program(points2d, points3d, cam_params, valid, sample_idx,
                       threshold: float | torch.Tensor = 12.0, lo_iterations: int = 2,
                       min_inliers: int = 6) -> graphs.Program:
    """PnP-RANSAC on given hypotheses over a leading query axis as a
    program; ``graphs.run`` returns its packed result [Q, 9 + N]: qvec (4),
    tvec (3), num_inliers, success, inliers (N) — the JAX engine's
    ``_packed_pnp`` layout. points2d [Q, N, 2] pixels, points3d [Q, N, 3],
    cam_params [Q, 8], valid [Q, N] bool, sample_idx [Q, H, 6]. The
    threshold becomes a device scalar input.

    Segments: [hypotheses, scoring, the first LO round's inlier set and DLT
    system] · then per LO round [SVD pose (eager)] · [LS refit accepted or
    not, LM, the next round's DLT system, or the final inliers and pack]."""
    thresh = (threshold.to(points2d) if isinstance(threshold, torch.Tensor) else
              torch.full((), float(threshold), dtype=points2d.dtype, device=points2d.device))

    def lo_system(inp, pts_norm, q, t):
        kp, p3, cam, va, _, th = inp
        inl = _inlier_mask(q, t, p3, kp, cam, th, va)
        w = inl.to(kp.dtype)
        return (pts_norm, q, t, inl.sum(-1), w) + dlt_system(p3, pts_norm, w)

    def final(inp, q, t):
        kp, p3, cam, va, _, th = inp
        inliers = _inlier_mask(q, t, p3, kp, cam, th, va)
        num = inliers.sum(-1)
        success = (num >= min_inliers) & _finite(q, t)
        return (torch.cat([q, t, num[:, None].to(q.dtype), success[:, None].to(q.dtype),
                           inliers.to(q.dtype)], dim=-1),)

    def head(inp, _):
        kp, p3, cam, va, idx, th = inp
        pts_norm = unproject_normalized(kp, cam)
        q, t = _best_hypothesis(kp, p3, cam, va, idx, th, pts_norm)
        return lo_system(inp, pts_norm, q, t) if lo_iterations else final(inp, q, t)

    def solve(inp, state):
        pts_norm, q, t, n_inl, w = state[:5]
        return (pts_norm, q, t, n_inl, w) + dlt_pose(*state[5:])

    def lo_step(last):
        def step(inp, state):
            kp, p3, cam, va, _, th = inp
            pts_norm, q, t, n_inl, w, rot_ls, t_ls = state
            q_ls = rotmat_to_qvec(rot_ls)
            cnt_ls = _inlier_mask(q_ls, t_ls, p3, kp, cam, th, va).sum(-1)
            take_ls = (w.sum(-1) >= _MIN_SAMPLE) & _finite(q_ls, t_ls) & (cnt_ls >= n_inl)
            q = torch.where(take_ls[:, None], q_ls, q)
            t = torch.where(take_ls[:, None], t_ls, t)
            inl = _inlier_mask(q, t, p3, kp, cam, th, va)
            q_lm, t_lm = _refine_pose_lm(q, t, p3, kp, cam, inl.to(kp.dtype), 10, 1e-3)
            cnt_lm = _inlier_mask(q_lm, t_lm, p3, kp, cam, th, va).sum(-1)
            take_lm = _finite(q_lm, t_lm) & (cnt_lm >= inl.sum(-1))
            q = torch.where(take_lm[:, None], q_lm, q)
            t = torch.where(take_lm[:, None], t_lm, t)
            return final(inp, q, t) if last else lo_system(inp, pts_norm, q, t)

        return step

    segments = [(True, head)]
    for i in range(lo_iterations):
        segments += [(False, solve), (True, lo_step(i == lo_iterations - 1))]
    return graphs.Program(("pnp", lo_iterations, min_inliers), tuple(segments),
                          (points2d, points3d, cam_params, valid, sample_idx, thresh))


def unpack_pnp(out: torch.Tensor) -> PnPResult:
    """The ``PnPResult`` of a packed [..., 9 + N] result."""
    return PnPResult(qvec=out[..., :4], tvec=out[..., 4:7],
                     num_inliers=out[..., 7].to(torch.int32), inliers=out[..., 9:] > 0.5,
                     success=out[..., 8] > 0.5)


def pnp_ransac_core(points2d, points3d, cam_params, valid, sample_idx,
                    threshold: float = 12.0, lo_iterations: int = 2,
                    min_inliers: int = 6) -> PnPResult:
    """RANSAC on given hypotheses: points2d [N, 2] pixels, points3d [N, 3],
    cam_params [8] canonical intrinsics, valid [N] bool, sample_idx [H, 6];
    or the same with a leading query axis Q."""
    single, args = _leading_axis(points2d, points3d, cam_params, valid, sample_idx, rank=2)
    out = graphs.run(pnp_ransac_program(*args, threshold, lo_iterations, min_inliers))
    return unpack_pnp(out[0] if single else out)


def pnp_ransac(points2d, points3d, cam_params, valid, threshold: float = 12.0,
               generator: torch.Generator | None = None, num_hypotheses: int = 1024,
               lo_iterations: int = 2, min_inliers: int = 6) -> PnPResult:
    """Estimate a world→cam pose from padded 2D-3D matches of one query
    (`threshold` is the inlier reprojection threshold in pixels)."""
    if generator is None:
        generator = torch.Generator(device=points2d.device).manual_seed(0)
    sample_idx = sample_minimal_sets(valid, num_hypotheses, generator)
    return pnp_ransac_core(points2d, points3d, cam_params, valid, sample_idx,
                           threshold, lo_iterations, min_inliers)
