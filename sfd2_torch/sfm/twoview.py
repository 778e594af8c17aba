"""Two-view geometric verification: batched 8-point F-RANSAC (PyTorch).

Port of ``sfd2_tpu/sfm/twoview.py`` (parity with COLMAP's
``matches_importer``, ``hloc/triangulation.py:114-125``): RANSAC
fundamental-matrix fitting over candidate matches with a Sampson-error
inlier test. Hypotheses and pairs are batch dimensions: every pair of a
batch fits H 8-point samples at once, scores all H×N Sampson distances by
MSAC, and refits the winner by weighted least squares (local
optimisation). Where the JAX package vmapped one pair's function over the
pair axis, the port's functions take the pair axis [B, ...] directly.

The 9×9 null-vector solve is the JAX package's lanes algorithm (Gram
matrix with a 1e-6 relative diagonal shift, Cholesky, 2-column inverse
subspace iteration, closed-form 2×2 Rayleigh–Ritz), written with batched
``torch.linalg`` instead of scalar-unrolled lanes; where the shifted Gram
matrix is not positive definite in float32 the result is NaN (the JAX
version clamps the pivot and returns a finite fit), and NaN fits lose.

Sampling draws Gumbel-top-8 sets from a ``torch.Generator`` (the JAX
package used ``jax.random``); ``verify_fundamental_ransac_core`` takes any
``sample_idx [B, H, 8]``, so both packages can be fed the same samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Sampson errors are scored for at most this many (pair, hypothesis,
# match) entries at a time, to bound the temporaries.
_SCORE_CHUNK = 1 << 25


class TwoViewResult(NamedTuple):
    fmatrix: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    success: torch.Tensor  # [...] bool


def _normalize_points(xy, w):
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    c = torch.sum(xy * w[:, None], dim=0) / wsum
    d = torch.sum(torch.linalg.norm(xy - c, dim=1) * w) / wsum
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * c[0]]), torch.stack([zero, s, -s * c[1]]),
                     torch.stack([zero, zero, one])])
    return (xy - c) * s, t


def _epipolar_rows(p1, p2):
    """[..., N, 9] rows of the 8-point system from normalised points."""
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def fit_fundamental(xy1, xy2, weights=None):
    """Weighted 8-point fundamental-matrix fit (≥8 effective points) of one
    pair: xy1, xy2 [N, 2] → F [3, 3] with F[2, 2] = 1."""
    n = xy1.shape[0]
    w = torch.ones(n, dtype=xy1.dtype, device=xy1.device) if weights is None else weights
    p1, t1 = _normalize_points(xy1, w)
    p2, t2 = _normalize_points(xy2, w)
    a = _epipolar_rows(p1, p2) * w[:, None]
    # SVD of A (not eigh of AᵀA: squaring the condition number is fatal in
    # float32 for the epipolar data matrix).
    _, _, vt = torch.linalg.svd(a, full_matrices=False)
    f = vt[-1].reshape(3, 3)
    u, s, vt = torch.linalg.svd(f)
    s = torch.stack([s[0], s[1], torch.zeros_like(s[2])])  # rank 2
    f = t2.T @ (u @ torch.diag(s) @ vt) @ t1
    return f / torch.where(torch.abs(f[2, 2]) < 1e-12, torch.ones_like(f[2, 2]), f[2, 2])


def sampson_error(f, xy1, xy2):
    """First-order geometric (Sampson) distance per correspondence:
    f [..., 3, 3], xy1/xy2 [..., N, 2] (leading dims broadcast) → [..., N]."""
    ones = torch.ones_like(xy1[..., :1])
    h1 = torch.cat([xy1, ones], dim=-1)
    h2 = torch.cat([xy2, ones], dim=-1)
    fx1 = h1 @ f.transpose(-1, -2)  # F · x1 per row
    ftx2 = h2 @ f  # Fᵀ · x2 per row
    num = torch.sum(h2 * fx1, dim=-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _sym3_smallest_eigvec(a):
    """Unit eigenvector of the smallest eigenvalue of symmetric 3×3
    matrices [..., 3, 3] — closed form (trigonometric eigenvalues + row
    cross products)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    b = a - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(b * b, dim=(-2, -1)) / 6.0, min=1e-30))
    bn = b / p[..., None, None]
    det = (bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 1])
           - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 0])
           + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1] - bn[..., 1, 1] * bn[..., 2, 0]))
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    c = a - lam_min[..., None, None] * eye
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)  # [..., 3, 3]
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    # Degenerate (isotropic) case: any unit vector is an eigenvector.
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device).expand(v.shape)
    return torch.where(vn > 1e-20, v / torch.clamp(vn, min=1e-30), fallback)


def _rank2_project(f):
    """Project [..., 3, 3] onto rank 2: F ← F − (F v₃) v₃ᵀ with v₃ the right
    singular vector of the smallest singular value."""
    v3 = _sym3_smallest_eigvec(f.transpose(-1, -2) @ f)
    fv3 = (f @ v3[..., None])[..., 0]
    return f - fv3[..., :, None] * v3[..., None, :]


def _smallest_eigvec_spd(m):
    """Unit vector of the smallest eigenvalue of shifted Gram matrices
    [..., n, n]: Cholesky, 4 rounds of 2-column inverse subspace iteration
    (Gram–Schmidt) from the columns 1/√n and (+1, −1, …)/√n, then the
    closed-form 2×2 Rayleigh–Ritz on their span. NaN where the Cholesky
    factorisation fails."""
    n = m.shape[-1]
    dt, dev = m.dtype, m.device
    chol, info = torch.linalg.cholesky_ex(m)
    alt = torch.tensor([1.0 if i % 2 == 0 else -1.0 for i in range(n)], dtype=dt, device=dev)
    x = (torch.stack([torch.ones(n, dtype=dt, device=dev), alt], dim=1)
         / math.sqrt(n)).expand(*m.shape[:-2], n, 2)
    for _ in range(4):
        y = torch.linalg.solve_triangular(chol, x, upper=False)
        x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
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
    sol = c0 * (v0 / vn)[..., None] + c1 * (v1 / vn)[..., None]
    return torch.where((info != 0)[..., None], float("nan"), sol)


def _shifted_gram(a):
    """AᵀA [..., n, n] of rows a [..., N, n] plus 1e-6 of its mean diagonal."""
    m = a.transpose(-1, -2) @ a
    n = m.shape[-1]
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    return m + (1e-6 * (trace / n) + 1e-30)[..., None, None] * eye


def _fit_fundamental_lanes(xy1, xy2, w):
    """Weighted 8-point fundamental fit over arbitrary leading dims: xy1,
    xy2 [..., N, 2], w [..., N] (rows scaled by w, as ``fit_fundamental``)
    → rank-2 F [..., 3, 3], Frobenius-normalised."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)

    def norm_pts(xy):
        c = torch.sum(xy * w[..., None], dim=-2) / wsum  # [..., 2]
        d = torch.sum(torch.linalg.norm(xy - c[..., None, :], dim=-1) * w, dim=-1) / wsum[..., 0]
        s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
        return (xy - c[..., None, :]) * s[..., None, None], c, s

    p1, c1, s1 = norm_pts(xy1)
    p2, c2, s2 = norm_pts(xy2)
    f_norm = _smallest_eigvec_spd(_shifted_gram(_epipolar_rows(p1, p2) * w[..., None]))
    f_norm = f_norm.reshape(*f_norm.shape[:-1], 3, 3)

    def tmat(c, s):  # Hartley transform [..., 3, 3]
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        return torch.stack([torch.stack([s, zero, -s * c[..., 0]], -1),
                            torch.stack([zero, s, -s * c[..., 1]], -1),
                            torch.stack([zero, zero, one], -1)], -2)

    f = tmat(c2, s2).transpose(-1, -2) @ f_norm @ tmat(c1, s1)
    f = _rank2_project(f)
    fn = torch.linalg.norm(f.flatten(-2), dim=-1)
    return f / torch.clamp(fn, min=1e-30)[..., None, None]


def sample_eight(valid: torch.Tensor, num_hypotheses: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, H, 8] index sets drawn without replacement ∝ `valid` [B, N]
    (Gumbel top-8 over the mask)."""
    u = torch.rand((valid.shape[0], num_hypotheses, valid.shape[1]), generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(u)) + torch.log(valid.float() + 1e-30)[:, None, :]
    return torch.topk(g, 8, dim=-1).indices


def _msac(errs, valid, thr2):
    return torch.sum(torch.where(valid, torch.clamp(errs, max=thr2), thr2), dim=-1)


def verify_fundamental_ransac_core(xy1, xy2, valid, sample_idx, threshold: float = 4.0,
                                   min_inliers: int = 15,
                                   min_inlier_ratio: float = 0.1) -> TwoViewResult:
    """F-RANSAC on given hypotheses: xy1/xy2 [B, N, 2] padded matches,
    valid [B, N] bool, sample_idx [B, H, 8]. Thresholds mirror the
    reference's colmap invocation (max_error 4, min_inlier_ratio 0.1,
    min_num_inliers 15; ``hloc/triangulation.py:118-124``)."""
    b, h = sample_idx.shape[:2]
    thr2 = threshold * threshold
    rows = torch.arange(b, device=xy1.device)[:, None, None]
    ones8 = torch.ones(sample_idx.shape, dtype=xy1.dtype, device=xy1.device)
    fs = _fit_fundamental_lanes(xy1[rows, sample_idx], xy2[rows, sample_idx], ones8)  # [B,H,3,3]

    # MSAC scoring: truncated squared error rewards tight fits, not just raw
    # counts. Scored a few pairs at a time to bound the [B, H, N] temporaries.
    step = max(1, _SCORE_CHUNK // max(h * xy1.shape[1], 1))
    msac = torch.cat([
        _msac(sampson_error(fs[i:i + step], xy1[i:i + step, None], xy2[i:i + step, None]),
              valid[i:i + step, None], thr2)
        for i in range(0, b, step)])
    finite = torch.isfinite(fs).flatten(-2).all(-1)
    msac = torch.where(finite, msac, torch.inf)
    f = fs[torch.arange(b, device=xy1.device), torch.argmin(msac, dim=-1)]

    # Local optimisation: iterative least-squares re-fit on soft-weighted
    # inliers, accepted on MSAC improvement.
    cur = _msac(sampson_error(f, xy1, xy2), valid, thr2)
    for _ in range(4):
        e = sampson_error(f, xy1, xy2)
        wts = torch.where((e <= thr2) & valid, 1.0 / (1.0 + e / thr2), 0.0).to(xy1.dtype)
        f_ls = _fit_fundamental_lanes(xy1, xy2, wts)
        ok = torch.isfinite(f_ls).flatten(-2).all(-1)
        cand = torch.where(ok, _msac(sampson_error(f_ls, xy1, xy2), valid, thr2), torch.inf)
        take = cand < cur
        f = torch.where(take[:, None, None], f_ls, f)
        cur = torch.minimum(cand, cur)

    inliers = (sampson_error(f, xy1, xy2) <= thr2) & valid
    num = inliers.sum(-1).to(torch.int32)
    n_valid = torch.clamp(valid.sum(-1), min=1)
    success = (num >= min_inliers) & (num.float() / n_valid.float() >= min_inlier_ratio)
    return TwoViewResult(fmatrix=f, inliers=inliers, num_inliers=num, success=success)


def verify_fundamental_ransac(xy1, xy2, valid, threshold: float = 4.0,
                              generator: torch.Generator | None = None,
                              num_hypotheses: int = 2048, min_inliers: int = 15,
                              min_inlier_ratio: float = 0.1) -> TwoViewResult:
    """F-RANSAC over padded matches of B pairs: xy1/xy2 [B, N, 2], valid
    [B, N] bool."""
    if generator is None:
        generator = torch.Generator(device=xy1.device).manual_seed(0)
    idx = sample_eight(valid, num_hypotheses, generator)
    return verify_fundamental_ransac_core(xy1, xy2, valid, idx, threshold, min_inliers,
                                          min_inlier_ratio)


# ---------------------------------------------------------------------------
# Essential-matrix decomposition (incremental-SfM bootstrap)
# ---------------------------------------------------------------------------


def essential_from_fundamental(f, k1, k2):
    """E = K2ᵀ F K1 with singular values normalised to (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(k2.T @ f @ k1)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=f.dtype, device=f.device)
    return u @ torch.diag(s) @ vt


def _triangulate_midpoint(norm1, norm2, rot, t):
    """Linear two-view triangulation of N points in normalised coords (cam1
    frame) for P1 = [I|0], P2 = [R|t]: the null vector of each 4×4 DLT."""
    dt, dev = rot.dtype, rot.device
    p1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    p2 = torch.cat([rot, t[:, None]], 1)
    rows = torch.stack([norm1[:, 0:1] * p1[2] - p1[0], norm1[:, 1:2] * p1[2] - p1[1],
                        norm2[:, 0:1] * p2[2] - p2[0], norm2[:, 1:2] * p2[2] - p2[1]], dim=1)
    h = torch.linalg.svd(rows)[2][:, -1]
    h3 = h[:, 3:]
    return h[:, :3] / torch.where(torch.abs(h3) < 1e-12, torch.full_like(h3, 1e-12), h3)


def decompose_essential(e, norm1, norm2, weights=None):
    """Recover (R, t̂) from E by cheirality voting over the 4 candidates.

    Args: normalised (undistorted) image coords [N, 2] in the two views.
    Returns (rot [3,3], t_unit [3], n_in_front) for the winning
    configuration — pose of view 2 w.r.t. view 1 with ‖t‖ = 1."""
    n = norm1.shape[0]
    w = torch.ones(n, dtype=norm1.dtype, device=norm1.device) if weights is None else weights
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    wmat = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=e.dtype, device=e.device)
    r_a = u @ wmat @ vt
    r_b = u @ wmat.T @ vt
    t_u = u[:, 2]
    cands = [(r_a, t_u), (r_a, -t_u), (r_b, t_u), (r_b, -t_u)]

    def count_front(rot, t):
        x1 = _triangulate_midpoint(norm1, norm2, rot, t)
        z2 = (x1 @ rot.T + t)[:, 2]
        return torch.sum(((x1[:, 2] > 0) & (z2 > 0)).to(w.dtype) * w)

    counts = torch.stack([count_front(r, t) for r, t in cands])
    best = torch.argmax(counts)
    rots = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return rots[best], ts[best], counts[best]
