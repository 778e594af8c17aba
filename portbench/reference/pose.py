"""A query's pose from 2D-3D correspondences: plain Gauss-Newton.

Pinhole camera [fx, fy, cx, cy], world→camera pose (qvec w, x, y, z;
tvec). From a starting pose: the correspondences whose reprojection error
is under the threshold are the inliers, Gauss-Newton steps minimise their
squared reprojection error, and the inliers are chosen again, ``rounds``
times. ``precision`` ``float64`` is the reference; ``tf32`` is its
control, every product's operands rounded to TF32 and summed in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import round_tf32


def rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quat(r: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(r).as_quat()[[3, 0, 1, 2]]
    return q if q[0] >= 0 else -q


def _skew(v: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([o, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], o, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], o], -1)], -2)


def _exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w)
    k = _skew(w / th.clamp(min=1e-300))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * k + (1 - torch.cos(th)) * (k @ k)


def gauss_newton(qvec, tvec, uv: np.ndarray, xyz: np.ndarray, cam, thresh: float,
                 rounds: int = 5, steps: int = 5, precision: str = "float64", device="cpu"):
    """(qvec, tvec, inliers) after `rounds` × (inlier choice, `steps`
    Gauss-Newton steps) from the pose (qvec, tvec)."""
    if precision == "float64":
        dt, mm = torch.float64, lambda a, b: a @ b
    elif precision == "tf32":
        dt, mm = torch.float32, lambda a, b: round_tf32(a) @ round_tf32(b)
    else:
        raise ValueError(precision)
    dev = torch.device(device)
    r = torch.tensor(rotmat(qvec), dtype=dt, device=dev)
    t = torch.tensor(np.asarray(tvec, np.float64), dtype=dt, device=dev)
    x = torch.from_numpy(np.asarray(xyz, np.float64)).to(dev, dt)
    uv = torch.from_numpy(np.asarray(uv, np.float64)).to(dev, dt)
    fx, fy, cx, cy = (float(c) for c in cam[:4])

    def residuals(r, t):
        xr = mm(x, r.T)
        pc = xr + t
        z = pc[:, 2]
        proj = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)
        return proj - uv, pc, xr

    inl = torch.zeros(len(x), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        res, pc, _ = residuals(r, t)
        inl = (torch.linalg.norm(res, dim=1) < thresh) & (pc[:, 2] > 0)
        if int(inl.sum()) < 6:
            break
        for _ in range(steps):
            res, pc, xr = residuals(r, t)
            res, pc, xr = res[inl], pc[inl], xr[inl]
            z = pc[:, 2]
            o = torch.zeros_like(z)
            dproj = torch.stack([torch.stack([fx / z, o, -fx * pc[:, 0] / z**2], 1),
                                 torch.stack([o, fy / z, -fy * pc[:, 1] / z**2], 1)], 1)
            dpc = torch.cat([-_skew(xr), torch.eye(3, dtype=dt, device=dev).expand(
                len(z), 3, 3)], 2)  # d pc / d (omega, t)
            jac = (dproj @ dpc).reshape(-1, 6)
            rr = res.reshape(-1)
            h = mm(jac.T, jac).double()
            g = mm(jac.T, rr[:, None])[:, 0].double()
            delta = torch.linalg.solve(h + 1e-9 * torch.eye(6, dtype=h.dtype, device=dev),
                                       -g).to(dt)
            dr = _exp(delta[:3])
            r, t = dr @ r, dr @ t + delta[3:]
    return (quat(r.double().cpu().numpy()), t.double().cpu().numpy(),
            inl.cpu().numpy())


def pose_gap(q1, t1, q2, t2) -> tuple:
    """(distance between camera centres in m, rotation angle in degrees)."""
    r1, r2 = rotmat(q1), rotmat(q2)
    c1 = -r1.T @ np.asarray(t1, np.float64)
    c2 = -r2.T @ np.asarray(t2, np.float64)
    from scipy.spatial.transform import Rotation

    angle = Rotation.from_matrix(r1 @ r2.T).magnitude()
    return float(np.linalg.norm(c1 - c2)), float(np.degrees(angle))
