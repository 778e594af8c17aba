"""Quaternion / rotation-matrix primitives (PyTorch, batch-first).

Port of ``sfd2_tpu/geometry/rotations.py``. COLMAP conventions:
``qvec = [w, x, y, z]`` (Hamilton, scalar first) and
``x_cam = R(qvec) @ x_world + tvec``.
"""

from __future__ import annotations

import math

import torch


def qvec_to_rotmat(qvec: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    q = qvec / torch.linalg.norm(qvec, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_qvec(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w,x,y,z).

    Branch-free Shepperd-style extraction: all four candidate quaternions
    are built and the best-conditioned one is selected, so the function
    stays batched without data-dependent control flow."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def safe_div(a, b):
        return a / torch.where(b == 0, torch.ones_like(b), b)

    sw = torch.sqrt(qw2)
    cand_w = torch.stack([sw, safe_div(m21 - m12, sw), safe_div(m02 - m20, sw),
                          safe_div(m10 - m01, sw)], dim=-1)
    sx = torch.sqrt(qx2)
    cand_x = torch.stack([safe_div(m21 - m12, sx), sx, safe_div(m01 + m10, sx),
                          safe_div(m02 + m20, sx)], dim=-1)
    sy = torch.sqrt(qy2)
    cand_y = torch.stack([safe_div(m02 - m20, sy), safe_div(m01 + m10, sy), sy,
                          safe_div(m12 + m21, sy)], dim=-1)
    sz = torch.sqrt(qz2)
    cand_z = torch.stack([safe_div(m10 - m01, sz), safe_div(m02 + m20, sz),
                          safe_div(m12 + m21, sz), sz], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx).squeeze(-2) * 0.5
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] (w,x,y,z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_angular_error_deg(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angular distance in degrees between unit quaternions [..., 4]
    (2·acos(|<q1,q2>|), the reference's metric)."""
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    q2 = q2 / torch.linalg.norm(q2, dim=-1, keepdim=True)
    d = torch.clamp(torch.abs(torch.sum(q1 * q2, dim=-1)), 0.0, 1.0)
    return 2.0 * torch.arccos(d) * (180.0 / math.pi)


def rotate_points(qvec: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., N, 3] by quaternion(s) [..., 4]."""
    return torch.einsum("...ij,...nj->...ni", qvec_to_rotmat(qvec), points)
