"""Camera models, projection and reprojection (PyTorch, batched).

Port of ``sfd2_tpu/geometry/cameras.py``: every supported COLMAP camera
is normalised to a fixed-width parameter vector ``[fx, fy, cx, cy, k1,
k2, p1, p2]`` so projection is one branch-free batched function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from sfd2_torch.geometry.rotations import qvec_to_rotmat

# COLMAP camera models: (model_id, name, number of parameters).
CAMERA_MODELS = [
    (0, "SIMPLE_PINHOLE", 3),
    (1, "PINHOLE", 4),
    (2, "SIMPLE_RADIAL", 4),
    (3, "RADIAL", 5),
    (4, "OPENCV", 8),
    (5, "OPENCV_FISHEYE", 8),
    (6, "FULL_OPENCV", 12),
    (7, "FOV", 5),
    (8, "SIMPLE_RADIAL_FISHEYE", 4),
    (9, "RADIAL_FISHEYE", 5),
    (10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m[0]: (m[1], m[2]) for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m[1]: (m[0], m[2]) for m in CAMERA_MODELS}


@dataclasses.dataclass(frozen=True)
class Camera:
    """Host-side camera record (mirrors a COLMAP camera row)."""

    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # raw COLMAP parameter vector

    def canonical_params(self) -> np.ndarray:
        return canonicalize_params(self.model, self.params)


def canonicalize_params(model: str, params: Sequence[float]) -> np.ndarray:
    """Map any supported COLMAP parameter layout to [fx,fy,cx,cy,k1,k2,p1,p2]."""
    p = np.asarray(params, dtype=np.float64)
    out = np.zeros(8, dtype=np.float64)
    if model == "SIMPLE_PINHOLE":
        out[:4] = [p[0], p[0], p[1], p[2]]
    elif model == "PINHOLE":
        out[:4] = p[:4]
    elif model == "SIMPLE_RADIAL":
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4] = p[3]
    elif model == "RADIAL":
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4:6] = p[3:5]
    elif model == "OPENCV":
        out[:] = p[:8]
    else:
        raise ValueError(f"camera model {model!r} has no on-device projection")
    return out


def world_to_camera(points3d: torch.Tensor, qvec: torch.Tensor,
                    tvec: torch.Tensor) -> torch.Tensor:
    """World points [..., N, 3] -> camera frame, COLMAP convention R@x + t."""
    rot = qvec_to_rotmat(qvec)
    return torch.einsum("...ij,...nj->...ni", rot, points3d) + tvec[..., None, :]


def camera_depths(points3d: torch.Tensor, qvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """Z-depth of world points in the camera frame (reference calc_depth,
    ``it_loc/common.py:217``)."""
    return world_to_camera(points3d, qvec, tvec)[..., 2]


def _distort(x: torch.Tensor, y: torch.Tensor, cam: torch.Tensor):
    """Radial(+tangential) distortion in normalised coordinates; unused
    coefficients of the canonical vector are zero."""
    k1, k2, p1, p2 = cam[..., 4], cam[..., 5], cam[..., 6], cam[..., 7]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def project_points(points3d, qvec, tvec, cam_params, eps: float = 1e-8):
    """Project world points [..., N, 3] to pixels.

    Returns (xy [..., N, 2] pixel coordinates, depth [..., N] camera z)."""
    pc = world_to_camera(points3d, qvec, tvec)
    z = pc[..., 2]
    guard = torch.sign(z) * eps + (z == 0).to(z.dtype) * eps
    inv_z = 1.0 / torch.where(torch.abs(z) < eps, guard, z)
    xn = pc[..., 0] * inv_z
    yn = pc[..., 1] * inv_z
    cam = cam_params[..., None, :] if cam_params.ndim == points3d.ndim - 1 else cam_params
    xd, yd = _distort(xn, yn, cam)
    u = cam[..., 0] * xd + cam[..., 2]
    v = cam[..., 1] * yd + cam[..., 3]
    return torch.stack([u, v], dim=-1), z


def unproject_normalized(xy: torch.Tensor, cam_params: torch.Tensor, iters: int = 5):
    """Pixels -> normalised image coordinates, undistorting by a
    fixed-point iteration with a fixed count of `iters` rounds."""
    cam = cam_params[..., None, :] if cam_params.ndim == xy.ndim - 1 else cam_params
    x = (xy[..., 0] - cam[..., 2]) / cam[..., 0]
    y = (xy[..., 1] - cam[..., 3]) / cam[..., 1]
    x0, y0 = x, y
    for _ in range(iters):
        xd, yd = _distort(x, y, cam)
        x = x + (x0 - xd)
        y = y + (y0 - yd)
    return torch.stack([x, y], dim=-1)


def reprojection_errors(points3d, points2d, qvec, tvec, cam_params):
    """Per-point reprojection error [..., N] and depth (for cheirality)."""
    proj, depth = project_points(points3d, qvec, tvec, cam_params)
    return torch.linalg.norm(proj - points2d, dim=-1), depth
