"""Pose metrics and pose algebra on tensors (PyTorch, batched).

Port of ``sfd2_tpu/geometry/pose.py`` (``it_loc/common.py:298``
compute_pose_error: camera-to-world conversion, translation L2 between
camera centres, quaternion angular error), batched over leading dims so a
whole query set is scored in one call.
"""

from __future__ import annotations

import torch

from sfd2_torch.geometry.rotations import quat_angular_error_deg, qvec_to_rotmat


def invert_pose(qvec: torch.Tensor, tvec: torch.Tensor):
    """Invert COLMAP (world→cam) poses into (cam→world): (q̄, −Rᵀt, Rᵀ)."""
    rot_inv = qvec_to_rotmat(qvec).transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", rot_inv, tvec)
    # The conjugate of a unit quaternion is the inverse rotation.
    q_inv = qvec * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=qvec.dtype, device=qvec.device)
    return q_inv, t_inv, rot_inv


def camera_center(qvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """Camera centre in world coordinates: −Rᵀt."""
    return -torch.einsum("...ji,...j->...i", qvec_to_rotmat(qvec), tvec)


def pose_error(pred_qvec, pred_tvec, gt_qvec, gt_tvec):
    """(angular error in degrees, translation error in metres) between
    world→cam poses; the translation error is between camera centres."""
    t_err = torch.linalg.norm(camera_center(pred_qvec, pred_tvec)
                              - camera_center(gt_qvec, gt_tvec), dim=-1)
    # The angle between world→cam quaternions equals that between their
    # conjugates (cam→world): no conversion needed.
    return quat_angular_error_deg(pred_qvec, gt_qvec), t_err


def recall_at_thresholds(q_err_deg: torch.Tensor, t_err_m: torch.Tensor,
                         thresholds=((0.25, 2.0), (0.5, 5.0), (5.0, 10.0))) -> torch.Tensor:
    """Fraction of poses within each (metres, degrees) bound: the
    benchmark's (0.25 m, 2°) / (0.5 m, 5°) / (5 m, 10°) by default
    (``it_loc/localizer.py:83-84``). Returns float32 [len(thresholds)]."""
    return torch.stack([((t_err_m <= t_th) & (q_err_deg <= q_th)).float().mean()
                        for t_th, q_th in thresholds])
