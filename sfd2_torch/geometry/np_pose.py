"""Tiny numpy pose helpers for host-side orchestration loops.

Own copy of ``sfd2_tpu/geometry/np_pose.py`` (the port imports nothing of
the JAX package). Semantics identical to the tensor versions.
"""

from __future__ import annotations

import numpy as np


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def camera_center(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    return -qvec_to_rotmat(qvec).T @ np.asarray(tvec, float)


def pose_error(pred_qvec, pred_tvec, gt_qvec, gt_tvec):
    """(deg, meters) — same metric as it_loc/common.py:298."""
    t_err = float(np.linalg.norm(camera_center(pred_qvec, pred_tvec) - camera_center(gt_qvec, gt_tvec)))
    q1 = np.asarray(pred_qvec, float)
    q2 = np.asarray(gt_qvec, float)
    d = abs(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2)))
    q_err = float(2 * np.degrees(np.arccos(min(1.0, d))))
    return q_err, t_err
