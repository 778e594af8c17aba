"""A query's reference pose: float64 mutual-NN matches against its
retrieved DB images, 2D-3D correspondences through the map's point rows,
then Gauss-Newton from the ground-truth pose.

The correspondences follow the localizer's rules: a matched DB keypoint
gives its map point if the point's track has at least ``obs_thresh``
observations, each (query keypoint, point) pair counts once, and query
keypoints move to COLMAP's pixel origin (+0.5), as hloc's localizer
does. The pose is the least-squares pose of the correspondences under
``thresh`` pixels: a different estimator from the program's PnP-RANSAC
and covisibility refinement, which reaches the same pose to within the
keypoint noise.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.match import bank_valid, mutual_matches, similarities
from portbench.reference.pose import gauss_newton

BANK_BLOCK = 8  # DB banks per similarity block


def correspondences(q_desc: np.ndarray, q_nv: int, q_kp: np.ndarray, db_desc: np.ndarray,
                    db_nv: np.ndarray, prow: np.ndarray, point_xyz: np.ndarray,
                    track_len: np.ndarray, obs_thresh: int, precision: str, device):
    """(uv [M, 2], xyz [M, 3]) of one query ([C, K] descriptors) against
    banks db_desc [D, C, K] with point rows prow [D, K]."""
    dev = torch.device(device)
    k = q_desc.shape[1]
    q = torch.from_numpy(np.ascontiguousarray(q_desc.T)).to(dev)
    qv = torch.arange(k, device=dev) < int(q_nv)
    bv_all = bank_valid(db_nv, prow)
    pairs = []
    for lo in range(0, len(db_desc), BANK_BLOCK):
        banks = torch.from_numpy(np.ascontiguousarray(
            db_desc[lo:lo + BANK_BLOCK].transpose(0, 2, 1))).to(dev)
        bv = torch.from_numpy(bv_all[lo:lo + BANK_BLOCK]).to(dev)
        m = mutual_matches(similarities(q, banks, qv, bv, precision)).cpu().numpy()
        for d in range(len(m)):
            qi = np.nonzero(m[d] >= 0)[0]
            rows = prow[lo + d][m[d][qi]]
            ok = (rows >= 0) & (track_len[np.maximum(rows, 0)] >= obs_thresh)
            pairs.append(np.stack([qi[ok], rows[ok]], 1))
    pairs = np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64)
    _, first = np.unique(pairs[:, 0] * (len(point_xyz) + 1) + pairs[:, 1], return_index=True)
    pairs = pairs[np.sort(first)]
    return q_kp[pairs[:, 0]].astype(np.float64) + 0.5, point_xyz[pairs[:, 1]]


def reference_pose(gt_q, gt_t, uv, xyz, cam, thresh: float, precision: str = "float64",
                   device="cpu"):
    """(qvec, tvec, inlier count) from the ground-truth pose."""
    q, t, inl = gauss_newton(gt_q, gt_t, uv, xyz, cam, thresh, precision=precision,
                             device=device)
    return q, t, int(inl.sum())
