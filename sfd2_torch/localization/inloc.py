"""RGB-D (InLoc-style) localization: depth scans → 2D-3D PnP.

Port of ``sfd2_tpu/localization/inloc.py`` (``hloc/localize_inloc.py``):
a query is matched against RGB-D database frames whose per-pixel 3D
coordinates come from aligned scans, each matched DB keypoint's 3D point
is looked up by bilinear interpolation of the scan (``interpolate_scan``,
NaN-aware: a tap on a hole invalidates the sample), the 2D-3D
correspondences of the retrieved frames are pooled, and PnP-RANSAC solves
the pose.

All retrieved frames are matched in one batched mutual-NN launch (kernel
K2 on CUDA tensors, ``ops/matching.py::batch_matcher("nnm")``): the
frames' banks are padded to the longest with invalid rows and the query is
broadcast, and since K2 treats every pair on its own a valid row's match
is the one a per-frame call gives. PnP-RANSAC samples its minimal sets
from a seeded ``torch.Generator`` (the JAX package draws them with
``jax.random``); ``rgbd_correspondences`` and ``pnp_ransac_core`` let a
caller feed any sample indices instead.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.geometry.cameras import canonicalize_params
from sfd2_torch.localization.ransac import pnp_ransac
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.utils.device import resolve_device


def interpolate_scan(scan_xyz: np.ndarray, kpts: np.ndarray):
    """Bilinearly interpolate a [H, W, 3] scan at keypoints [N, 2] (x, y).
    Returns (xyz [N, 3], valid [N]); a sample is valid only when all four
    taps are finite."""
    h, w = scan_xyz.shape[:2]
    x = np.clip(kpts[:, 0], 0, w - 1 - 1e-6)
    y = np.clip(kpts[:, 1], 0, h - 1 - 1e-6)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    c00, c01 = scan_xyz[y0, x0], scan_xyz[y0, x1]
    c10, c11 = scan_xyz[y1, x0], scan_xyz[y1, x1]
    xyz = (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
           + c10 * (1 - fx) * fy + c11 * fx * fy)
    valid = np.isfinite(np.stack([c00, c01, c10, c11], 0)).all(axis=(0, 2))
    return xyz, valid


def match_frames(q_desc: np.ndarray, db_descs: Sequence[np.ndarray], device) -> np.ndarray:
    """Mutual-NN matches of the query against each frame, in one batched
    launch: [D, N] int64, −1 for no match."""
    dev = resolve_device(device)
    n, c = q_desc.shape
    m_pad = max(len(d) for d in db_descs)
    bank = np.zeros((len(db_descs), m_pad, c), np.float32)
    valid = np.zeros((len(db_descs), m_pad), bool)
    for i, d in enumerate(db_descs):
        bank[i, :len(d)], valid[i, :len(d)] = d, True
    q = torch.from_numpy(np.ascontiguousarray(q_desc, np.float32)).to(dev)
    matches, _ = batch_matcher("nnm")(q[None].expand(len(db_descs), n, c),
                                      torch.from_numpy(bank).to(dev),
                                      None, torch.from_numpy(valid).to(dev))
    return matches.cpu().numpy().astype(np.int64)


def rgbd_correspondences(q_kpts: np.ndarray, q_desc: np.ndarray,
                         db_entries: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                         device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Pooled 2D-3D correspondences (float32 [M, 2], [M, 3]) of the query
    over the frames, in frame order and query-row order within a frame."""
    all_2d, all_3d = [np.zeros((0, 2), np.float32)], [np.zeros((0, 3), np.float32)]
    live = [e for e in db_entries if len(e[1])]
    if len(q_desc) and live:
        matches = match_frames(q_desc, [desc for _, desc, _ in live], device)
        for (kpts, _, scan), m in zip(live, matches):
            src = np.nonzero(m >= 0)[0]
            if len(src) == 0:
                continue
            xyz, valid = interpolate_scan(scan, kpts[m[src]])
            all_2d.append(q_kpts[src[valid]])
            all_3d.append(xyz[valid])
    return (np.concatenate(all_2d).astype(np.float32),
            np.concatenate(all_3d).astype(np.float32))


def pad_correspondences(p2d: np.ndarray, p3d: np.ndarray):
    """Padded (xy [P, 2], xyz [P, 3], valid [P]), P = max(64, next power of 2)."""
    n = len(p2d)
    n_pad = max(64, 1 << (n - 1).bit_length())
    xy = np.zeros((n_pad, 2), np.float32)
    pw = np.zeros((n_pad, 3), np.float32)
    va = np.zeros(n_pad, bool)
    xy[:n], pw[:n], va[:n] = p2d, p3d, True
    return xy, pw, va


def localize_rgbd(q_kpts: np.ndarray, q_desc: np.ndarray,
                  db_entries: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                  camera_model: str, camera_params, ransac_thresh: float = 48.0,
                  min_matches: int = 8, device="cuda",
                  generator: Optional[torch.Generator] = None):
    """Localize one query against RGB-D DB frames.

    q_kpts / q_desc: query keypoints [N, 2] and descriptors [N, C];
    db_entries: per retrieved frame (kpts [M, 2], desc [M, C], scan_xyz
    [H, W, 3] with NaN holes); ransac_thresh: 48 px for InLoc in the
    reference; generator: PnP-RANSAC's sampler (seeded 0 by default).
    Returns a dict with qvec, tvec, num_inliers and success."""
    dev = resolve_device(device)
    p2d, p3d = rgbd_correspondences(q_kpts, q_desc, db_entries, dev)
    if len(p2d) < min_matches:
        return {"success": False, "num_inliers": 0, "qvec": None, "tvec": None}
    cam8 = canonicalize_params(camera_model, camera_params).astype(np.float32)
    xy, pw, va = (torch.from_numpy(a).to(dev) for a in pad_correspondences(p2d, p3d))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    res = pnp_ransac(xy, pw, torch.from_numpy(cam8).to(dev), va, threshold=ransac_thresh,
                     generator=generator)
    return {"success": bool(res.success), "num_inliers": int(res.num_inliers),
            "qvec": res.qvec.double().cpu().numpy(), "tvec": res.tvec.double().cpu().numpy()}
