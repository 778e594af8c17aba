"""Incremental SfM: from-scratch reconstruction with known intrinsics.

Port of ``sfd2_tpu/sfm/reconstruction.py`` (``hloc/reconstruction.py``,
the ``colmap mapper`` subprocess, ``:66-83``): initialise from the best
two-view pair, register images by PnP, triangulate new tracks, run bundle
adjustment, and keep the largest connected model (``:91-98``).

Every numeric stage is one of the port's batched device functions —
F-RANSAC verification, the E-decomposition bootstrap, PnP-RANSAC
registration, multi-view triangulation and Schur-complement BA (kernel
K3) — with only the registration order and bookkeeping on the host.
Registration draws its PnP samples from a generator seeded with the
number of registered images (the JAX package used
``jax.random.PRNGKey(len(poses))``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.geometry.cameras import Camera, canonicalize_params
from sfd2_torch.geometry.rotations import rotmat_to_qvec
from sfd2_torch.io.colmap_model import Image, Point3D
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.localization.ransac import pnp_ransac
from sfd2_torch.sfm.ba import BAProblem, bundle_adjust
from sfd2_torch.sfm.pipeline import TriangulationConfig, geometric_verification
from sfd2_torch.sfm.stats import analyze_model
from sfd2_torch.sfm.tracks import build_tracks
from sfd2_torch.sfm.triangulation import triangulate_tracks
from sfd2_torch.sfm.twoview import decompose_essential, essential_from_fundamental, fit_fundamental
from sfd2_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ReconstructionConfig:
    tri: TriangulationConfig = dataclasses.field(default_factory=TriangulationConfig)
    pnp_threshold: float = 8.0
    min_reg_inliers: int = 12
    ba_every: int = 3  # run global BA every N registrations
    ba_lm_iters: int = 6
    max_track_length: int = 32


def _k_matrix(cam8: np.ndarray) -> np.ndarray:
    return np.array([[cam8[0], 0, cam8[2]], [0, cam8[1], cam8[3]], [0, 0, 1.0]], np.float64)


def incremental_reconstruction(features: FeatureStore, matches: MatchStore,
                               pairs: Sequence[Tuple[str, str]],
                               cameras_by_name: Dict[str, Camera],
                               cfg: ReconstructionConfig = ReconstructionConfig(),
                               device="cuda"):
    """Returns (cameras, images, points3d, stats) — a COLMAP-style model
    in the gauge of the initial pair (first camera at identity, unit
    baseline)."""
    dev = resolve_device(device)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    names = sorted({n for p in pairs for n in p})
    name_id = {n: i + 1 for i, n in enumerate(names)}
    id_to_name = {v: k for k, v in name_id.items()}
    kps = {n: features.read(n).keypoints + 0.5 for n in names}
    cam8 = {n: canonicalize_params(cameras_by_name[n].model,
                                   cameras_by_name[n].params).astype(np.float32) for n in names}

    verified = geometric_verification(features, matches, pairs, cfg.tri, device=dev)
    if not verified:
        raise RuntimeError("no verified pairs")
    tracks = build_tracks({name_id[n]: len(kps[n]) for n in names},
                          [(name_id[a], name_id[b], m) for a, b, m in verified],
                          min_track_length=2)
    # Observation lookup: (image_id, kp_idx) → track index.
    obs_to_track: Dict[Tuple[int, int], int] = {}
    for ti, tr in enumerate(tracks):
        for iid, k in tr:
            obs_to_track[(iid, k)] = ti

    # ---- bootstrap from the best verified pair -------------------------
    verified.sort(key=lambda v: -len(v[2]))
    init = None
    for n0, n1, m in verified:
        if len(m) < 30:
            break
        xy1, xy2 = kps[n0][m[:, 0]], kps[n1][m[:, 1]]
        k1, k2 = _k_matrix(cam8[n0]), _k_matrix(cam8[n1])
        e = essential_from_fundamental(fit_fundamental(t32(xy1), t32(xy2)), t32(k1), t32(k2))
        nrm1 = (np.concatenate([xy1, np.ones((len(xy1), 1))], 1) @ np.linalg.inv(k1).T)[:, :2]
        nrm2 = (np.concatenate([xy2, np.ones((len(xy2), 1))], 1) @ np.linalg.inv(k2).T)[:, :2]
        rot, t, n_front = decompose_essential(e, t32(nrm1), t32(nrm2))
        if float(n_front) > 0.8 * len(m):
            init = (n0, n1, rot, t.cpu().numpy().astype(np.float64))
            break
    if init is None:
        raise RuntimeError("no valid initial pair")
    n0, n1, rot01, t01 = init
    logger.info("init pair: %s ↔ %s", n0, n1)

    # Registered poses (world = cam of n0).
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        name_id[n0]: (np.array([1.0, 0, 0, 0]), np.zeros(3)),
        name_id[n1]: (rotmat_to_qvec(rot01).cpu().numpy(), t01),
    }
    point_xyz: Dict[int, np.ndarray] = {}  # track idx → xyz

    def triangulate_ready_tracks():
        """(Re)triangulate all tracks with ≥2 registered observations."""
        todo = [ti for ti, tr in enumerate(tracks) if sum(1 for iid, _ in tr if iid in poses) >= 2]
        if not todo:
            return
        t_max, p = cfg.max_track_length, len(todo)
        obs = np.zeros((p, t_max, 2), np.float32)
        mask = np.zeros((p, t_max), bool)
        qv = np.zeros((p, t_max, 4), np.float32)
        qv[..., 0] = 1
        tv = np.zeros((p, t_max, 3), np.float32)
        cm = np.ones((p, t_max, 8), np.float32)
        for pi, ti in enumerate(todo):
            oi = 0
            for iid, k in tracks[ti]:
                if iid not in poses or oi >= t_max:
                    continue
                nm = id_to_name[iid]
                obs[pi, oi] = kps[nm][k]
                mask[pi, oi] = True
                qv[pi, oi] = poses[iid][0]
                tv[pi, oi] = poses[iid][1]
                cm[pi, oi] = cam8[nm]
                oi += 1
        res = triangulate_tracks(t32(obs), torch.from_numpy(mask).to(dev), t32(qv), t32(tv),
                                 t32(cm), max_reproj_error=cfg.tri.max_reproj_error,
                                 min_tri_angle_deg=cfg.tri.min_tri_angle_deg)
        val = res.valid.cpu().numpy()
        xyz = res.xyz.cpu().numpy()
        for pi, ti in enumerate(todo):
            if val[pi]:
                point_xyz[ti] = xyz[pi]
            else:
                point_xyz.pop(ti, None)

    def run_ba():
        reg = sorted(poses.keys())
        cam_row = {iid: i for i, iid in enumerate(reg)}
        pt_ids = sorted(point_xyz.keys())
        if len(pt_ids) < 8:
            return
        o_xy, o_c, o_p = [], [], []
        for row, ti in enumerate(pt_ids):
            for iid, k in tracks[ti]:
                if iid in poses:
                    o_xy.append(kps[id_to_name[iid]][k])
                    o_c.append(cam_row[iid])
                    o_p.append(row)
        fixed = np.zeros(len(reg), bool)
        fixed[:2] = True  # gauge: the first camera and a second anchor fix the scale
        problem = BAProblem(
            obs_xy=t32(o_xy), obs_cam=torch.tensor(o_c, dtype=torch.int32, device=dev),
            obs_point=torch.tensor(o_p, dtype=torch.int32, device=dev),
            obs_w=torch.ones(len(o_xy), device=dev),
            qvecs=t32([poses[i][0] for i in reg]), tvecs=t32([poses[i][1] for i in reg]),
            cam_params=t32([cam8[id_to_name[i]] for i in reg]),
            points=t32([point_xyz[t] for t in pt_ids]),
            fixed_cams=torch.from_numpy(fixed).to(dev))
        res = bundle_adjust(problem, lm_iters=cfg.ba_lm_iters, cg_iters=15)
        q_out = res.qvecs.cpu().numpy().astype(np.float64)
        t_out = res.tvecs.cpu().numpy().astype(np.float64)
        p_out = res.points.cpu().numpy().astype(np.float64)
        for i, iid in enumerate(reg):
            poses[iid] = (q_out[i], t_out[i])
        for i, ti in enumerate(pt_ids):
            point_xyz[ti] = p_out[i]

    triangulate_ready_tracks()
    run_ba()

    # ---- incremental registration --------------------------------------
    n_since_ba = 0
    while True:
        # Next image = most visible triangulated points.
        best_name, best_obs = None, []
        for nm in names:
            iid = name_id[nm]
            if iid in poses:
                continue
            obs2d3d = [(k, obs_to_track[(iid, k)]) for k in range(len(kps[nm]))
                       if (iid, k) in obs_to_track and obs_to_track[(iid, k)] in point_xyz]
            if len(obs2d3d) > len(best_obs):
                best_name, best_obs = nm, obs2d3d
        if best_name is None or len(best_obs) < cfg.min_reg_inliers:
            break
        n = len(best_obs)
        n_pad = max(64, 1 << (n - 1).bit_length())
        xy_p = np.zeros((n_pad, 2), np.float32)
        p3_p = np.zeros((n_pad, 3), np.float32)
        va = np.zeros(n_pad, bool)
        xy_p[:n] = [kps[best_name][k] for k, _ in best_obs]
        p3_p[:n] = [point_xyz[t] for _, t in best_obs]
        va[:n] = True
        res = pnp_ransac(t32(xy_p), t32(p3_p), t32(cam8[best_name]),
                         torch.from_numpy(va).to(dev), threshold=cfg.pnp_threshold,
                         generator=torch.Generator(device=dev).manual_seed(len(poses)))
        success, num_inliers = bool(res.success), int(res.num_inliers)
        if not success or num_inliers < cfg.min_reg_inliers:
            logger.info("registration failed for %s", best_name)
            names = [nm for nm in names if nm != best_name]  # skip permanently
            continue
        poses[name_id[best_name]] = (res.qvec.cpu().numpy().astype(np.float64),
                                     res.tvec.cpu().numpy().astype(np.float64))
        logger.info("registered %s (%d inliers)", best_name, num_inliers)
        triangulate_ready_tracks()
        n_since_ba += 1
        if n_since_ba >= cfg.ba_every:
            run_ba()
            n_since_ba = 0

    run_ba()
    triangulate_ready_tracks()

    # ---- assemble model -------------------------------------------------
    points3d: Dict[int, Point3D] = {}
    img_p3d = {iid: np.full(len(kps[id_to_name[iid]]), -1, np.int64) for iid in poses}
    pid = 1
    for ti, xyz in point_xyz.items():
        obs_list = [(iid, k) for iid, k in tracks[ti] if iid in poses]
        if len(obs_list) < 2:
            continue
        points3d[pid] = Point3D(pid, np.asarray(xyz, np.float64), np.zeros(3, np.uint8), 0.0,
                                np.array([o[0] for o in obs_list], np.int32),
                                np.array([o[1] for o in obs_list], np.int32))
        for iid, k in obs_list:
            img_p3d[iid][k] = pid
        pid += 1

    cameras, images = {}, {}
    for iid, (q, t) in poses.items():
        nm = id_to_name[iid]
        cam = cameras_by_name[nm]
        cameras[cam.camera_id] = cam
        images[iid] = Image(iid, q, t, cam.camera_id, nm, kps[nm], img_p3d[iid])
    return cameras, images, points3d, analyze_model(cameras, images, points3d)
