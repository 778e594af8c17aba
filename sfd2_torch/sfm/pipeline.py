"""Map building: features + matches + known poses → triangulated 3D model.

Port of ``sfd2_tpu/sfm/pipeline.py`` (``hloc/triangulation.py`` end to
end): ``create_empty_model:18`` (keep cameras and poses, strip
observations), feature and match import (+0.5 px COLMAP origin shift,
``:64``), ``geometric_verification:114`` (batched F-RANSAC on the device
instead of the colmap matches_importer subprocess), ``run_triangulation:
129`` (track building + batched fixed-pose triangulation instead of the
colmap point_triangulator subprocess) and the model_analyzer stats file.

Pairs are verified in device batches of ``verify_batch``; tracks are
bucketed by padded length (powers of two) and each bucket triangulates in
one call.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.geometry.cameras import canonicalize_params
from sfd2_torch.io.colmap_model import Image, Point3D, read_model, write_model
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.sfm.stats import analyze_model, format_stats
from sfd2_torch.sfm.tracks import build_tracks
from sfd2_torch.sfm.triangulation import triangulate_tracks
from sfd2_torch.sfm.twoview import verify_fundamental_ransac
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import span


@dataclasses.dataclass
class TriangulationConfig:
    verify_threshold: float = 4.0  # colmap max_error default
    verify_min_inliers: int = 15
    verify_min_inlier_ratio: float = 0.1  # reference flag (triangulation.py:123)
    max_reproj_error: float = 4.0
    min_tri_angle_deg: float = 1.5
    min_track_length: int = 2
    max_track_length: int = 64  # longer tracks truncated (obs beyond dropped)
    verify_batch: int = 32


def _pad_pow2(n: int, lo: int = 64) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def geometric_verification(features: FeatureStore, matches: MatchStore,
                           pairs: Sequence[Tuple[str, str]],
                           cfg: TriangulationConfig = TriangulationConfig(),
                           max_matches: int = 1024,
                           device="cuda") -> List[Tuple[str, str, np.ndarray]]:
    """Verify candidate pairs; returns (name0, name1, inlier kp-idx pairs).

    Pairs are grouped into device batches of padded match arrays — one
    batched F-RANSAC per group. Each group draws its samples from a
    generator seeded with the number of pairs verified before it.

    Spans (``utils/profiling.py``), one ``verify.batch`` per group (tags
    ``pairs``, ``matches``) holding ``verify.prep`` (the host's padding and
    the upload), ``verify.ransac`` (the enqueue; F-RANSAC tags it with
    ``hypotheses``) and ``verify.fetch`` (the wait, and the inlier masks
    back)."""
    dev = resolve_device(device)
    results: List[Tuple[str, str, np.ndarray]] = []
    kp_cache: Dict[str, np.ndarray] = {}

    def kpts(name):
        if name not in kp_cache:
            kp_cache[name] = np.asarray(features.read(name).keypoints, np.float32)
        return kp_cache[name]

    batch = []  # (name0, name1, idx_pairs [n, 2]) of the pending group
    # One host buffer for every group (the upload has read it before the
    # next group fills it): both views' points, then the mask.
    xy = np.zeros((2, cfg.verify_batch, max_matches, 2), np.float32)
    val = np.zeros((cfg.verify_batch, max_matches), bool)

    def flush():
        if not batch:
            return
        nb = len(batch)
        with span("verify.batch", pairs=nb, matches=sum(len(m) for *_, m in batch)):
            with span("verify.prep"):
                for bi, (n0, n1, idx_pairs) in enumerate(batch):
                    n = len(idx_pairs)
                    np.take(kpts(n0), idx_pairs[:, 0], axis=0, out=xy[0, bi, :n])
                    np.take(kpts(n1), idx_pairs[:, 1], axis=0, out=xy[1, bi, :n])
                    xy[:, bi, n:] = 0.0
                    val[bi, :n] = True
                    val[bi, n:] = False
                xy_d = torch.from_numpy(np.ascontiguousarray(xy[:, :nb])).to(dev)
                val_d = torch.from_numpy(val[:nb]).to(dev)
            with span("verify.ransac"):
                gen = torch.Generator(device=dev).manual_seed(len(results))
                res = verify_fundamental_ransac(
                    xy_d[0], xy_d[1], val_d, cfg.verify_threshold, gen,
                    min_inliers=cfg.verify_min_inliers,
                    min_inlier_ratio=cfg.verify_min_inlier_ratio)
            with span("verify.fetch"):
                packed = torch.cat([res.success[:, None], res.inliers], dim=1).cpu().numpy()
        for bi, (n0, n1, idx_pairs) in enumerate(batch):
            if packed[bi, 0]:
                results.append((n0, n1, idx_pairs[packed[bi, 1:1 + len(idx_pairs)]]))
        batch.clear()

    for n0, n1 in pairs:
        m, _ = matches.read(n0, n1, with_scores=False)
        src = np.nonzero(m >= 0)[0]
        if len(src) < 8:
            continue
        batch.append((n0, n1, np.stack([src, m[src]], axis=1)[:max_matches]))
        if len(batch) >= cfg.verify_batch:
            flush()
    flush()
    return results


def triangulate_map(reference_model_dir, features: FeatureStore, matches: MatchStore,
                    pairs: Sequence[Tuple[str, str]], output_dir=None,
                    cfg: TriangulationConfig = TriangulationConfig(), device="cuda"):
    """Full map build against reference poses. Returns (cameras, images,
    points3d, stats) and optionally writes the COLMAP model + stats."""
    dev = resolve_device(device)
    cameras, ref_images, _ = read_model(reference_model_dir)
    name_to_id = {im.name: iid for iid, im in ref_images.items()}

    verified = geometric_verification(features, matches, pairs, cfg, device=dev)
    verified_ids = [(name_to_id[n0], name_to_id[n1], m) for n0, n1, m in verified
                    if n0 in name_to_id and n1 in name_to_id]

    # COLMAP convention: +0.5 px origin shift on import (hloc/triangulation.py:64).
    kp_all: Dict[int, np.ndarray] = {iid: features.read(im.name).keypoints + 0.5
                                     for iid, im in ref_images.items()}
    tracks = build_tracks({iid: len(kp_all[iid]) for iid in ref_images}, verified_ids,
                          min_track_length=cfg.min_track_length)

    # Per-image tables, and every kept observation as flat (track, slot,
    # image row, keypoint) arrays.
    iids = sorted(ref_images)
    row_of = {iid: r for r, iid in enumerate(iids)}
    kp_off = np.concatenate([[0], np.cumsum([len(kp_all[i]) for i in iids])])
    kp_table = (np.concatenate([kp_all[i] for i in iids]) if iids
                else np.zeros((0, 2))).astype(np.float32)

    def cam8(iid):
        cam = cameras[ref_images[iid].camera_id]
        return canonicalize_params(cam.model, cam.params)

    cam_table = np.array([cam8(i) for i in iids], np.float32).reshape(-1, 8)
    q_table = np.array([ref_images[i].qvec for i in iids], np.float32).reshape(-1, 4)
    t_table = np.array([ref_images[i].tvec for i in iids], np.float32).reshape(-1, 3)
    lens = np.array([min(len(tr), cfg.max_track_length) for tr in tracks], np.int64)
    obs = np.array([(row_of[iid], k) for tr in tracks for iid, k in tr[:cfg.max_track_length]],
                   np.int64).reshape(-1, 2)
    obs_track = np.repeat(np.arange(len(tracks)), lens)
    obs_slot = np.arange(len(obs)) - np.repeat(np.cumsum(lens) - lens, lens)
    obs_row, obs_kp = obs[:, 0], obs[:, 1]

    t_pad_of = np.array([_pad_pow2(int(n), lo=4) for n in lens], np.int64)
    xyz_out = np.zeros((len(tracks), 3), np.float64)
    err_out = np.zeros(len(tracks))
    valid_out = np.zeros(len(tracks), bool)
    inlier_out = np.zeros(len(obs), bool)
    for t_pad in sorted(set(t_pad_of.tolist())):
        tids = np.nonzero(t_pad_of == t_pad)[0]
        pos = np.full(len(tracks), -1, np.int64)
        pos[tids] = np.arange(len(tids))
        sel = np.nonzero(pos[obs_track] >= 0)[0]
        pi, oi, rows = pos[obs_track[sel]], obs_slot[sel], obs_row[sel]
        p = len(tids)
        xy = np.zeros((p, t_pad, 2), np.float32)
        mask = np.zeros((p, t_pad), bool)
        qv = np.zeros((p, t_pad, 4), np.float32)
        qv[..., 0] = 1.0
        tv = np.zeros((p, t_pad, 3), np.float32)
        cm = np.ones((p, t_pad, 8), np.float32)
        xy[pi, oi] = kp_table[kp_off[rows] + obs_kp[sel]]
        mask[pi, oi] = True
        qv[pi, oi] = q_table[rows]
        tv[pi, oi] = t_table[rows]
        cm[pi, oi] = cam_table[rows]
        res = triangulate_tracks(*(torch.from_numpy(a).to(dev) for a in (xy, mask, qv, tv, cm)),
                                 max_reproj_error=cfg.max_reproj_error,
                                 min_tri_angle_deg=cfg.min_tri_angle_deg)
        xyz_out[tids] = res.xyz.cpu().numpy()
        err_out[tids] = res.errors.cpu().numpy()
        valid_out[tids] = res.valid.cpu().numpy()
        inlier_out[sel] = res.obs_inlier.cpu().numpy()[pi, oi]

    # Assemble the output model.
    points3d: Dict[int, Point3D] = {}
    img_p3d = {iid: np.full(len(kp_all[iid]), -1, np.int64) for iid in ref_images}
    starts = np.cumsum(lens) - lens
    pid = 1
    for ti in np.nonzero(valid_out)[0].tolist():
        s = slice(starts[ti], starts[ti] + lens[ti])
        keep = inlier_out[s]
        if keep.sum() < cfg.min_track_length:
            continue
        im_ids = np.array([iids[r] for r in obs_row[s][keep]], np.int32)
        kps = obs_kp[s][keep].astype(np.int32)
        points3d[pid] = Point3D(pid, xyz_out[ti], np.zeros(3, np.uint8), float(err_out[ti]),
                                im_ids, kps)
        for iid, k in zip(im_ids.tolist(), kps.tolist()):
            img_p3d[iid][k] = pid
        pid += 1

    images = {iid: Image(iid, im.qvec, im.tvec, im.camera_id, im.name, kp_all[iid], img_p3d[iid])
              for iid, im in ref_images.items()}
    stats = analyze_model(cameras, images, points3d)
    if output_dir is not None:
        out = Path(output_dir)
        write_model(cameras, images, points3d, out, ext=".bin")
        (out / "statics.txt").write_text(format_stats(stats) + "\n")
    return cameras, images, points3d, stats
