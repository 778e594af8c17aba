"""Aachen-scale map-build → localize rehearsal on the card.

Port of ``scripts/bench_scale.py``. It runs the real map-building and query
path at the reference's headline scale (a ~6.7k-image Aachen database,
top-50 retrieval lists per query) on a synthetic corridor scene with
known ground truth:

  scene (5,000 DB images, 600,000 GT points, 4096 kp/img, C=128)
    → pairs_from_poses                     (sfm/pairs.py)
    → mutual-NN match in bf16 (kernel K2)  (ops/matching.py)
      + F-RANSAC verification              (sfm/twoview.py)
    → tracks                               (sfm/tracks.py, native union-find)
    → multi-view triangulation             (sfm/triangulation.py)
    → bundle adjustment (kernel K3)        (sfm/ba.py)
    → MapIndex.from_arrays                 (sfm/map_index.py)
    → localize_throughput                  (localization/engine.py),
      50 queries × top-50 retrieval, recall against the GT poses.

Every large tensor is born on the device, ``gen_b`` cameras at a time: the
bf16 descriptor banks [N_DB, KP, C], the keypoint xy [N_DB, KP, 2] and the
valid flags. Matching, verification, triangulation and BA gather from
those buffers, and the engine receives the banks through
``inject_db_features``. Points and poses come from
``np.random.default_rng(404)`` exactly as the JAX script draws them, so
the pairs and the ground truth are the same in both packages; the
descriptor bases, detection scores and noise come from ``torch.Generator``s
on the device (the JAX script draws them from ``jax.random``).

Each stage is a function of tensors and numpy arrays, so tests can call
them one at a time; ``run`` chains them and writes its record as JSON
after every stage (``--out``, by default ``chiprun_out/SCALE_torch.json``).
Unlike the JAX script, a failing stage, BA included, fails the run.

Usage (from the repository root):
  python -m sfd2_torch.scripts.bench_scale                  # full scale, on the card
  python -m sfd2_torch.scripts.bench_scale --tiny           # 60 images, 512 kp
  python -m sfd2_torch.scripts.bench_scale --tiny --device cpu
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sfd2_torch.geometry.cameras import Camera, canonicalize_params, project_points
from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.colmap_model import Image
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.localization.ransac import fold_seed
from sfd2_torch.ops.cuda_gather import gather_rows_cuda
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.scripts.bench import BATCHED_PHASES, batched_breakdown
from sfd2_torch.sfm.ba import BAProblem, bundle_adjust
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.sfm.pairs import pairs_from_poses
from sfd2_torch.sfm.tracks import build_tracks_arrays
from sfd2_torch.sfm.triangulation import triangulate_tracks
from sfd2_torch.sfm.twoview import verify_fundamental_ransac
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import counter, recording

NOISE_PX = 0.4  # keypoint noise, pixels
DESC_NOISE = 0.05  # descriptor noise before renormalising
POSE_SEED = 404  # np.random.default_rng: points, poses, BA's subsample
BASE_SEED, GEN_SEED, VERIFY_SEED = 11, 17, 23  # the device generators' seeds
QUERY_CHUNK0 = 10_000  # query chunks' generators: fold_seed(GEN_SEED, QUERY_CHUNK0 + s0)
DRAIN_WINDOW = 24  # match + verify batches in flight before the oldest is fetched


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """The JAX script's knobs (``SCALE_*`` environment variables there),
    each a flag of ``parse_args``, and its image size, which the JAX script
    fixes (1024×768, 640×480 with ``--tiny``) and no flag changes."""

    n_db: int = 5000  # DB images
    n_pts: int = 600_000  # ground-truth points
    n_q: int = 50  # queries
    topq: int = 50  # retrieved DB images per query
    pairs: int = 10  # DB pairs per image (pairs_from_poses)
    kp: int = 4096  # keypoints per image
    c: int = 128  # descriptor width
    nm: int = 1024  # matches per pair kept for verification
    hyp: int = 2048  # F-RANSAC hypotheses per pair
    gen_b: int = 50  # cameras per generator chunk
    pb: int = 16  # pairs per match + verify batch
    tri_p: int = 65_536  # tracks per triangulation chunk
    t_cap: int = 12  # observations per track, stride-sampled
    ba_max_obs: int = 4_000_000  # BA's observations, subsampled above this
    ba_cams: int = 1024  # BA's camera window, taken when the points exceed ba_max_pts
    ba_max_pts: int = 400_000
    lm_iters: int = 2
    cg_iters: int = 8
    width: int = 1024
    height: int = 768

    @property
    def span(self) -> float:
        """Corridor length in metres."""
        return max(4.0, self.n_db * 0.2)

    @property
    def cam_params(self) -> list:
        return [1200.0, 1200.0, self.width / 2.0, self.height / 2.0]


# The JAX script's --tiny preset (a CPU smoke run of seconds to a minute).
TINY = dict(n_db=60, n_pts=6000, n_q=8, topq=10, pairs=4, kp=512, c=64, nm=256, hyp=256,
            gen_b=20, pb=4, tri_p=2048, t_cap=8, width=640, height=480)


@dataclasses.dataclass
class Scene:
    """The ground truth (host) and the device-born DB features."""

    pts: np.ndarray  # [N_PTS, 3] float32
    db_q: np.ndarray  # [N_DB, 4] world→camera quaternions (w, x, y, z)
    db_t: np.ndarray  # [N_DB, 3]
    q_x: np.ndarray  # [N_Q] query positions along the corridor
    q_q: np.ndarray  # [N_Q, 4]
    q_t: np.ndarray  # [N_Q, 3]
    bank: Optional[torch.Tensor]  # [N_DB, KP, C] bf16 descriptors (freed by engine_setup)
    xy: torch.Tensor  # [N_DB, KP, 2] float32 keypoints
    valid: Optional[torch.Tensor]  # [N_DB, KP] bool (freed by engine_setup)
    db_valid: np.ndarray  # [N_DB, KP] bool
    q_kp: np.ndarray  # [N_Q, KP, 2] float32
    q_de: np.ndarray  # [N_Q, KP, C] float32 (bf16 values through float16, as the JAX script)
    q_va: np.ndarray  # [N_Q, KP] bool


def _cam8(cfg: ScaleConfig, device) -> torch.Tensor:
    return torch.from_numpy(canonicalize_params("PINHOLE", cfg.cam_params).astype(np.float32)
                            ).to(device)


def _fetch_async(t: torch.Tensor):
    """(host tensor, event): a copy of `t` to pinned host memory started on
    the current stream; wait on the event (None on the CPU) before reading."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _fetched(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return host.numpy()


# ---------------------------------------------------------------------------
# 1. scene
# ---------------------------------------------------------------------------


def make_poses(cfg: ScaleConfig, rng: np.random.Generator):
    """(pts, db_q, db_t, q_x, q_q, q_t) drawn from `rng` in the JAX script's
    order (``scripts/bench_scale.py:139-159``): points, then a pose per DB
    image along the corridor, then the query positions and poses."""
    from scipy.spatial.transform import Rotation

    span = cfg.span
    pts = np.stack([rng.uniform(-2, span + 2, cfg.n_pts), rng.uniform(-2.5, 2.5, cfg.n_pts),
                    rng.uniform(8, 15, cfg.n_pts)], 1).astype(np.float32)

    def make_pose(x, jitter):
        r = Rotation.from_rotvec(rng.normal(size=3) * jitter)
        return r.as_quat()[[3, 0, 1, 2]], -r.as_matrix() @ np.array([x, 0.0, 0.0])

    db_q, db_t = np.zeros((cfg.n_db, 4)), np.zeros((cfg.n_db, 3))
    for i in range(cfg.n_db):
        db_q[i], db_t[i] = make_pose(i * span / max(cfg.n_db - 1, 1), 0.01)
    q_x = rng.uniform(0.05 * span, 0.95 * span, cfg.n_q)
    q_q, q_t = np.zeros((cfg.n_q, 4)), np.zeros((cfg.n_q, 3))
    for i in range(cfg.n_q):
        q_q[i], q_t[i] = make_pose(q_x[i], 0.008)
    return pts, db_q, db_t, q_x, q_q, q_t


def gen_chunk(cfg: ScaleConfig, pts: torch.Tensor, base: torch.Tensor, qvecs: torch.Tensor,
              tvecs: torch.Tensor, cam8: torch.Tensor, gen: torch.Generator):
    """One chunk of cameras: project every point, keep the top-KP in-frame
    points by a random detection score, add keypoint and descriptor noise.
    Returns (bf16 descriptors [B, KP, C], xy [B, KP, 2], valid [B, KP])."""
    dev = pts.device
    xy, depth = project_points(pts, qvecs, tvecs, cam8)  # [B, N, 2], [B, N]
    w, h = cfg.width, cfg.height
    inb = ((depth > 0.1) & (xy[..., 0] > 8) & (xy[..., 0] < w - 8)
           & (xy[..., 1] > 8) & (xy[..., 1] < h - 8))
    score = torch.rand(inb.shape, generator=gen, device=dev)
    ids = torch.topk(torch.where(inb, score, -1.0), cfg.kp, dim=1).indices  # [B, KP]
    valid = torch.gather(inb, 1, ids)
    kp = torch.gather(xy, 1, ids[..., None].expand(-1, -1, 2))
    kp = kp + torch.randn(kp.shape, generator=gen, device=dev) * NOISE_PX
    de = base[ids.reshape(-1)].reshape(*ids.shape, cfg.c).float()
    de = de + torch.randn(de.shape, generator=gen, device=dev) * DESC_NOISE
    de = de / torch.clamp(torch.linalg.norm(de, dim=-1, keepdim=True), min=1e-8)
    return de.to(torch.bfloat16), kp, valid


def make_scene(cfg: ScaleConfig, device, rng: np.random.Generator) -> Scene:
    """The ground truth from `rng` and the DB features born on `device`,
    ``gen_b`` cameras per chunk, written into preallocated buffers; the
    queries' features are fetched to the host."""
    dev = resolve_device(device)
    pts, db_q, db_t, q_x, q_q, q_t = make_poses(cfg, rng)
    pts_d = torch.from_numpy(pts).to(dev)
    cam8 = _cam8(cfg, dev)
    base = torch.randn((cfg.n_pts, cfg.c), generator=torch.Generator(dev).manual_seed(BASE_SEED),
                       device=dev)
    base = (base / torch.linalg.norm(base, dim=1, keepdim=True)).to(torch.bfloat16)

    def chunks(qv, tv, seed0):
        for s0 in range(0, len(qv), cfg.gen_b):
            gen = torch.Generator(dev).manual_seed(fold_seed(GEN_SEED, seed0 + s0))
            q = torch.from_numpy(qv[s0:s0 + cfg.gen_b].astype(np.float32)).to(dev)
            t = torch.from_numpy(tv[s0:s0 + cfg.gen_b].astype(np.float32)).to(dev)
            yield s0, gen_chunk(cfg, pts_d, base, q, t, cam8, gen)

    bank = torch.empty((cfg.n_db, cfg.kp, cfg.c), dtype=torch.bfloat16, device=dev)
    xy = torch.empty((cfg.n_db, cfg.kp, 2), device=dev)
    valid = torch.empty((cfg.n_db, cfg.kp), dtype=torch.bool, device=dev)
    for s0, (de, kp, va) in chunks(db_q, db_t, 0):
        bank[s0:s0 + len(de)], xy[s0:s0 + len(de)], valid[s0:s0 + len(de)] = de, kp, va
    q_feats = [(de.to(torch.float16).float(), kp, va)
               for _, (de, kp, va) in chunks(q_q, q_t, QUERY_CHUNK0)]
    q_de, q_kp, q_va = (torch.cat(f).cpu().numpy() for f in zip(*q_feats))
    return Scene(pts=pts, db_q=db_q, db_t=db_t, q_x=q_x, q_q=q_q, q_t=q_t, bank=bank, xy=xy,
                 valid=valid, db_valid=valid.cpu().numpy(), q_kp=q_kp, q_de=q_de, q_va=q_va)


# ---------------------------------------------------------------------------
# 2. pairs
# ---------------------------------------------------------------------------


def db_name(row: int) -> str:
    return f"db/{row + 1:05d}.jpg"


def pairs_stage(cfg: ScaleConfig, db_q: np.ndarray, db_t: np.ndarray) -> np.ndarray:
    """``pairs_from_poses`` over the DB poses as image-row pairs [P, 2],
    each sorted and listed once."""
    images = {i + 1: Image(i + 1, db_q[i], db_t[i], 1, db_name(i), np.zeros((0, 2)),
                           np.zeros(0, np.int64)) for i in range(cfg.n_db)}
    name2row = {db_name(i): i for i in range(cfg.n_db)}
    prs = pairs_from_poses(images, num_matched=cfg.pairs)
    pij = np.array([[name2row[a], name2row[b]] for a, b in prs], np.int64).reshape(-1, 2)
    return np.unique(np.sort(pij, axis=1), axis=0)


# ---------------------------------------------------------------------------
# 3. match + verify
# ---------------------------------------------------------------------------


def match_candidates(cfg: ScaleConfig, bank: torch.Tensor, valid: torch.Tensor,
                     xy: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor):
    """Mutual NN of banks ii against banks jj (K2 on bf16 banks), then the
    ``nm`` first valid matches of each pair in keypoint order, as the JAX
    script takes them (``scripts/bench_scale.py:277-285``). Returns (idx,
    mj [B, NM] keypoint indices in image ii and jj, valid [B, NM], xy1,
    xy2 [B, NM, 2])."""
    kp = cfg.kp
    m, _ = batch_matcher("nnm")(bank[ii], bank[jj], valid[ii], valid[jj])
    mv = m >= 0
    order = torch.arange(kp, device=m.device, dtype=torch.float32) * 1e-6
    idx = torch.topk(torch.where(mv, 2.0, 0.0) - order, cfg.nm, dim=1).indices
    mj = torch.gather(m.clamp(min=0).long(), 1, idx)
    xyflat = xy.reshape(-1, 2)
    return (idx, mj, torch.gather(mv, 1, idx), xyflat[ii[:, None] * kp + idx],
            xyflat[jj[:, None] * kp + mj])


def match_verify(cfg: ScaleConfig, bank: torch.Tensor, valid: torch.Tensor, xy: torch.Tensor,
                 pij: np.ndarray):
    """Batches of ``pb`` pairs (``scripts/bench_scale.py:266-341``):
    ``match_candidates``, then F-RANSAC with ``hyp`` hypotheses drawn from
    one generator per batch; each batch's packed result is fetched while up
    to DRAIN_WINDOW later batches run. Returns (edges [E, 2] of flat
    keypoint ids row·KP + kp, counts)."""
    dev, kp, nm = bank.device, cfg.kp, cfg.nm
    pending = collections.deque()
    edge_i, edge_j, inlier_counts = [], [], []
    n_verified = 0

    def drain():
        nonlocal n_verified
        lo, host, event = pending.popleft()
        out = _fetched(host, event)
        idx, mj, inl = out[:, :nm], out[:, nm:2 * nm], out[:, 2 * nm:3 * nm].astype(bool)
        ninl, succ = out[:, 3 * nm], out[:, 3 * nm + 1].astype(bool)
        n_verified += int(succ.sum())
        inlier_counts.append(ninl[succ])
        rows = pij[lo:lo + len(out)]
        edge_i.append((rows[:, :1] * kp + idx)[inl])
        edge_j.append((rows[:, 1:] * kp + mj)[inl])

    for lo in range(0, len(pij), cfg.pb):
        ii = torch.from_numpy(pij[lo:lo + cfg.pb, 0]).to(dev)
        jj = torch.from_numpy(pij[lo:lo + cfg.pb, 1]).to(dev)
        idx, mj, selv, xy1, xy2 = match_candidates(cfg, bank, valid, xy, ii, jj)
        gen = torch.Generator(dev).manual_seed(fold_seed(VERIFY_SEED, lo))
        res = verify_fundamental_ransac(xy1, xy2, selv, 4.0, gen, num_hypotheses=cfg.hyp)
        inl = res.inliers & selv & res.success[:, None]
        packed = torch.cat([idx, mj, inl.long(), res.num_inliers[:, None].long(),
                            res.success[:, None].long()], 1).to(torch.int32)
        pending.append((lo, *_fetch_async(packed)))
        if len(pending) > DRAIN_WINDOW:
            drain()
    while pending:
        drain()
    edges = np.stack([np.concatenate(edge_i), np.concatenate(edge_j)], 1).astype(np.int64) \
        if edge_i else np.zeros((0, 2), np.int64)
    inliers = np.concatenate(inlier_counts) if inlier_counts else np.zeros(0)
    return edges, dict(n_pairs_verified=n_verified, n_match_edges=int(len(edges)),
                       mean_inliers_per_pair=float(inliers.mean()) if len(inliers) else 0.0)


# ---------------------------------------------------------------------------
# 4.-6. tracks (build_tracks_arrays), triangulation, map arrays
# ---------------------------------------------------------------------------


def track_tables(obs_img, obs_kp, obs_track, n_tracks: int, t_cap: int) -> dict:
    """At most ``t_cap`` observations per track, stride-sampled, as padded
    tables (``scripts/bench_scale.py:358-379``): cam, kp [n_tracks, t_cap]
    int32, mask bool, and the selected observations (t_sel, i_sel, k_sel,
    pos_sel: track, image, keypoint, slot)."""
    lens = np.bincount(obs_track, minlength=n_tracks)
    starts = np.zeros(n_tracks + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(len(obs_track)) - starts[obs_track]
    slot = (pos * t_cap) // np.maximum(lens[obs_track], 1)
    sel = np.ones(len(obs_track), bool)
    sel[1:] = (obs_track[1:] != obs_track[:-1]) | (slot[1:] != slot[:-1])
    t_sel, i_sel, k_sel = obs_track[sel], obs_img[sel], obs_kp[sel]
    new_track = np.ones(len(t_sel), bool)
    new_track[1:] = t_sel[1:] != t_sel[:-1]
    run = np.arange(len(t_sel))
    pos_sel = run - np.maximum.accumulate(np.where(new_track, run, 0))
    cam = np.zeros((n_tracks, t_cap), np.int32)
    kp = np.zeros((n_tracks, t_cap), np.int32)
    mask = np.zeros((n_tracks, t_cap), bool)
    cam[t_sel, pos_sel] = i_sel
    kp[t_sel, pos_sel] = k_sel
    mask[t_sel, pos_sel] = True
    return dict(cam=cam, kp=kp, mask=mask, t_sel=t_sel, i_sel=i_sel, k_sel=k_sel,
                pos_sel=pos_sel)


def triangulate_stage(cfg: ScaleConfig, xy: torch.Tensor, db_q: np.ndarray, db_t: np.ndarray,
                      tables: dict):
    """``triangulate_tracks`` over the track tables in chunks of ``tri_p``
    tracks, the observations gathered from the device-resident keypoints;
    every chunk's packed result is fetched after the last is launched.
    Returns (xyz [T, 3], valid [T], mean error [T], obs_ok [T, t_cap])."""
    dev = xy.device
    xyflat = xy.reshape(-1, 2)
    qv_all = torch.from_numpy(db_q.astype(np.float32)).to(dev)
    tv_all = torch.from_numpy(db_t.astype(np.float32)).to(dev)
    cam8 = _cam8(cfg, dev)
    cam, kp, mask = tables["cam"], tables["kp"], tables["mask"]
    fetches = []
    for s0 in range(0, len(cam), cfg.tri_p):
        ct = torch.from_numpy(cam[s0:s0 + cfg.tri_p]).to(dev).long()
        kt = torch.from_numpy(kp[s0:s0 + cfg.tri_p]).to(dev).long()
        mt = torch.from_numpy(mask[s0:s0 + cfg.tri_p]).to(dev)
        r = triangulate_tracks(xyflat[ct * cfg.kp + kt], mt, qv_all[ct], tv_all[ct],
                               cam8.expand(*ct.shape, 8))
        fetches.append(_fetch_async(torch.cat(
            [r.xyz, r.valid[:, None].float(), r.errors[:, None], r.obs_inlier.float()], 1)))
    out = (np.concatenate([_fetched(*f) for f in fetches]) if fetches
           else np.zeros((0, 5 + cfg.t_cap), np.float32))
    return out[:, :3], out[:, 3] > 0.5, out[:, 4], out[:, 5:] > 0.5


def map_arrays(tables: dict, xyz: np.ndarray, tvalid: np.ndarray, obs_ok: np.ndarray) -> dict:
    """The map of valid tracks and their inlier observations
    (``scripts/bench_scale.py:424-436``): f_img, f_kp, f_pt per observation,
    point_xyz [P, 3], track_len [P]."""
    t_sel, pos_sel = tables["t_sel"], tables["pos_sel"]
    final_row = np.cumsum(tvalid) - 1  # track → point row
    keep = tvalid[t_sel] & obs_ok[t_sel, pos_sel]
    f_pt = final_row[t_sel[keep]]
    n_points = int(tvalid.sum())
    return dict(f_img=tables["i_sel"][keep], f_kp=tables["k_sel"][keep], f_pt=f_pt,
                point_xyz=xyz[tvalid],
                track_len=np.bincount(f_pt, minlength=n_points).astype(np.int32))


# ---------------------------------------------------------------------------
# 7. bundle adjustment
# ---------------------------------------------------------------------------


def ba_problem(cfg: ScaleConfig, rng: np.random.Generator, arrays: dict, xy: torch.Tensor,
               db_q: np.ndarray, db_t: np.ndarray):
    """The JAX script's BA problem (``scripts/bench_scale.py:441-486``): at
    most ``ba_max_obs`` observations, subsampled with `rng`; above
    ``ba_max_pts`` points, only the observations of the first ``ba_cams``
    cameras and their points, renumbered densely. Cameras 0 and 1 fixed.
    Returns (problem, upts: the map rows of the problem's points, window
    counts)."""
    f_img, f_kp, f_pt = arrays["f_img"], arrays["f_kp"], arrays["f_pt"]
    m_all = len(f_img)
    sub = np.sort(rng.choice(m_all, cfg.ba_max_obs, replace=False)) \
        if m_all > cfg.ba_max_obs else np.arange(m_all)
    bi, bk, bp = f_img[sub], f_kp[sub], f_pt[sub]
    window = {}
    if len(np.unique(bp)) > cfg.ba_max_pts:
        inwin = bi < cfg.ba_cams
        bi, bk, bp = bi[inwin], bk[inwin], bp[inwin]
        upts, bp = np.unique(bp, return_inverse=True)
        window = dict(ba_window_cams=cfg.ba_cams, ba_window_pts=int(len(upts)))
    else:
        upts = np.arange(len(arrays["point_xyz"]))
    dev = xy.device
    ci = torch.from_numpy(bi.astype(np.int64)).to(dev)
    ki = torch.from_numpy(bk.astype(np.int64)).to(dev)
    fixed = np.zeros(cfg.n_db, bool)
    fixed[:2] = True
    problem = BAProblem(
        obs_xy=xy.reshape(-1, 2)[ci * cfg.kp + ki], obs_cam=ci.to(torch.int32),
        obs_point=torch.from_numpy(bp.astype(np.int32)).to(dev),
        obs_w=torch.ones(len(bi), device=dev),
        qvecs=torch.from_numpy(db_q.astype(np.float32)).to(dev),
        tvecs=torch.from_numpy(db_t.astype(np.float32)).to(dev),
        cam_params=_cam8(cfg, dev).expand(cfg.n_db, 8).contiguous(),
        points=torch.from_numpy(arrays["point_xyz"][upts].astype(np.float32)).to(dev),
        fixed_cams=torch.from_numpy(fixed).to(dev))
    return problem, upts, window


def ba_stage(cfg: ScaleConfig, problem: BAProblem, upts: np.ndarray, point_xyz: np.ndarray):
    """``bundle_adjust`` at ``lm_iters`` × ``cg_iters``. Returns (points
    [P, 3] float64 with the problem's rows refined, DB qvecs, tvecs, counts)."""
    res = bundle_adjust(problem, lm_iters=cfg.lm_iters, cg_iters=cfg.cg_iters)
    points = point_xyz.astype(np.float64)
    points[upts] = res.points.cpu().numpy()
    return (points, res.qvecs.cpu().numpy().astype(np.float64),
            res.tvecs.cpu().numpy().astype(np.float64),
            dict(ba_obs=int(problem.obs_cam.shape[0]), ba_points=int(len(upts)),
                 ba_initial_cost=float(res.initial_cost), ba_final_cost=float(res.final_cost)))


# ---------------------------------------------------------------------------
# 8.-10. map index, engine, localization
# ---------------------------------------------------------------------------


def map_index_stage(cfg: ScaleConfig, arrays: dict, point_xyz: np.ndarray, db_q: np.ndarray,
                    db_t: np.ndarray) -> MapIndex:
    """``MapIndex.from_arrays`` over per-image 3D-point-row tables."""
    prow = np.full((cfg.n_db, cfg.kp), -1, np.int64)
    prow[arrays["f_img"], arrays["f_kp"]] = arrays["f_pt"]
    cameras = {1: Camera(1, "PINHOLE", cfg.width, cfg.height, np.array(cfg.cam_params))}
    images = {i + 1: Image(i + 1, db_q[i], db_t[i], 1, db_name(i), np.zeros((0, 2)), None)
              for i in range(cfg.n_db)}
    return MapIndex.from_arrays(cameras, images, {i + 1: prow[i] for i in range(cfg.n_db)},
                                point_xyz, arrays["track_len"])


def query_name(qi: int) -> str:
    return f"q/{qi:03d}.jpg"


def engine_setup(cfg: ScaleConfig, map_index: MapIndex, scene: Scene, store_path: Path,
                 device) -> LocalizationEngine:
    """The queries' features written to an HDF5 store, an engine on it, and
    every DB bank injected (cast to float32 and pinned by the engine); the
    scene's bf16 banks and valid flags are freed after."""
    with FeatureStore(store_path, "w") as fs:
        for qi in range(cfg.n_q):
            nv = int(scene.q_va[qi].sum())
            fs.write(query_name(qi), ImageFeatures(
                scene.q_kp[qi][:nv], scene.q_de[qi][:nv],
                np.linspace(1, 0.5, nv, dtype=np.float32), None))
    engine = LocalizationEngine(map_index, FeatureStore(store_path, "r"),
                                LocalizerConfig(max_keypoints=cfg.kp,
                                                db_cache_images=cfg.n_db + 16), device=device)
    kp0 = np.zeros((cfg.kp, 2), np.float32)
    for i in range(cfg.n_db):
        engine.inject_db_features(i + 1, kp0, scene.bank[i], scene.db_valid[i])
    scene.bank = scene.valid = None
    return engine


def retrieval(cfg: ScaleConfig, q_x: np.ndarray) -> np.ndarray:
    """Each query's ``topq`` DB image ids nearest along the corridor."""
    pos = np.arange(cfg.n_db) * cfg.span / max(cfg.n_db - 1, 1)
    return np.argsort(np.abs(pos - q_x[:, None]), axis=1)[:, :cfg.topq] + 1


def phase_seconds(records: list, seconds: float) -> dict:
    """``batched_breakdown`` in seconds, keys ``<phase>_s``, with the
    fetched megabytes (``match_fetch_mb``)."""
    out = batched_breakdown(records, seconds)
    return {**{k[:-3] + "_s": out[k] / 1e3 for k in BATCHED_PHASES},
            "match_fetch_mb": out["match_fetch_mb"]}


def localize_stage(cfg: ScaleConfig, engine: LocalizationEngine, scene: Scene) -> dict:
    """``localize_throughput`` of every query against its retrieved DB
    images as singleton clusters; recall against the ground truth."""
    qinfo = ("PINHOLE", cfg.width, cfg.height, np.asarray(cfg.cam_params))
    retr = retrieval(cfg, scene.q_x)
    jobs = [(query_name(qi), qinfo, [[int(j)] for j in retr[qi]]) for qi in range(cfg.n_q)]
    with recording() as recs:
        t0 = time.perf_counter()
        results = engine.localize_throughput(jobs)
        seconds = time.perf_counter() - t0
    errs = np.array([pose_error(r.qvec, r.tvec, scene.q_q[i], scene.q_t[i])
                     for i, r in enumerate(results)]).reshape(-1, 2)
    q_errs, t_errs = errs[:, 0], errs[:, 1]
    return dict(queries_accepted=sum(r.source != "retrieval_fallback" for r in results),
                qps_at_scale=cfg.n_q / seconds, query_ms_at_scale=seconds / cfg.n_q * 1e3,
                recall_025m_2deg=float(np.mean((t_errs < 0.25) & (q_errs < 2.0))),
                recall_05m_5deg=float(np.mean((t_errs < 0.5) & (q_errs < 5.0))),
                med_terr_m=float(np.median(t_errs)), med_rerr_deg=float(np.median(q_errs)),
                localize_phase_s=phase_seconds(recs, seconds))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class Record:
    """The run's record, written as JSON to `path` (if given) after every
    stage: seconds, device peak memory and kernel launches per stage, and
    the stages' counts."""

    def __init__(self, cfg: ScaleConfig, device: torch.device, path: Optional[Path]):
        self.path, self.device, self.t0 = path, device, time.perf_counter()
        self.data = dict(stages_s={}, peak_mem_mb={}, launches={}, counts={}, phase="init",
                         scale=dataclasses.asdict(cfg), device=str(device))
        if device.type == "cuda":
            self.data["device_name"] = torch.cuda.get_device_name(device)

    def flush(self):
        self.data["elapsed_s"] = time.perf_counter() - self.t0
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self.data, indent=1, default=float))
            os.replace(tmp, self.path)

    @contextlib.contextmanager
    def stage(self, name: str):
        self.data["phase"] = name
        self.flush()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        k2, k3 = mutual_nn_match_cuda.launches, gather_rows_cuda.launches
        t0 = time.perf_counter()
        try:
            yield self.data["counts"]
        except BaseException as e:  # recorded, then raised: the run fails
            self.data["error"] = f"{type(e).__name__}: {e}"[:2000]
            self.flush()
            raise
        if cuda:
            torch.cuda.synchronize(self.device)
            self.data["peak_mem_mb"][name] = torch.cuda.max_memory_allocated(self.device) / 2**20
        self.data["stages_s"][name] = time.perf_counter() - t0
        self.data["launches"][name] = dict(mutual_nn_match=mutual_nn_match_cuda.launches - k2,
                                           gather_rows=gather_rows_cuda.launches - k3)
        self.flush()


MAP_BUILD_STAGES = ("pairs", "match_verify", "tracks", "triangulate", "map_arrays", "ba",
                    "map_index")


def run(cfg: ScaleConfig, device="cuda", out: Optional[Path] = None,
        workdir: Optional[Path] = None) -> dict:
    """Every stage in order; returns the record (also written to `out`).
    The query store goes to `workdir` (a temporary directory by default)."""
    dev = resolve_device(device)
    rec = Record(cfg, dev, out)
    rng = np.random.default_rng(POSE_SEED)
    with rec.stage("scene_gen") as c:
        scene = make_scene(cfg, dev, rng)
        c["db_kp_valid_frac"] = float(scene.db_valid.mean())
    with rec.stage("pairs") as c:
        pij = pairs_stage(cfg, scene.db_q, scene.db_t)
        c["n_pairs"] = int(len(pij))
    with rec.stage("match_verify") as c:
        edges, counts = match_verify(cfg, scene.bank, scene.valid, scene.xy, pij)
        c.update(counts)
    c["match_verify_pairs_per_s"] = len(pij) / rec.data["stages_s"]["match_verify"]
    with rec.stage("tracks") as c:
        obs_img, obs_kp, obs_track, n_tracks = build_tracks_arrays(cfg.n_db, cfg.kp, edges,
                                                                   min_track_length=2)
        c.update(n_tracks=int(n_tracks), n_obs=int(len(obs_img)),
                 mean_track_len=len(obs_img) / max(n_tracks, 1))
    with rec.stage("triangulate") as c:
        tables = track_tables(obs_img, obs_kp, obs_track, n_tracks, cfg.t_cap)
        xyz, tvalid, terr, obs_ok = triangulate_stage(cfg, scene.xy, scene.db_q, scene.db_t,
                                                      tables)
        c.update(n_points_triangulated=int(tvalid.sum()),
                 mean_reproj_err_px=float(terr[tvalid].mean()) if tvalid.any() else -1.0)
    with rec.stage("map_arrays") as c:
        arrays = map_arrays(tables, xyz, tvalid, obs_ok)
        c.update(n_points_final=int(len(arrays["point_xyz"])),
                 n_obs_final=int(len(arrays["f_img"])))
    with rec.stage("ba") as c:
        before = {k: counter(f"ba.{k}") for k in ("captures", "replays", "capture_ns")}
        t0 = time.perf_counter()
        problem, upts, window = ba_problem(cfg, rng, arrays, scene.xy, scene.db_q, scene.db_t)
        problem_s = time.perf_counter() - t0
        point_xyz, db_q_ba, db_t_ba, counts = ba_stage(cfg, problem, upts, arrays["point_xyz"])
        del problem
        c.update(window, **counts, ba_problem_s=problem_s,
                 ba_graph_captures=counter("ba.captures") - before["captures"],
                 ba_graph_replays=counter("ba.replays") - before["replays"],
                 ba_capture_s=(counter("ba.capture_ns") - before["capture_ns"]) / 1e9)
    with rec.stage("map_index"):
        map_index = map_index_stage(cfg, arrays, point_xyz, db_q_ba, db_t_ba)
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = Path(stack.enter_context(tempfile.TemporaryDirectory()))
        with rec.stage("engine_setup"):
            engine = engine_setup(cfg, map_index, scene, workdir / "queries.h5", dev)
        with rec.stage("localize"):
            rec.data.update(localize_stage(cfg, engine, scene))
        engine.features.close()
    rec.data["mapbuild_wall_s"] = sum(rec.data["stages_s"][k] for k in MAP_BUILD_STAGES)
    rec.data["total_wall_s"] = time.perf_counter() - rec.t0
    rec.data["phase"] = "done"
    rec.flush()
    return rec.data


def config_from_args(args: argparse.Namespace) -> ScaleConfig:
    preset = dict(TINY) if args.tiny else {}
    for f in dataclasses.fields(ScaleConfig):
        if getattr(args, f.name, None) is not None:
            preset[f.name] = getattr(args, f.name)
    return ScaleConfig(**preset)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tiny", action="store_true", help="the JAX script's CPU smoke sizes")
    for f in dataclasses.fields(ScaleConfig):
        if f.name in ("width", "height"):  # the image size is the preset's, as in the JAX script
            continue
        parser.add_argument(f"--{f.name}", type=int, default=None,
                            help=f"default {f.default} ({TINY.get(f.name, f.default)} with --tiny)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", type=Path, default=Path("chiprun_out/SCALE_torch.json"))
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(args.device)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
    rec = run(cfg, dev, args.out)
    summary = dict(metric="scale_rehearsal", n_db=cfg.n_db, nvidia_smi=smi,
                   n_points=rec["counts"]["n_points_final"],
                   mapbuild_wall_s=rec["mapbuild_wall_s"], qps_at_scale=rec["qps_at_scale"],
                   recall_025m_2deg=rec["recall_025m_2deg"])
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
