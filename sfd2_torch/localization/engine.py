"""Hierarchical localization engine (it_loc semantics) on one device.

Port of ``sfd2_tpu/localization/engine.py``, the sequential query path:
``localize`` = per-cluster 2D-3D matching, PnP-RANSAC, per-DB-image
consensus gates, covisibility refinement and graded fallbacks
(``it_loc/localize_cv2.py:652``), with ``refine_covisibility`` =
frame expansion, re-matching, radius gate and iterative re-selection +
LM (``:236``).

All candidate DB banks of a round are stacked [D, K, C] on the device
(D bucketed, so 50 retrieved frames run as 64 banks, the padding banks
all-invalid) and matched against the query in one launch of kernel K2;
the query is broadcast with a batch stride of 0, not copied. PnP and
refinement run on the device; graph work stays on the host
(``MapIndex``). Each device result is fetched with one transfer. The
engine is single-threaded; ``localize_many``, ``localize_throughput`` and
the sharded multi-device matcher of the JAX engine are not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.geometry.cameras import canonicalize_params
from sfd2_torch.geometry.np_pose import qvec_to_rotmat
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization.pnp import refine_pose_iterative
from sfd2_torch.localization.ransac import pnp_ransac
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.utils.device import resolve_device

_D_BUCKETS = (1, 4, 8, 16, 32, 64, 128)


def _bucket(d: int) -> int:
    for b in _D_BUCKETS:
        if d <= b:
            return b
    return ((d + 127) // 128) * 128


def _np_project(points3d, qvec, tvec, cam8):
    rot = qvec_to_rotmat(np.asarray(qvec, float))
    pc = points3d @ rot.T + np.asarray(tvec, float)
    z = np.where(np.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    x, y = pc[:, 0] / z, pc[:, 1] / z
    k1, k2, p1, p2 = cam8[4:8]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([cam8[0] * xd + cam8[2], cam8[1] * yd + cam8[3]], axis=1), z


@dataclasses.dataclass
class LocalizerConfig:
    """Per-dataset knobs (defaults = Aachen, ``test_aachenv_1_1:54-80``)."""

    ransac_thresh: float = 15.0
    opt_thresh: float = 15.0
    inlier_thresh: int = 10
    covisibility_frame: int = 50
    iters: int = 5
    radius: float = 30.0
    obs_thresh: int = 3
    opt_type: str = "clurefobs"  # clu|ref|obs|pos flags, reference-style
    do_covisibility_opt: bool = True
    max_keypoints: int = 4096
    num_hypotheses: int = 1024
    matcher: str = "nnm"  # nnm | nnml (label-aware, it_loc/matcher.py:239)
    pnp_pad_floor: int = 64  # floor of the padded correspondence count
    db_cache_images: int = 1024  # LRU capacity of the host and device bank caches


@dataclasses.dataclass
class QueryResult:
    qvec: np.ndarray
    tvec: np.ndarray
    num_inliers: int
    log: str = ""
    source: str = ""  # accepted | best_fallback | retrieval_fallback


class LocalizationEngine:
    def __init__(self, map_index: MapIndex, feature_store: FeatureStore,
                 config: LocalizerConfig = LocalizerConfig(), device="cuda"):
        self.map = map_index
        self.features = feature_store
        self.cfg = config
        self.device = resolve_device(device)
        self._db_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._db_dev_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._dev_zero_entry = None
        self._matcher = batch_matcher(config.matcher)
        self._label_aware = config.matcher == "nnml"

    # ------------------------------------------------------------------
    def _db_feats(self, image_id: int):
        """Padded (kp, desc, valid3d, p3d_rows, labels) of a DB image, LRU-cached."""
        name = self.map.images[image_id].name
        if name in self._db_cache:
            self._db_cache.move_to_end(name)
            return self._db_cache[name]
        k = self.cfg.max_keypoints
        kp, desc, _, valid, labels = self.features.read_padded(name, k, with_labels=True)
        prow_full = self.map.p3d_rows_per_image[self.map.image_row[image_id]]
        prow = np.full(k, -1, np.int64)
        n = min(len(prow_full), k)
        prow[:n] = prow_full[:n]
        entry = (kp, desc, valid & (prow >= 0), prow, labels)
        self._db_cache[name] = entry
        if len(self._db_cache) > self.cfg.db_cache_images:
            self._db_cache.popitem(last=False)
        return entry

    def _db_feats_dev(self, image_id: int):
        """Device-resident (desc [K,C], valid3d [K], labels [K]) of a DB image,
        uploaded once and LRU-cached; the reference's ≤3-valid bail-out
        (it_loc/localize_cv2.py:530) is baked into the mask."""
        name = self.map.images[image_id].name
        if name in self._db_dev_cache:
            self._db_dev_cache.move_to_end(name)
            return self._db_dev_cache[name]
        _, desc, valid3d, _, labels = self._db_feats(image_id)
        v = valid3d if valid3d.sum() > 3 else np.zeros_like(valid3d)
        dev = self.device
        entry = (torch.from_numpy(desc).to(dev), torch.from_numpy(v).to(dev),
                 torch.from_numpy(labels).to(dev) if self._label_aware else None)
        self._db_dev_cache[name] = entry
        if len(self._db_dev_cache) > self.cfg.db_cache_images:
            self._db_dev_cache.popitem(last=False)
        return entry

    def _dev_zero(self, c: int):
        """All-invalid padding bank for slots past len(db_ids)."""
        if self._dev_zero_entry is None or self._dev_zero_entry[0].shape[1] != c:
            k, dev = self.cfg.max_keypoints, self.device
            self._dev_zero_entry = (
                torch.zeros((k, c), device=dev), torch.zeros(k, dtype=torch.bool, device=dev),
                torch.zeros(k, dtype=torch.int32, device=dev) if self._label_aware else None)
        return self._dev_zero_entry

    def _match_query_to_dbs(self, q_desc, q_valid, db_ids: Sequence[int], q_labels=None):
        """One batched mutual-NN launch of the query against every candidate
        DB bank, DB rows restricted to keypoints with 3D points. Returns
        matches [D, K] int64 (−1 for no match)."""
        d_pad = _bucket(len(db_ids))
        c = q_desc.shape[1]
        entries = [self._db_feats_dev(iid) for iid in db_ids]
        entries += [self._dev_zero(c)] * (d_pad - len(db_ids))
        bank = torch.stack([e[0] for e in entries])
        bval = torch.stack([e[1] for e in entries])
        q = q_desc.to(bank.dtype)[None].expand(d_pad, *q_desc.shape)
        qv = q_valid[None].expand(d_pad, q_valid.shape[0])
        if self._label_aware:
            ql = q_labels[None].expand(d_pad, q_labels.shape[0])
            matches, _ = self._matcher(q, bank, qv, bval, ql,
                                       torch.stack([e[2] for e in entries]))
        else:
            matches, _ = self._matcher(q, bank, qv, bval)
        return matches[: len(db_ids)].cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------------
    def _assemble_2d3d(self, kpq, matches, db_ids, obs_th: int, dedup: Dict[int, set],
                       gate_pose: Optional[tuple] = None, cam8=None, radius: float = 0.0):
        """2D-3D correspondences with first-occurrence (qid, p3d) dedup in DB
        order, track-length filter and optional reprojection-radius gate
        (``match_cluster_2D:563`` + the refinement gate ``:341-350``)."""
        all_q, all_p = [], []
        per_db: Dict[int, np.ndarray] = {}
        for di, iid in enumerate(db_ids):
            _, _, _, prow, _ = self._db_feats(iid)
            m = matches[di]
            qidx = np.nonzero(m >= 0)[0]
            rows = prow[m[qidx]]
            ok = rows >= 0
            qidx, rows = qidx[ok], rows[ok]
            ok = self.map.track_len[rows] >= obs_th
            qidx, rows = qidx[ok], rows[ok]
            per_db[iid] = np.stack([qidx, rows], 1) if len(qidx) else np.zeros((0, 2), np.int64)
            all_q.append(qidx)
            all_p.append(rows)

        if not all_q or sum(len(a) for a in all_q) == 0:
            return (np.zeros((0, 3)), np.zeros((0, 2)), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), per_db)
        q_cat = np.concatenate(all_q).astype(np.int64)
        p_cat = np.concatenate(all_p).astype(np.int64)
        keys = q_cat * (self.map.incidence.shape[1] + 1) + p_cat
        if dedup:
            prior = np.array([pr in dedup.get(int(qi), ()) for qi, pr in zip(q_cat, p_cat)])
        else:
            prior = np.zeros(len(q_cat), bool)
        _, first_idx = np.unique(keys, return_index=True)
        keep = np.zeros(len(keys), bool)
        keep[first_idx] = True
        keep &= ~prior
        q_ids = q_cat[keep]
        p3d_rows = p_cat[keep]
        for qi, pr in zip(q_ids, p3d_rows):
            dedup.setdefault(int(qi), set()).add(int(pr))

        mp3d = self.map.point_xyz[p3d_rows]
        mkpq = kpq[q_ids].astype(np.float64)
        if gate_pose is not None and radius > 0 and len(mp3d):
            proj, _ = _np_project(mp3d, gate_pose[0], gate_pose[1], cam8)
            ok = np.linalg.norm(mkpq - proj, axis=1) <= radius
            mp3d, mkpq = mp3d[ok], mkpq[ok]
            p3d_rows, q_ids = p3d_rows[ok], q_ids[ok]
        return mp3d, mkpq + 0.5, p3d_rows, q_ids, per_db  # +0.5: COLMAP origin

    # ------------------------------------------------------------------
    def _pad_bucket(self, n: int) -> int:
        """Power-of-2 pad size with the configured floor."""
        return max(self.cfg.pnp_pad_floor, 1 << (max(n, 1) - 1).bit_length())

    def _padded(self, mkpq, mp3d, mask=None):
        n, n_pad, dev = len(mkpq), self._pad_bucket(len(mkpq)), self.device
        kp = np.zeros((n_pad, 2), np.float32)
        p3 = np.zeros((n_pad, 3), np.float32)
        va = np.zeros(n_pad, bool)
        kp[:n], p3[:n], va[:n] = mkpq, mp3d, True if mask is None else mask
        return (torch.from_numpy(kp).to(dev), torch.from_numpy(p3).to(dev),
                torch.from_numpy(va).to(dev))

    def _run_pnp(self, mkpq, mp3d, cam8, thresh, seed=0):
        kp, p3, va = self._padded(mkpq, mp3d)
        cam = torch.as_tensor(cam8, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        res = pnp_ransac(kp, p3, cam, va, threshold=float(thresh), generator=gen,
                         num_hypotheses=self.cfg.num_hypotheses)
        out = torch.cat([res.qvec, res.tvec,
                         torch.stack([res.num_inliers.float(), res.success.float()]),
                         res.inliers.float()]).cpu().numpy()  # one fetch
        n = len(mkpq)
        return (out[:4].astype(np.float64), out[4:7].astype(np.float64),
                out[9:9 + n] > 0.5, int(out[7]), bool(out[8] > 0.5))

    # ------------------------------------------------------------------
    def refine_covisibility(self, qname: str, cam8: np.ndarray, q_feats,
                            seed_image_id: int, qvec: np.ndarray,
                            tvec: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int, str]:
        """``pose_refinement_covisibility``: expand frames, re-match, gate by
        reprojection radius, PnP at opt_th, then iters× re-select + refine."""
        cfg = self.cfg
        log = ""
        if "obs" in cfg.opt_type:
            db_ids = self.map.covis_frames_obs(
                seed_image_id, covisibility_frame=cfg.covisibility_frame,
                obs_th=cfg.obs_thresh, pred_qvec=qvec, pred_tvec=tvec)
        elif "pos" in cfg.opt_type:
            db_ids = self.map.covis_frames_pose(
                seed_image_id, qvec, tvec, covisibility_frame=cfg.covisibility_frame,
                q_th=10.0, t_th=10.0, obs_th=cfg.obs_thresh)
        else:
            raise ValueError(f"opt_type {cfg.opt_type!r} needs 'obs' or 'pos'")

        kpq, q_desc, q_valid, q_labels = q_feats
        matches = self._match_query_to_dbs(q_desc, q_valid, db_ids, q_labels)
        mp3d, mkpq, _, _, _ = self._assemble_2d3d(
            kpq, matches, db_ids, cfg.obs_thresh, dedup={},
            gate_pose=(qvec, tvec), cam8=cam8, radius=cfg.radius)
        log += f"covis refine: {len(db_ids)} frames, {len(mkpq)} matches\n"
        if len(mkpq) < 6:
            return qvec, tvec, 0, log + "too few matches, keep pose\n"

        q_new, t_new, inliers_rsac, num, success = self._run_pnp(
            mkpq, mp3d, cam8, cfg.opt_thresh, seed=1)
        if not success:
            return qvec, tvec, 0, log + "refinement RANSAC failed, keep pose\n"
        qvec, tvec = q_new, t_new

        if "ref" in cfg.opt_type and inliers_rsac.sum() >= 10:
            kp, p3, ms = self._padded(mkpq, mp3d, inliers_rsac)
            dev = self.device
            q_r, t_r, num_r, nums = refine_pose_iterative(
                torch.as_tensor(qvec, dtype=torch.float32, device=dev),
                torch.as_tensor(tvec, dtype=torch.float32, device=dev), p3, kp,
                torch.as_tensor(cam8, dtype=torch.float32, device=dev), ms,
                float(cfg.opt_thresh), iters=cfg.iters)
            out = torch.cat([q_r, t_r, num_r.float()[None], nums.float()]).cpu().numpy()
            if int(out[7]) > 0:
                qvec = out[:4].astype(np.float64)
                tvec = out[4:7].astype(np.float64)
                num = int(out[7])
            for it, n_it in enumerate(out[8:]):
                if n_it >= 0:
                    log += f"iter {it+1}: {int(n_it)} inliers\n"
        return qvec, tvec, num, log

    # ------------------------------------------------------------------
    def localize(self, qname: str, qinfo, clusters: Sequence[Sequence[int]]) -> QueryResult:
        """``pose_from_cluster_with_matcher`` over candidate clusters (each a
        list of DB image ids, e.g. singletons for init_type='sng')."""
        cfg = self.cfg
        model, _, _, params = qinfo
        cam8 = canonicalize_params(model, params)
        kpq, q_desc, _, q_valid, q_labels = self.features.read_padded(
            qname, cfg.max_keypoints, with_labels=True)
        dev = self.device
        q_feats = (kpq, torch.from_numpy(q_desc).to(dev), torch.from_numpy(q_valid).to(dev),
                   torch.from_numpy(q_labels).to(dev) if self._label_aware else None)
        log = ""

        # The first cluster is matched alone (easy queries stop there); on
        # the first miss all remaining candidates are matched in one launch.
        match_of: Dict[int, np.ndarray] = {}

        def ensure_matched(ci: int):
            cluster = clusters[ci]
            if all(iid in match_of for iid in cluster):
                return
            todo = sorted({iid for c in clusters[ci:] for iid in c if iid not in match_of}
                          ) if ci > 0 else sorted(set(cluster))
            m = self._match_query_to_dbs(q_feats[1], q_feats[2], todo, q_feats[3])
            for i, iid in enumerate(todo):
                match_of[iid] = m[i]

        best = {"num_inliers": 0, "qvec": None, "tvec": None, "db_id": None}
        for ci, cluster in enumerate(clusters):
            if not cluster:
                continue
            ensure_matched(ci)
            matches = np.stack([match_of[iid] for iid in cluster])
            mp3d, mkpq, p3d_rows, q_ids, per_db = self._assemble_2d3d(
                kpq, matches, cluster, obs_th=3, dedup={})
            if len(mp3d) < 8:
                log += f"cluster {ci}: only {len(mp3d)} matches, skip\n"
                continue
            qv, tv, inliers, num, success = self._run_pnp(
                mkpq, mp3d, cam8, cfg.ransac_thresh, seed=ci)
            if not success:
                log += f"cluster {ci}: PnP failed\n"
                continue

            # Best-single-image consensus (``:745-760``).
            assign = np.full(cfg.max_keypoints, -2, np.int64)
            inl_idx = np.nonzero(inliers)[0]
            assign[q_ids[inl_idx]] = p3d_rows[inl_idx]
            best_single, best_db = -1, cluster[0]
            for iid, recs in per_db.items():
                n = int(np.sum(assign[recs[:, 0]] == recs[:, 1])) if len(recs) else 0
                if n > best_single:
                    best_single, best_db = n, iid

            if best_single >= 8 and num > best["num_inliers"]:
                best.update(num_inliers=num, qvec=qv, tvec=tv, db_id=best_db)
            if num < cfg.inlier_thresh or best_single < 10:
                log += f"cluster {ci}: weak ({best_single}/{num} inliers)\n"
                continue

            log += f"cluster {ci}: accepted ({best_single}/{num} inliers)\n"
            if cfg.do_covisibility_opt and "clu" in cfg.opt_type:
                qv, tv, num, rlog = self.refine_covisibility(qname, cam8, q_feats, best_db, qv, tv)
                log += rlog
            return QueryResult(qv, tv, num, log, source="accepted")

        if best["num_inliers"] >= 10:
            qv, tv = best["qvec"], best["tvec"]
            if cfg.do_covisibility_opt and "clu" in cfg.opt_type:
                qv, tv, _, rlog = self.refine_covisibility(
                    qname, cam8, q_feats, best["db_id"], qv, tv)
                log += rlog
            return QueryResult(qv, tv, 0, log, source="best_fallback")

        top = self.map.images[clusters[0][0]]
        log += f"failed; using pose of {top.name}\n"
        return QueryResult(np.array(top.qvec), np.array(top.tvec), -1, log,
                           source="retrieval_fallback")
