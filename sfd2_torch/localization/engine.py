"""Hierarchical localization engine (it_loc semantics) on one device.

Port of ``sfd2_tpu/localization/engine.py``. ``localize`` = per-cluster
2D-3D matching, PnP-RANSAC, per-DB-image consensus gates, covisibility
refinement and graded fallbacks (``it_loc/localize_cv2.py:652``), with
``refine_covisibility`` = frame expansion, re-matching, radius gate and
iterative re-selection + LM (``:236``).

All candidate DB banks of a round are stacked [D, K, C] on the device
(D bucketed, so 50 retrieved frames run as 64 banks, the padding banks
all-invalid) and matched against the query in one launch of kernel K2;
the query is broadcast with a batch stride of 0, not copied. PnP-RANSAC
and the refinement are programs over a leading query axis
(``ransac.pnp_ransac_program``, ``pnp.refine_pose_iterative_program``):
on the card they replay CUDA graphs captured once per padded shape
(``localization/graphs.py``), on the CPU they run eagerly. Graph work
stays on the host (``MapIndex``). Each device result is fetched with one
transfer.

Throughput paths:
* ``localize_many`` runs ``localize`` on worker threads: one RLock guards
  the host and device bank caches and the feature store, the graphs
  serialise their replays, and the results are bit-identical to the
  sequential loop;
* ``localize_throughput`` runs every device stage once for all still
  active queries: ``_batched_match`` (chunks of 128 flattened (query,
  bank) pairs, every chunk dispatched before any is fetched),
  ``_batched_pnp`` and ``_refine_pool`` (PnP-RANSAC and the refinement
  with the queries on the leading axis, the JAX engine's vmapped
  programs);
* ``inject_db_features`` registers device-born DB banks.

With a ``mesh`` the query's DB banks are split over its devices
(``ops/sharded_match.py::query_vs_sharded_bank``), as the JAX engine's
shard_map program splits them.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.geometry.cameras import canonicalize_params
from sfd2_torch.geometry.np_pose import qvec_to_rotmat
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization import graphs
from sfd2_torch.localization.pnp import refine_pose_iterative_program
from sfd2_torch.localization.ransac import fold_seed, pnp_ransac_program, sample_minimal_sets
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import count, span, waited

_D_BUCKETS = (1, 4, 8, 16, 32, 64, 128)
_MAX_PAIRS = 128  # flattened (query, bank) pairs per matcher launch of _batched_match


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


def _covis_frames(map_index: MapIndex, cfg: LocalizerConfig, seed_image_id: int, qvec, tvec):
    with span("engine.frames"):
        if "obs" in cfg.opt_type:
            return map_index.covis_frames_obs(
                seed_image_id, covisibility_frame=cfg.covisibility_frame, obs_th=cfg.obs_thresh,
                pred_qvec=qvec, pred_tvec=tvec)
        if "pos" in cfg.opt_type:
            return map_index.covis_frames_pose(seed_image_id, qvec, tvec,
                                               covisibility_frame=cfg.covisibility_frame,
                                               q_th=10.0, t_th=10.0, obs_th=cfg.obs_thresh)
    raise ValueError(f"opt_type {cfg.opt_type!r} needs 'obs' or 'pos'")


def _best_single(cfg: LocalizerConfig, inliers, q_ids, p3d_rows, per_db, cluster):
    """Best-single-image consensus (``:745-760``): per DB image, the count
    of its (qid → p3d) matches that are PnP inliers; (count, image)."""
    assign = np.full(cfg.max_keypoints, -2, np.int64)
    inl_idx = np.nonzero(inliers)[0]
    assign[q_ids[inl_idx]] = p3d_rows[inl_idx]
    best_single, best_db = -1, cluster[0]
    for iid, recs in per_db.items():
        n = int(np.sum(assign[recs[:, 0]] == recs[:, 1])) if len(recs) else 0
        if n > best_single:
            best_single, best_db = n, iid
    return best_single, best_db


class LocalizationEngine:
    def __init__(self, map_index: MapIndex, feature_store: FeatureStore,
                 config: LocalizerConfig = LocalizerConfig(), device="cuda", mesh=None):
        """`mesh`: an optional ``parallel.mesh.Mesh`` with a 'data' axis: a
        query's candidate DB banks are split over it and matched by
        ``ops/sharded_match.py::query_vs_sharded_bank``, one share per
        device; banks stay cached on `device`."""
        self.mesh = mesh
        self.map = map_index
        self.features = feature_store
        self.cfg = config
        self.device = resolve_device(device)
        self._db_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._db_dev_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # Injected banks: outside the LRU caches, never evicted (the store
        # does not hold their descriptors).
        self._pinned: Dict[str, tuple] = {}
        self._pinned_dev: Dict[str, tuple] = {}
        self._dev_zero_entry = None
        # The caches, the feature store (an ``io/h5file.py`` file indexes a
        # group on its first lookup) and the padding entry are the state that
        # concurrent localize() calls share.
        self._cache_lock = threading.RLock()
        self._matcher = batch_matcher(config.matcher)
        self._label_aware = config.matcher == "nnml"

    # ------------------------------------------------------------------
    def _db_feats(self, image_id: int):
        """Padded (kp, desc, valid3d, p3d_rows, labels) of a DB image, LRU-cached
        (desc is None for an injected bank)."""
        name = self.map.images[image_id].name
        with waited(self._cache_lock, "engine.cache_lock_wait"):
            if name in self._pinned:
                return self._pinned[name]
            if name in self._db_cache:
                self._db_cache.move_to_end(name)
                return self._db_cache[name]
            with span("engine.bank_read"):
                kp, desc, _, valid, labels = self.features.read_padded(
                    name, self.cfg.max_keypoints, with_labels=True)
                valid3d, prow = self._valid3d(image_id, valid)
            entry = (kp, desc, valid3d, prow, labels)
            self._db_cache[name] = entry
            if len(self._db_cache) > self.cfg.db_cache_images:
                self._db_cache.popitem(last=False)
            return entry

    def _valid3d(self, image_id: int, valid):
        """(valid3d [K], p3d_rows [K]): keypoints with a 3D point, and its row."""
        k = self.cfg.max_keypoints
        prow_full = self.map.p3d_rows_per_image[self.map.image_row[image_id]]
        prow = np.full(k, -1, np.int64)
        n = min(len(prow_full), k)
        prow[:n] = prow_full[:n]
        return np.asarray(valid, bool) & (prow >= 0), prow

    def _dev_entry(self, desc: torch.Tensor, valid3d: np.ndarray, labels: np.ndarray):
        """(desc [K,C] float32, valid3d [K], labels [K]) on the device;
        the reference's ≤3-valid bail-out (it_loc/localize_cv2.py:530) is baked
        into the mask."""
        v = valid3d if valid3d.sum() > 3 else np.zeros_like(valid3d)
        dev = self.device
        return (desc.to(dev, torch.float32), torch.from_numpy(v).to(dev),
                torch.from_numpy(np.asarray(labels, np.int32)).to(dev)
                if self._label_aware else None)

    def _db_feats_dev(self, image_id: int):
        """Device-resident (desc [K,C], valid3d [K], labels [K]) of a DB image,
        uploaded once and LRU-cached (injected banks are pinned). Counts
        ``engine.bank_lookups`` and ``engine.bank_misses``, also as the
        ``lookups`` and ``misses`` tags of the span open around the call."""
        name = self.map.images[image_id].name
        count("engine.bank_lookups", tag="lookups")
        with waited(self._cache_lock, "engine.cache_lock_wait"):
            if name in self._pinned_dev:
                return self._pinned_dev[name]
            if name in self._db_dev_cache:
                self._db_dev_cache.move_to_end(name)
                return self._db_dev_cache[name]
            count("engine.bank_misses", tag="misses")
            _, desc, valid3d, _, labels = self._db_feats(image_id)
            with span("engine.bank_upload"):
                entry = self._dev_entry(torch.from_numpy(desc), valid3d, labels)
            self._db_dev_cache[name] = entry
            if len(self._db_dev_cache) > self.cfg.db_cache_images:
                self._db_dev_cache.popitem(last=False)
            return entry

    def _dev_zero(self, c: int):
        """All-invalid padding bank for slots past len(db_ids)."""
        with waited(self._cache_lock, "engine.cache_lock_wait"):
            if self._dev_zero_entry is None or self._dev_zero_entry[0].shape[1] != c:
                k, dev = self.cfg.max_keypoints, self.device
                self._dev_zero_entry = (
                    torch.zeros((k, c), device=dev),
                    torch.zeros(k, dtype=torch.bool, device=dev),
                    torch.zeros(k, dtype=torch.int32, device=dev) if self._label_aware else None)
            return self._dev_zero_entry

    def inject_db_features(self, image_id: int, kp: np.ndarray, desc_dev: torch.Tensor,
                           valid: np.ndarray, labels: Optional[np.ndarray] = None):
        """Register a DB image whose descriptors were born on the device
        (``desc_dev`` [K, C], K = ``max_keypoints``, any float dtype), so
        extraction output never round-trips through the store; only the
        host metadata (keypoints, 3D-point rows) is kept on the host.

        Deliberate deviations from the JAX engine (``sfd2_tpu/localization/
        engine.py:326-356``): the ``labels`` given are kept (the 'nnml'
        matcher needs them, and refuses an injected bank without them);
        the bank is pinned, outside both LRU caches, so it is never evicted
        (the store does not hold its descriptors); and it is cast to float32,
        the dtype of every bank the engine holds, so banks stack into one
        matcher launch without promotion."""
        k = self.cfg.max_keypoints
        if desc_dev.ndim != 2 or desc_dev.shape[0] != k:
            raise ValueError(f"inject_db_features: desc_dev must be [{k}, C], "
                             f"got {tuple(desc_dev.shape)}")
        if labels is None:
            if self._label_aware:
                raise ValueError("inject_db_features: the 'nnml' matcher needs the bank's labels")
            labels = np.zeros(k, np.int32)
        labels = np.asarray(labels, np.int32)
        name = self.map.images[image_id].name
        valid3d, prow = self._valid3d(image_id, valid)
        entry = self._dev_entry(desc_dev, valid3d, labels)
        with self._cache_lock:
            self._pinned[name] = (np.asarray(kp, np.float32), None, valid3d, prow, labels)
            self._pinned_dev[name] = entry
            self._db_cache.pop(name, None)
            self._db_dev_cache.pop(name, None)

    def _match_query_to_dbs(self, q_desc, q_valid, db_ids: Sequence[int], q_labels=None):
        """One batched mutual-NN launch of the query against every candidate
        DB bank, DB rows restricted to keypoints with 3D points. Returns
        matches [D, K] int64 (−1 for no match)."""
        d_pad = _bucket(len(db_ids))
        if self.mesh is not None:  # whole shares per device
            n_dev = self.mesh.shape["data"]
            d_pad = -(-d_pad // n_dev) * n_dev
        with span("engine.match", banks=d_pad, real_banks=len(db_ids), lookups=0, misses=0):
            c = q_desc.shape[1]
            entries = [self._db_feats_dev(iid) for iid in db_ids]
            entries += [self._dev_zero(c)] * (d_pad - len(db_ids))
            bank = torch.stack([e[0] for e in entries])
            bval = torch.stack([e[1] for e in entries])
            if self.mesh is not None:
                from sfd2_torch.ops.sharded_match import query_vs_sharded_bank

                matches, _ = query_vs_sharded_bank(
                    self.mesh, q_desc, bank, q_valid, bval,
                    q_labels if self._label_aware else None,
                    torch.stack([e[2] for e in entries]) if self._label_aware else None)
                return matches[: len(db_ids)].cpu().numpy().astype(np.int64)
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
        with span("engine.assemble"):
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

    def _pnp_batch(self, items: Sequence[tuple], thresh: float, seeds: Sequence[int],
                   n_pad: Optional[int] = None):
        """PnP-RANSAC of items [(mkpq, mp3d, cam8)] padded to len(seeds)
        queries (padding queries all-invalid, on a benign fx = fy = 1
        camera) and to one correspondence bucket (`n_pad`, by default the
        items' own); query i's hypotheses come from a generator seeded
        seeds[i]. Returns the packed device result [len(seeds), 9 + n_pad]."""
        qp, dev = len(seeds), self.device
        n_pad = n_pad or self._pad_bucket(max(len(it[0]) for it in items))
        kp = np.zeros((qp, n_pad, 2), np.float32)
        p3 = np.zeros((qp, n_pad, 3), np.float32)
        va = np.zeros((qp, n_pad), bool)
        cams = np.zeros((qp, 8), np.float32)
        cams[:, :2] = 1.0
        for i, (mkpq, mp3d, cam8) in enumerate(items):
            n = len(mkpq)
            kp[i, :n], p3[i, :n], va[i, :n] = mkpq, mp3d, True
            cams[i] = np.asarray(cam8, np.float32).reshape(8)
        va_t = torch.from_numpy(va).to(dev)
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        idx = sample_minimal_sets(va_t, self.cfg.num_hypotheses, gens)
        return graphs.run(pnp_ransac_program(
            torch.from_numpy(kp).to(dev), torch.from_numpy(p3).to(dev),
            torch.from_numpy(cams).to(dev), va_t, idx, float(thresh)))

    @staticmethod
    def _unpack_pnp(row: np.ndarray, n: int):
        """(qvec, tvec, inliers [n], num, success) of one packed PnP row."""
        return (row[:4].astype(np.float64), row[4:7].astype(np.float64), row[9:9 + n] > 0.5,
                int(row[7]), bool(row[8] > 0.5))

    def _run_pnp(self, mkpq, mp3d, cam8, thresh, seed=0):
        with span("engine.pnp"):
            out = self._pnp_batch([(mkpq, mp3d, cam8)], thresh, [seed]).cpu().numpy()  # one fetch
        return self._unpack_pnp(out[0], len(mkpq))

    def _refine_batch(self, items: Sequence[tuple], qp: int,
                      n_pad: Optional[int] = None) -> np.ndarray:
        """The iterative re-selection + LM of items [(qvec, tvec, mkpq, mp3d,
        base mask, cam8)] padded to qp queries (identity poses, no rows, a
        benign camera) and one correspondence bucket (`n_pad`, by default
        the items' own), in one program; fetched once: [qp, 8 + iters] =
        qvec, tvec, num, nums."""
        with span("engine.refine"):
            dev = self.device
            n_pad = n_pad or self._pad_bucket(max(len(it[2]) for it in items))
            qv = np.zeros((qp, 4), np.float32)
            qv[:, 0] = 1.0
            tv = np.zeros((qp, 3), np.float32)
            p3 = np.zeros((qp, n_pad, 3), np.float32)
            kp = np.zeros((qp, n_pad, 2), np.float32)
            ms = np.zeros((qp, n_pad), bool)
            cams = np.zeros((qp, 8), np.float32)
            cams[:, :2] = 1.0
            for i, (q, t, mkpq, mp3d, inl, cam8) in enumerate(items):
                n = len(mkpq)
                qv[i], tv[i] = q, t
                p3[i, :n], kp[i, :n], ms[i, :n] = mp3d, mkpq, inl
                cams[i] = np.asarray(cam8, np.float32).reshape(8)
            t32 = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            return graphs.run(refine_pose_iterative_program(
                t32(qv), t32(tv), t32(p3), t32(kp), t32(cams), t32(ms), float(self.cfg.opt_thresh),
                iters=self.cfg.iters)).cpu().numpy()

    def _apply_refine(self, row: np.ndarray, qvec, tvec, num: int):
        """(qvec, tvec, num, log) after one packed refinement row."""
        log = ""
        if int(row[7]) > 0:
            qvec, tvec, num = row[:4].astype(np.float64), row[4:7].astype(np.float64), int(row[7])
        for it, n_it in enumerate(row[8:8 + self.cfg.iters]):
            if n_it >= 0:
                log += f"iter {it+1}: {int(n_it)} inliers\n"
        return qvec, tvec, num, log

    def warm_buckets(self) -> List[int]:
        """The correspondence buckets a single query's PnP-RANSAC and
        refinement take when it has at most 2 × ``max_keypoints``
        correspondences: every power of two from ``pnp_pad_floor`` up. A
        singleton cluster gives at most ``max_keypoints`` (one match per
        query keypoint); a covisibility refinement, which keeps a query
        keypoint's matches to distinct 3D points, can give more."""
        top = self._pad_bucket(2 * self.cfg.max_keypoints)
        return sorted({self._pad_bucket(1 << e) for e in range(top.bit_length())})

    def warmup_programs(self):
        """Run PnP-RANSAC and the refinement once for one query at every
        bucket of ``warm_buckets``, on eight points seen from the identity
        pose (padded to the bucket): on the card this captures their graphs,
        so a ``localize`` of up to 2 × ``max_keypoints`` correspondences
        replays them and captures nothing."""
        mp3d = np.random.default_rng(0).uniform([-1, -1, 4], [1, 1, 8], (8, 3))
        mkpq = 100.0 * mp3d[:, :2] / mp3d[:, 2:] + 50.0
        cam8 = np.array([100.0, 100.0, 50.0, 50.0, 0, 0, 0, 0])
        for n_pad in self.warm_buckets():
            out = self._pnp_batch([(mkpq, mp3d, cam8)], self.cfg.ransac_thresh, [0], n_pad)
            q, t, inl, _, _ = self._unpack_pnp(out.cpu().numpy()[0], len(mkpq))
            self._refine_batch([(q, t, mkpq, mp3d, inl, cam8)], 1, n_pad)

    # ------------------------------------------------------------------
    def refine_covisibility(self, qname: str, cam8: np.ndarray, q_feats,
                            seed_image_id: int, qvec: np.ndarray,
                            tvec: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int, str]:
        """``pose_refinement_covisibility``: expand frames, re-match, gate by
        reprojection radius, PnP at opt_th, then iters× re-select + refine."""
        with span("engine.refine_covis"):
            cfg = self.cfg
            db_ids = _covis_frames(self.map, cfg, seed_image_id, qvec, tvec)
            kpq, q_desc, q_valid, q_labels = q_feats
            matches = self._match_query_to_dbs(q_desc, q_valid, db_ids, q_labels)
            mp3d, mkpq, _, _, _ = self._assemble_2d3d(
                kpq, matches, db_ids, cfg.obs_thresh, dedup={},
                gate_pose=(qvec, tvec), cam8=cam8, radius=cfg.radius)
            log = f"covis refine: {len(db_ids)} frames, {len(mkpq)} matches\n"
            if len(mkpq) < 6:
                return qvec, tvec, 0, log + "too few matches, keep pose\n"

            q_new, t_new, inliers_rsac, num, success = self._run_pnp(
                mkpq, mp3d, cam8, cfg.opt_thresh, seed=1)
            if not success:
                return qvec, tvec, 0, log + "refinement RANSAC failed, keep pose\n"
            qvec, tvec = q_new, t_new

            if "ref" in cfg.opt_type and inliers_rsac.sum() >= 10:
                row = self._refine_batch([(qvec, tvec, mkpq, mp3d, inliers_rsac, cam8)], 1)[0]
                qvec, tvec, num, rlog = self._apply_refine(row, qvec, tvec, num)
                log += rlog
            return qvec, tvec, num, log

    # ------------------------------------------------------------------
    def _query_feats(self, qname: str):
        """(kp [K,2] host, desc [K,C], valid [K], labels [K] or None on the
        device) of a query, read once: every match round reuses them."""
        with span("engine.query_feats"):
            # The store indexes a group on its first lookup.
            with waited(self._cache_lock, "engine.cache_lock_wait"):
                kpq, q_desc, _, q_valid, q_labels = self.features.read_padded(
                    qname, self.cfg.max_keypoints, with_labels=True)
            dev = self.device
            return (kpq, torch.from_numpy(q_desc).to(dev), torch.from_numpy(q_valid).to(dev),
                    torch.from_numpy(q_labels).to(dev) if self._label_aware else None)

    def localize(self, qname: str, qinfo, clusters: Sequence[Sequence[int]]) -> QueryResult:
        """``pose_from_cluster_with_matcher`` over candidate clusters (each a
        list of DB image ids, e.g. singletons for init_type='sng')."""
        with span("engine.localize"):
            cfg = self.cfg
            model, _, _, params = qinfo
            cam8 = canonicalize_params(model, params)
            q_feats = self._query_feats(qname)
            kpq = q_feats[0]
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
                best_single, best_db = _best_single(cfg, inliers, q_ids, p3d_rows, per_db, cluster)
                if best_single >= 8 and num > best["num_inliers"]:
                    best.update(num_inliers=num, qvec=qv, tvec=tv, db_id=best_db)
                if num < cfg.inlier_thresh or best_single < 10:
                    log += f"cluster {ci}: weak ({best_single}/{num} inliers)\n"
                    continue

                log += f"cluster {ci}: accepted ({best_single}/{num} inliers)\n"
                if cfg.do_covisibility_opt and "clu" in cfg.opt_type:
                    qv, tv, num, rlog = self.refine_covisibility(qname, cam8, q_feats, best_db,
                                                                 qv, tv)
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

    # ------------------------------------------------------------------
    def localize_many(self, queries: Sequence[Tuple[str, tuple, Sequence[Sequence[int]]]],
                      workers: int = 4) -> List[QueryResult]:
        """``localize`` of (qname, qinfo, clusters) triples on `workers`
        threads, results in order: one query's host work (2D-3D assembly,
        fetches) overlaps another's device work. Bit-identical to the
        sequential loop: the shared caches are lock-guarded and every
        device program gives the same result on the same inputs."""
        if workers <= 1 or len(queries) <= 1:
            return [self.localize(*q) for q in queries]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(lambda q: self.localize(*q), queries))

    def _batched_match(self, q_feats_dev: List[tuple], banks_per_q: List[List[int]]
                       ) -> np.ndarray:
        """Matcher launches for several queries, query i against its padded
        bank group: matches [Q, D, K] (−1 for no match). The flattened
        (query, bank) axis is cut into chunks of at most 128 pairs, every
        chunk launched before any is fetched (the launches are
        asynchronous), and fetched as int16 below 32768 keypoints (the
        fetch's span is tagged with its megabytes, ``mb``)."""
        k = self.cfg.max_keypoints
        d = max(1, max(len(b) for b in banks_per_q))
        per_chunk = max(1, _MAX_PAIRS // d) if len(banks_per_q) * d > _MAX_PAIRS \
            else len(banks_per_q)
        with span("engine.batched_match.dispatch"):
            devs = [self._batched_match_dev(q_feats_dev[s0:s0 + per_chunk],
                                            banks_per_q[s0:s0 + per_chunk], d)
                    for s0 in range(0, len(banks_per_q), per_chunk)]
        out = np.full((len(banks_per_q), d, k), -1, np.int64)
        with span("engine.batched_match.fetch") as fetch:
            s0, nbytes = 0, 0
            for dev, nq in devs:
                sub = dev.cpu().numpy()
                nbytes += sub.nbytes
                out[s0:s0 + nq] = sub[: nq * d].reshape(nq, d, k)
                s0 += nq
            fetch.set(mb=nbytes / 1e6)
        return out

    def _batched_match_dev(self, q_feats_dev, banks_per_q, d):
        """Launch one flattened matcher chunk, padded to a bucket of pairs;
        returns (device matches [n_flat, K] in the fetch dtype, n_queries)
        without waiting for them."""
        k = self.cfg.max_keypoints
        c = q_feats_dev[0][0].shape[1]
        n_flat = _bucket(len(banks_per_q) * d)
        zero = self._dev_zero(c)
        entries = []
        for banks in banks_per_q:
            entries += [self._db_feats_dev(i) for i in banks] + [zero] * (d - len(banks))
        entries += [zero] * (n_flat - len(entries))
        bank = torch.stack([e[0] for e in entries])
        bval = torch.stack([e[1] for e in entries])
        qpad = n_flat - len(banks_per_q) * d

        def per_pair(i, dtype):  # query rows repeated d times, zero-padded
            t = torch.stack([qf[i] for qf in q_feats_dev]).to(dtype).repeat_interleave(d, dim=0)
            return torch.cat([t, t.new_zeros((qpad, *t.shape[1:]))]) if qpad else t

        args = [per_pair(0, bank.dtype), bank, per_pair(1, torch.bool), bval]
        if self._label_aware:
            args += [per_pair(2, torch.int32), torch.stack([e[2] for e in entries])]
        m, _ = self._matcher(*args)
        return m.to(torch.int16 if k < 32768 else torch.int32), len(banks_per_q)

    def _batched_pnp(self, items: List[tuple], thresh: float, seed_base: int):
        """items [(mkpq, mp3d, cam8)] → one PnP-RANSAC program for all of
        them, padded to a bucket of queries; query i's generator is seeded
        ``fold_seed(seed_base, i)``. Returns [(qvec, tvec, inliers, num,
        success)] per item."""
        qp = _bucket(len(items))
        with span("engine.batched_pnp.dispatch"):
            dev = self._pnp_batch(items, thresh, [fold_seed(seed_base, i) for i in range(qp)])
        with span("engine.batched_pnp.fetch"):
            out = dev.cpu().numpy()  # [qp, 9 + n_pad]
        return [self._unpack_pnp(out[i], len(it[0])) for i, it in enumerate(items)]

    def localize_throughput(self, jobs: Sequence[Tuple[str, tuple, Sequence[Sequence[int]]]]
                            ) -> List[QueryResult]:
        """Batched-across-queries localization: the gates and fallbacks of
        ``localize``, but every device stage (matching, PnP-RANSAC, the
        refinement) runs once for all still active queries. Cluster rounds
        go in lockstep: round ci matches every remaining query's ci-th
        cluster, and queries accept or drop out on their own; the
        covisibility refinement pool is matched and refined the same way.
        Hypotheses are drawn per query from ``fold_seed`` generators, so
        poses agree with ``localize``'s to RANSAC's noise, not bit for bit."""
        cfg = self.cfg
        state = []
        for qname, qinfo, clusters in jobs:
            model, _, _, params = qinfo
            kpq, *q_dev = self._query_feats(qname)
            state.append({"qname": qname, "cam8": canonicalize_params(model, params),
                          "kpq": kpq, "q_dev": tuple(q_dev),
                          "clusters": [c for c in clusters if c], "log": "",
                          "best": {"num_inliers": 0, "qvec": None, "tvec": None, "db_id": None},
                          "result": None, "refine": None})

        for ci in range(max((len(s["clusters"]) for s in state), default=0)):
            active = [s for s in state if s["result"] is None and s["refine"] is None
                      and ci < len(s["clusters"])]
            if not active:
                break
            matches = self._batched_match([s["q_dev"] for s in active],
                                          [s["clusters"][ci] for s in active])
            pnp_items, pnp_ctx = [], []
            for s, m in zip(active, matches):
                cluster = s["clusters"][ci]
                mp3d, mkpq, p3d_rows, q_ids, per_db = self._assemble_2d3d(
                    s["kpq"], m[: len(cluster)], cluster, obs_th=3, dedup={})
                if len(mp3d) < 8:
                    s["log"] += f"cluster {ci}: only {len(mp3d)} matches, skip\n"
                    continue
                pnp_items.append((mkpq, mp3d, s["cam8"]))
                pnp_ctx.append((s, per_db, p3d_rows, q_ids, cluster))
            if not pnp_items:
                continue
            results = self._batched_pnp(pnp_items, cfg.ransac_thresh, seed_base=1000 + ci)
            for (s, per_db, p3d_rows, q_ids, cluster), (qv, tv, inliers, num, success) in zip(
                    pnp_ctx, results):
                if not success:
                    s["log"] += f"cluster {ci}: PnP failed\n"
                    continue
                best_single, best_db = _best_single(cfg, inliers, q_ids, p3d_rows, per_db,
                                                    cluster)
                b = s["best"]
                if best_single >= 8 and num > b["num_inliers"]:
                    b.update(num_inliers=num, qvec=qv, tvec=tv, db_id=best_db)
                if num < cfg.inlier_thresh or best_single < 10:
                    s["log"] += f"cluster {ci}: weak ({best_single}/{num} inliers)\n"
                    continue
                s["log"] += f"cluster {ci}: accepted ({best_single}/{num} inliers)\n"
                s["refine"] = (best_db, qv, tv, "accepted")

        # Exhausted queries: the best single-image fallback joins the refine
        # pool; the rest take the retrieval fallback.
        for s in state:
            if s["result"] is not None or s["refine"] is not None:
                continue
            b = s["best"]
            if b["num_inliers"] >= 10:
                s["refine"] = (b["db_id"], b["qvec"], b["tvec"], "best_fallback")
            else:
                top = self.map.images[s["clusters"][0][0]]
                s["log"] += f"failed; using pose of {top.name}\n"
                s["result"] = QueryResult(np.array(top.qvec), np.array(top.tvec), -1, s["log"],
                                          source="retrieval_fallback")

        pool = [s for s in state if s["refine"] is not None]
        if cfg.do_covisibility_opt and "clu" in cfg.opt_type and pool:
            self._refine_pool(pool)
        for s in pool:
            if s["result"] is None:  # refinement opted out / kept the pose
                _, qv, tv, src = s["refine"]
                s["result"] = QueryResult(qv, tv, s["best"]["num_inliers"], s["log"], source=src)
        return [s["result"] for s in state]

    def _refine_pool(self, pool: List[dict]) -> None:
        """``pose_refinement_covisibility`` for a pool of accepted queries,
        each stage once for the pool (matcher → PnP → iterative LM)."""
        cfg = self.cfg
        banks = [list(_covis_frames(self.map, cfg, s["refine"][0], s["refine"][1],
                                    s["refine"][2])) for s in pool]
        matches = self._batched_match([s["q_dev"] for s in pool], banks)

        pnp_items, ctx = [], []
        for s, m, ids in zip(pool, matches, banks):
            _, qv, tv, src = s["refine"]
            mp3d, mkpq, _, _, _ = self._assemble_2d3d(
                s["kpq"], m[: len(ids)], ids, cfg.obs_thresh, dedup={},
                gate_pose=(qv, tv), cam8=s["cam8"], radius=cfg.radius)
            s["log"] += f"covis refine: {len(ids)} frames, {len(mkpq)} matches\n"
            if len(mkpq) < 6:
                s["result"] = QueryResult(qv, tv, s["best"]["num_inliers"],
                                          s["log"] + "too few matches, keep pose\n", source=src)
                continue
            pnp_items.append((mkpq, mp3d, s["cam8"]))
            ctx.append((s, mkpq, mp3d, src))
        if not pnp_items:
            return
        results = self._batched_pnp(pnp_items, cfg.opt_thresh, seed_base=77)

        lm_items, lm_ctx = [], []
        for (s, mkpq, mp3d, src), (qv, tv, inl, num, success) in zip(ctx, results):
            _, qv0, tv0, _ = s["refine"]
            if not success:
                s["result"] = QueryResult(qv0, tv0, s["best"]["num_inliers"],
                                          s["log"] + "refinement RANSAC failed, keep pose\n",
                                          source=src)
                continue
            if "ref" in cfg.opt_type and inl.sum() >= 10:
                lm_items.append((qv, tv, mkpq, mp3d, inl, s["cam8"]))
                lm_ctx.append((s, num, src))
            else:
                s["result"] = QueryResult(qv, tv, num, s["log"], source=src)
        if not lm_items:
            return
        out = self._refine_batch(lm_items, _bucket(len(lm_items)))
        for row, (qv, tv, *_), (s, num, src) in zip(out, lm_items, lm_ctx):
            qv, tv, num, rlog = self._apply_refine(row, qv, tv, num)
            s["result"] = QueryResult(qv, tv, num, s["log"] + rlog, source=src)
