"""Hierarchical localization engine (it_loc semantics) on one device.

Port of ``sfd2_tpu/localization/engine.py``. ``localize`` = per-cluster
2D-3D matching, PnP-RANSAC, per-DB-image consensus gates, covisibility
refinement and graded fallbacks (``it_loc/localize_cv2.py:652``), with
the refinement (``_refine``) = frame expansion, re-matching, radius gate
and iterative re-selection + LM (``:236``).

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

Two entries apply one set of rules (``_cluster_rounds``, ``_refine``)
and differ only in how they batch the device work and seed RANSAC:
``localize`` runs one query; ``localize_throughput`` runs every device
stage once for all still active queries (``_batched_match``: chunks of
128 flattened (query, bank) pairs, every chunk dispatched before any is
fetched; ``_batched_pnp`` and ``_refine`` with the queries on the leading
axis, the JAX engine's vmapped programs). ``localize_many`` runs
``localize`` on worker threads: one lock guards the device bank cache
and the feature store, the graphs serialise their replays, and the
results are bit-identical to the sequential loop. ``inject_db_features``
registers device-born DB banks.

With a ``mesh`` the query's DB banks are split over its devices
(``ops/sharded_match.py::query_vs_sharded_bank``), as the JAX engine's
shard_map program splits them.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    db_cache_images: int = 1024  # LRU capacity of the device bank cache


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
        n = int(np.sum(assign[recs[:, 0]] == recs[:, 1]))
        if n > best_single:
            best_single, best_db = n, iid
    return best_single, best_db


class _Pose(NamedTuple):
    db_id: int  # the DB image that seeds the covisibility refinement
    qvec: np.ndarray
    tvec: np.ndarray
    num: int  # the PnP inlier count behind it
    source: str  # accepted | best_fallback


@dataclasses.dataclass
class _Query:
    """One query in flight, as both entries hold it."""

    cam8: np.ndarray
    kpq: np.ndarray  # [K, 2] on the host
    dev: tuple  # (desc [K, C], valid [K], labels [K] or None) on the device
    log: str = ""
    best: Optional[_Pose] = None  # the best single-image consensus so far
    pose: Optional[_Pose] = None  # accepted or fallen back to: to refine or report
    kept_num: int = 0  # num_inliers reported for a pose the refinement keeps
    result: Optional[QueryResult] = None

    def finish(self, qvec, tvec, num: int, log: str = "") -> None:
        self.log += log
        self.result = QueryResult(qvec, tvec, num, self.log, source=self.pose.source)


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
        self._bank_lru: "OrderedDict[str, tuple]" = OrderedDict()
        # Injected banks: outside the LRU, never evicted (the store does not
        # hold their descriptors).
        self._pinned_banks: Dict[str, tuple] = {}
        self._dev_zero_entry = None
        # The banks, the feature store (an ``io/h5file.py`` file indexes a
        # group on its first lookup) and the padding bank are the state that
        # concurrent localize() calls share.
        self._cache_lock = threading.Lock()
        self._matcher = batch_matcher(config.matcher)
        self._label_aware = config.matcher == "nnml"
        self._refines = config.do_covisibility_opt and "clu" in config.opt_type

    # ------------------------------------------------------------------
    def _p3d_rows(self, image_id: int) -> np.ndarray:
        """The 3D-point row of each of a DB image's K padded keypoints (−1
        for none), from the map."""
        k = self.cfg.max_keypoints
        prow_full = self.map.p3d_rows_per_image[self.map.image_row[image_id]]
        prow = np.full(k, -1, np.int64)
        n = min(len(prow_full), k)
        prow[:n] = prow_full[:n]
        return prow

    def _dev_entry(self, image_id: int, desc: torch.Tensor, valid, labels):
        """(desc [K,C] float32, valid3d [K], labels [K] or None) on the
        device, valid3d the valid keypoints with a 3D point; the reference's
        ≤3-valid bail-out (it_loc/localize_cv2.py:530) is baked into it."""
        v = np.asarray(valid, bool) & (self._p3d_rows(image_id) >= 0)
        if v.sum() <= 3:
            v = np.zeros_like(v)
        dev = self.device
        return (desc.to(dev, torch.float32), torch.from_numpy(v).to(dev),
                torch.from_numpy(np.asarray(labels, np.int32)).to(dev)
                if self._label_aware else None)

    def _bank(self, image_id: int):
        """Device-resident (desc [K,C], valid3d [K], labels [K] or None) of a
        DB image: pinned if injected, else LRU-cached, read from the store
        and uploaded on a miss. Counts ``engine.bank_lookups`` and
        ``engine.bank_misses``, also as the ``lookups`` and ``misses`` tags
        of the span open around the call."""
        name = self.map.images[image_id].name
        count("engine.bank_lookups", tag="lookups")
        with waited(self._cache_lock, "engine.cache_lock_wait"):
            if name in self._pinned_banks:
                return self._pinned_banks[name]
            if name in self._bank_lru:
                self._bank_lru.move_to_end(name)
                return self._bank_lru[name]
            count("engine.bank_misses", tag="misses")
            with span("engine.bank_read"):
                _, desc, _, valid, labels = self.features.read_padded(
                    name, self.cfg.max_keypoints, with_labels=True)
            with span("engine.bank_upload"):
                entry = self._dev_entry(image_id, torch.from_numpy(desc), valid, labels)
            self._bank_lru[name] = entry
            if len(self._bank_lru) > self.cfg.db_cache_images:
                self._bank_lru.popitem(last=False)
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
        extraction output never round-trips through the store. `kp` is
        taken for the JAX engine's signature: the 2D-3D assembly reads the
        DB image's 3D-point rows from the map, not its keypoints.

        Deliberate deviations from the JAX engine (``sfd2_tpu/localization/
        engine.py:326-356``): the ``labels`` given are kept (the 'nnml'
        matcher needs them, and refuses an injected bank without them);
        the bank is pinned, outside the LRU, so it is never evicted (the
        store does not hold its descriptors); and it is cast to float32,
        the dtype of every bank the engine holds, so banks stack into one
        matcher launch without promotion."""
        k = self.cfg.max_keypoints
        if desc_dev.ndim != 2 or desc_dev.shape[0] != k:
            raise ValueError(f"inject_db_features: desc_dev must be [{k}, C], "
                             f"got {tuple(desc_dev.shape)}")
        if labels is None and self._label_aware:
            raise ValueError("inject_db_features: the 'nnml' matcher needs the bank's labels")
        name = self.map.images[image_id].name
        entry = self._dev_entry(image_id, desc_dev, valid, labels)
        with self._cache_lock:
            self._pinned_banks[name] = entry
            self._bank_lru.pop(name, None)

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
            entries = [self._bank(iid) for iid in db_ids]
            entries += [self._dev_zero(c)] * (d_pad - len(db_ids))
            bank = torch.stack([e[0] for e in entries])
            bval = torch.stack([e[1] for e in entries])
            blab = torch.stack([e[2] for e in entries]) if self._label_aware else None
            if self.mesh is not None:
                from sfd2_torch.ops.sharded_match import query_vs_sharded_bank

                matches, _ = query_vs_sharded_bank(self.mesh, q_desc, bank, q_valid, bval,
                                                   q_labels if self._label_aware else None, blab)
            else:
                q = q_desc.to(bank.dtype)[None].expand(d_pad, *q_desc.shape)
                qv = q_valid[None].expand(d_pad, q_valid.shape[0])
                labels = (q_labels[None].expand(d_pad, q_labels.shape[0]), blab) \
                    if self._label_aware else ()
                matches, _ = self._matcher(q, bank, qv, bval, *labels)
            return matches[: len(db_ids)].cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------------
    def _assemble_2d3d(self, kpq, matches, db_ids, obs_th: int,
                       gate_pose: Optional[tuple] = None, cam8=None, radius: float = 0.0):
        """2D-3D correspondences with first-occurrence (qid, p3d) dedup in DB
        order, track-length filter and optional reprojection-radius gate
        (``match_cluster_2D:563`` + the refinement gate ``:341-350``)."""
        with span("engine.assemble"):
            all_q, all_p = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
            per_db: Dict[int, np.ndarray] = {}
            for di, iid in enumerate(db_ids):
                m = matches[di]
                qidx = np.nonzero(m >= 0)[0]
                rows = self._p3d_rows(iid)[m[qidx]]
                ok = rows >= 0
                qidx, rows = qidx[ok], rows[ok]
                ok = self.map.track_len[rows] >= obs_th
                qidx, rows = qidx[ok], rows[ok]
                per_db[iid] = np.stack([qidx, rows], 1)
                all_q.append(qidx)
                all_p.append(rows)
            q_cat = np.concatenate(all_q).astype(np.int64)
            p_cat = np.concatenate(all_p).astype(np.int64)
            keys = q_cat * (self.map.incidence.shape[1] + 1) + p_cat
            first = np.sort(np.unique(keys, return_index=True)[1])  # first occurrences, in order
            q_ids, p3d_rows = q_cat[first], p_cat[first]
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

    def _padded(self, items: Sequence[tuple], qp: int, n_pad: int) -> List[torch.Tensor]:
        """Device (kp [qp, n_pad, 2], p3 [qp, n_pad, 3], mask [qp, n_pad],
        cams [qp, 8]) of items [(mkpq, mp3d, mask, cam8)]: padding rows
        masked out, padding queries on a benign fx = fy = 1 camera."""
        kp = np.zeros((qp, n_pad, 2), np.float32)
        p3 = np.zeros((qp, n_pad, 3), np.float32)
        ms = np.zeros((qp, n_pad), bool)
        cams = np.zeros((qp, 8), np.float32)
        cams[:, :2] = 1.0
        for i, (mkpq, mp3d, mask, cam8) in enumerate(items):
            n = len(mkpq)
            kp[i, :n], p3[i, :n], ms[i, :n] = mkpq, mp3d, mask
            cams[i] = np.asarray(cam8, np.float32).reshape(8)
        return [torch.from_numpy(a).to(self.device) for a in (kp, p3, ms, cams)]

    def _pnp_batch(self, items: Sequence[tuple], thresh: float, seeds: Sequence[int],
                   n_pad: Optional[int] = None):
        """PnP-RANSAC of items [(mkpq, mp3d, cam8)] padded to len(seeds)
        queries and to one correspondence bucket (`n_pad`, by default the
        items' own); query i's hypotheses come from a generator seeded
        seeds[i]. Returns the packed device result [len(seeds), 9 + n_pad]."""
        n_pad = n_pad or self._pad_bucket(max(len(it[0]) for it in items))
        kp, p3, va, cams = self._padded([(k, p, True, c) for k, p, c in items], len(seeds), n_pad)
        gens = [torch.Generator(device=self.device).manual_seed(s) for s in seeds]
        idx = sample_minimal_sets(va, self.cfg.num_hypotheses, gens)
        return graphs.run(pnp_ransac_program(kp, p3, cams, va, idx, float(thresh)))

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
        base mask, cam8)] padded to qp queries (identity poses) and one
        correspondence bucket (`n_pad`, by default the items' own), in one
        program; fetched once: [qp, 8 + iters] = qvec, tvec, num, nums."""
        with span("engine.refine"):
            n_pad = n_pad or self._pad_bucket(max(len(it[2]) for it in items))
            qv = np.zeros((qp, 4), np.float32)
            qv[:, 0] = 1.0
            tv = np.zeros((qp, 3), np.float32)
            for i, (q, t, *_) in enumerate(items):
                qv[i], tv[i] = q, t
            kp, p3, ms, cams = self._padded([it[2:] for it in items], qp, n_pad)
            return graphs.run(refine_pose_iterative_program(
                torch.from_numpy(qv).to(self.device), torch.from_numpy(tv).to(self.device),
                p3, kp, cams, ms, float(self.cfg.opt_thresh), iters=self.cfg.iters)).cpu().numpy()

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
    def _query(self, qname: str, qinfo) -> _Query:
        """A query's camera, keypoints [K,2] on the host and (desc [K,C],
        valid [K], labels [K] or None) on the device, read once: every match
        round reuses them."""
        model, _, _, params = qinfo
        cam8 = canonicalize_params(model, params)
        with span("engine.query_feats"):
            # The store indexes a group on its first lookup.
            with waited(self._cache_lock, "engine.cache_lock_wait"):
                kpq, q_desc, _, q_valid, q_labels = self.features.read_padded(
                    qname, self.cfg.max_keypoints, with_labels=True)
            dev = self.device
            return _Query(cam8, kpq, (
                torch.from_numpy(q_desc).to(dev), torch.from_numpy(q_valid).to(dev),
                torch.from_numpy(q_labels).to(dev) if self._label_aware else None))

    def _cluster_rounds(self, queries: Sequence[_Query], clusters: Sequence[Sequence],
                        match: Callable, pnp: Callable) -> None:
        """Round ci takes each query's ci-th non-empty cluster until one is
        accepted: `match(ci, work)` gives the matches [D, K] of work [(query,
        ci, cluster)]; 2D-3D assembly; `pnp(ci, items)` of the items [(mkpq,
        mp3d, cam8)] with 8 correspondences, in one call; the consensus
        gates. A query left without a pose takes its best single-image pose
        if it has 10 inliers, else the pose of its first candidate."""
        cfg = self.cfg
        for ci in range(max(map(len, clusters), default=0)):
            work = [(q, ci, cl[ci]) for q, cl in zip(queries, clusters)
                    if q.pose is None and ci < len(cl) and cl[ci]]
            items, ctx = [], []
            for (q, _, cluster), m in zip(work, match(ci, work) if work else ()):
                mp3d, mkpq, p3d_rows, q_ids, per_db = self._assemble_2d3d(
                    q.kpq, m[: len(cluster)], cluster, obs_th=3)
                if len(mp3d) < 8:
                    q.log += f"cluster {ci}: only {len(mp3d)} matches, skip\n"
                    continue
                items.append((mkpq, mp3d, q.cam8))
                ctx.append((q, cluster, p3d_rows, q_ids, per_db))
            for (q, cluster, p3d_rows, q_ids, per_db), (qv, tv, inliers, num, success) in zip(
                    ctx, pnp(ci, items) if items else ()):
                if not success:
                    q.log += f"cluster {ci}: PnP failed\n"
                    continue
                best_single, best_db = _best_single(cfg, inliers, q_ids, p3d_rows, per_db, cluster)
                if best_single >= 8 and num > (q.best.num if q.best else 0):
                    q.best = _Pose(best_db, qv, tv, num, "best_fallback")
                if num < cfg.inlier_thresh or best_single < 10:
                    q.log += f"cluster {ci}: weak ({best_single}/{num} inliers)\n"
                    continue
                q.log += f"cluster {ci}: accepted ({best_single}/{num} inliers)\n"
                q.pose = _Pose(best_db, qv, tv, num, "accepted")
        for q, cl in zip(queries, clusters):
            if q.pose is None and q.best is not None and q.best.num >= 10:
                q.pose = q.best
            elif q.pose is None:
                top = self.map.images[cl[0][0]]
                q.log += f"failed; using pose of {top.name}\n"
                q.result = QueryResult(np.array(top.qvec), np.array(top.tvec), -1, q.log,
                                       source="retrieval_fallback")

    def _refine(self, pool: Sequence[_Query], match: Callable, pnp: Callable) -> None:
        """``pose_refinement_covisibility`` of each query's pose, every stage
        once for the pool: expand frames, `match` (query i against frames[i]:
        [Q, D, K]), gate by reprojection radius, `pnp` of the items [(mkpq,
        mp3d, cam8)] at opt_thresh, then iters× re-select + LM. Sets every
        query's result."""
        cfg = self.cfg
        frames = [_covis_frames(self.map, cfg, q.pose.db_id, q.pose.qvec, q.pose.tvec)
                  for q in pool]
        items, ctx = [], []
        for q, m, ids in zip(pool, match(frames), frames):
            mp3d, mkpq, _, _, _ = self._assemble_2d3d(
                q.kpq, m[: len(ids)], ids, cfg.obs_thresh,
                gate_pose=(q.pose.qvec, q.pose.tvec), cam8=q.cam8, radius=cfg.radius)
            q.log += f"covis refine: {len(ids)} frames, {len(mkpq)} matches\n"
            if len(mkpq) < 6:
                q.finish(q.pose.qvec, q.pose.tvec, q.kept_num, "too few matches, keep pose\n")
                continue
            items.append((mkpq, mp3d, q.cam8))
            ctx.append(q)
        if not items:
            return
        lm_items, lm_ctx = [], []
        for q, (mkpq, mp3d, cam8), (qv, tv, inl, num, success) in zip(ctx, items, pnp(items)):
            if not success:
                q.finish(q.pose.qvec, q.pose.tvec, q.kept_num,
                         "refinement RANSAC failed, keep pose\n")
            elif "ref" in cfg.opt_type and inl.sum() >= 10:
                lm_items.append((qv, tv, mkpq, mp3d, inl, cam8))
                lm_ctx.append((q, num))
            else:
                q.finish(qv, tv, num)
        if not lm_items:
            return
        out = self._refine_batch(lm_items, _bucket(len(lm_items)))
        for row, (qv, tv, *_), (q, num) in zip(out, lm_items, lm_ctx):
            if int(row[7]) > 0:  # qvec, tvec, num, then the inliers of each iteration
                qv, tv, num = row[:4].astype(np.float64), row[4:7].astype(np.float64), int(row[7])
            q.finish(qv, tv, num, "".join(f"iter {it + 1}: {int(n)} inliers\n"
                                          for it, n in enumerate(row[8:8 + cfg.iters]) if n >= 0))

    def localize(self, qname: str, qinfo, clusters: Sequence[Sequence[int]]) -> QueryResult:
        """``pose_from_cluster_with_matcher`` over candidate clusters (each a
        list of DB image ids, e.g. singletons for init_type='sng'). The first
        cluster is matched alone (easy queries stop there); on the first miss
        all remaining candidates are matched in one launch. Clusters are
        numbered with the empty ones counted; cluster ci's PnP is seeded ci,
        the refinement's 1."""
        with span("engine.localize"):
            cfg = self.cfg
            q = self._query(qname, qinfo)
            desc, valid, labels = q.dev
            match_of: Dict[int, np.ndarray] = {}

            def match(ci, work):
                cluster = work[0][2]
                if not all(iid in match_of for iid in cluster):
                    todo = sorted({iid for c in clusters[ci:] for iid in c if iid not in match_of}
                                  ) if ci > 0 else sorted(set(cluster))
                    match_of.update(zip(todo, self._match_query_to_dbs(desc, valid, todo, labels)))
                return [np.stack([match_of[iid] for iid in cluster])]

            self._cluster_rounds([q], [clusters], match, lambda ci, items: [
                self._run_pnp(*items[0], cfg.ransac_thresh, seed=ci)])
            if q.pose is None:
                return q.result
            if self._refines:
                with span("engine.refine_covis"):
                    self._refine([q], lambda frames: [self._match_query_to_dbs(
                        desc, valid, frames[0], labels)],
                        lambda items: [self._run_pnp(*items[0], cfg.opt_thresh, seed=1)])
            else:
                q.finish(q.pose.qvec, q.pose.tvec, q.pose.num)
            if q.pose.source == "best_fallback":  # the JAX engine reports no count for it
                q.result.num_inliers = 0
            return q.result

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
            entries += [self._bank(i) for i in banks] + [zero] * (d - len(banks))
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
        """Batched-across-queries localization: the rules of ``localize``,
        but every device stage (matching, PnP-RANSAC, the refinement) runs
        once for all still active queries. Cluster rounds go in lockstep:
        round ci matches every remaining query's ci-th non-empty cluster,
        and queries accept or drop out on their own; the covisibility
        refinement pool is matched and refined the same way. Query i's
        hypotheses come from ``fold_seed(1000 + ci, i)`` and, in the
        refinement, ``fold_seed(77, i)`` generators, so poses agree with
        ``localize``'s to RANSAC's noise, not bit for bit. A pose the
        refinement keeps, or that is not refined, reports the best PnP
        count."""
        cfg = self.cfg
        queries = [self._query(qname, qinfo) for qname, qinfo, _ in jobs]
        self._cluster_rounds(
            queries, [[c for c in cl if c] for _, _, cl in jobs],
            lambda ci, work: self._batched_match([q.dev for q, _, _ in work],
                                                 [c for _, _, c in work]),
            lambda ci, items: self._batched_pnp(items, cfg.ransac_thresh, seed_base=1000 + ci))
        pool = [q for q in queries if q.result is None]
        for q in pool:
            q.kept_num = q.best.num
        if self._refines and pool:
            self._refine(pool, lambda frames: self._batched_match([q.dev for q in pool], frames),
                         lambda items: self._batched_pnp(items, cfg.opt_thresh, seed_base=77))
        else:
            for q in pool:
                q.finish(q.pose.qvec, q.pose.tvec, q.kept_num)
        return [q.result for q in queries]
