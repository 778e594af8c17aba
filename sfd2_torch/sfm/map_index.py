"""Indexed in-memory 3D map: vectorised covisibility queries.

Port of ``sfd2_tpu/sfm/map_index.py``; the module is host-side numpy and
scipy, so the port's copy keeps its code as it was.

Capability parity: the per-query graph logic of ``it_loc/localize_cv2.py``
— ``do_covisibility_clustering:87`` (BFS over shared 3D points),
``get_covisibility_frames:120`` (obs-sorted covisible frames with a
30°/30m/obs>30 pose gate and backfill) and
``get_covisibility_frames_by_pose:172`` (pose-distance-sorted frames,
obs backfill). The reference walks python dicts per 3D point; here the
image↔point incidence is a scipy CSR matrix built once, so covisibility
counts are sparse mat-vecs — orders of magnitude faster per query and
the natural feed for block-sharded BA later.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp

from sfd2_torch.geometry.np_pose import pose_error


class MapIndex:
    """Built from COLMAP-model dicts (see ``sfd2_torch.io.colmap_model``)."""

    def __init__(self, cameras: Dict, images: Dict, points3d: Dict):
        self.cameras = cameras
        self.images = images
        self.points3d = points3d

        self.image_ids = np.array(sorted(images.keys()), dtype=np.int64)
        self.image_row = {int(i): r for r, i in enumerate(self.image_ids)}
        self.names = [images[i].name for i in self.image_ids]
        self.name_to_image_id = {images[i].name: int(i) for i in self.image_ids}

        self.point_ids = np.array(sorted(points3d.keys()), dtype=np.int64)
        self.point_row = {int(p): r for r, p in enumerate(self.point_ids)}
        n_pts = len(self.point_ids)
        self.point_xyz = np.zeros((n_pts, 3), np.float64)
        self.track_len = np.zeros(n_pts, np.int32)
        for r, pid in enumerate(self.point_ids):
            pt = points3d[pid]
            self.point_xyz[r] = pt.xyz
            self.track_len[r] = len(pt.image_ids)

        # Per-image arrays aligned with keypoint order.
        self.p3d_rows_per_image: List[np.ndarray] = []  # -1 = unobserved
        rows, cols = [], []
        for r, iid in enumerate(self.image_ids):
            pids = images[iid].point3D_ids
            prow = np.full(len(pids), -1, np.int64)
            mask = pids != -1
            if mask.any():
                prow[mask] = [self.point_row[int(p)] for p in pids[mask]]
            self.p3d_rows_per_image.append(prow)
            obs = np.unique(prow[prow >= 0])
            rows.extend([r] * len(obs))
            cols.extend(obs.tolist())

        data = np.ones(len(rows), np.int32)
        self.incidence = sp.csr_matrix(
            (data, (rows, cols)), shape=(len(self.image_ids), n_pts)
        )
        self._incidence_t = self.incidence.T.tocsr()

        self.qvecs = np.stack([images[i].qvec for i in self.image_ids])
        self.tvecs = np.stack([images[i].tvec for i in self.image_ids])

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        cameras: Dict,
        images: Dict,
        prow_per_image: Dict[int, np.ndarray],
        point_xyz: np.ndarray,
        track_len: np.ndarray,
    ) -> "MapIndex":
        """Vectorised constructor for reconstruction-scale maps.

        ``__init__`` walks COLMAP-style dicts with per-keypoint python
        lookups — ~10⁷ dict hits at Aachen scale (6.7k images × 4k kp,
        the map the reference localizes against). Here the per-image
        3D-point-row tables (−1 = unobserved; row index == point id) and
        the point arrays are given directly, so the incidence CSR is one
        ``np.unique`` over packed (image, point) keys. ``points3d`` is
        left empty: every query-path consumer reads the row-indexed
        arrays (`point_xyz`, `track_len`, `p3d_rows_per_image`,
        `incidence`), not the dict.
        """
        self = cls.__new__(cls)
        self.cameras = cameras
        self.images = images
        self.points3d = {}

        self.image_ids = np.array(sorted(images.keys()), dtype=np.int64)
        self.image_row = {int(i): r for r, i in enumerate(self.image_ids)}
        self.names = [images[i].name for i in self.image_ids]
        self.name_to_image_id = {images[i].name: int(i)
                                 for i in self.image_ids}

        n_pts = len(point_xyz)
        self.point_ids = np.arange(n_pts, dtype=np.int64)
        self.point_row = None  # identity mapping at scale; unused here
        self.point_xyz = np.asarray(point_xyz, np.float64)
        self.track_len = np.asarray(track_len, np.int32)

        self.p3d_rows_per_image = [
            np.asarray(prow_per_image[int(i)], np.int64)
            for i in self.image_ids
        ]
        keys = np.concatenate([
            r * n_pts + prow[prow >= 0]
            for r, prow in enumerate(self.p3d_rows_per_image)
        ]) if n_pts else np.zeros(0, np.int64)
        keys = np.unique(keys)
        rows = (keys // n_pts).astype(np.int64) if n_pts else keys
        cols = (keys % n_pts).astype(np.int64) if n_pts else keys
        self.incidence = sp.csr_matrix(
            (np.ones(len(keys), np.int32), (rows, cols)),
            shape=(len(self.image_ids), n_pts),
        )
        self._incidence_t = self.incidence.T.tocsr()

        self.qvecs = np.stack([images[i].qvec for i in self.image_ids])
        self.tvecs = np.stack([images[i].tvec for i in self.image_ids])
        return self

    # ------------------------------------------------------------------
    def observed_point_rows(self, image_id: int) -> np.ndarray:
        prow = self.p3d_rows_per_image[self.image_row[image_id]]
        return np.unique(prow[prow >= 0])

    def images_seeing(self, point_rows: np.ndarray) -> np.ndarray:
        """Image ids observing any of the given point rows."""
        if len(point_rows) == 0:
            return np.array([], np.int64)
        sel = np.zeros(self.incidence.shape[1], np.int32)
        sel[point_rows] = 1
        counts = self.incidence @ sel
        return self.image_ids[np.nonzero(counts)[0]]

    def covisibility_counts(
        self, point_rows: np.ndarray, obs_th: int = 0
    ) -> Dict[int, int]:
        """#covisible points (track_len ≥ obs_th) per connected image id."""
        if len(point_rows) == 0:
            return {}
        keep = point_rows[self.track_len[point_rows] >= obs_th]
        sel = np.zeros(self.incidence.shape[1], np.int32)
        sel[keep] = 1
        counts = self.incidence @ sel
        nz = np.nonzero(counts)[0]
        return {int(self.image_ids[r]): int(counts[r]) for r in nz}

    # ------------------------------------------------------------------
    def covisibility_clustering(self, frame_ids: Sequence[int]) -> List[List[int]]:
        """Connected components of the covisibility graph restricted to
        `frame_ids`, largest first (``do_covisibility_clustering``)."""
        frame_set = set(int(f) for f in frame_ids)
        visited = set()
        clusters: List[List[int]] = []
        for fid in frame_ids:
            fid = int(fid)
            if fid in visited:
                continue
            clusters.append([])
            queue = {fid}
            while queue:
                cur = queue.pop()
                if cur in visited:
                    continue
                visited.add(cur)
                clusters[-1].append(cur)
                obs = self.observed_point_rows(cur)
                connected = set(int(i) for i in self.images_seeing(obs))
                queue |= (connected & frame_set) - visited
        return sorted(clusters, key=len, reverse=True)

    # ------------------------------------------------------------------
    def covis_frames_obs(
        self,
        frame_id: int | None,
        covisibility_frame: int = 50,
        obs_th: int = 0,
        pred_qvec=None,
        pred_tvec=None,
        ref_point_rows: np.ndarray | None = None,
        q_gate: float = 30.0,
        t_gate: float = 30.0,
        obs_gate: int = 30,
    ) -> List[int]:
        """Reference ``get_covisibility_frames``: rank connected frames by
        covisible-observation count; with a predicted pose, gate frames at
        q/t error < 30°/30m and obs > 30, backfilling gated-out frames if
        fewer than 4 survive."""
        if ref_point_rows is None:
            ref_point_rows = self.observed_point_rows(frame_id)
        counts = self.covisibility_counts(ref_point_rows, obs_th)
        order = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)

        valid: List[int] = []
        rejected: List[int] = []
        for iid, cnt in order:
            if pred_qvec is not None and pred_tvec is not None:
                row = self.image_row[iid]
                qe, te = pose_error(pred_qvec, pred_tvec, self.qvecs[row], self.tvecs[row])
                if qe >= q_gate or te >= t_gate or cnt <= obs_gate:
                    rejected.append(iid)
                    continue
            valid.append(iid)
            if covisibility_frame > 0 and len(valid) >= covisibility_frame:
                break
        if len(valid) <= 3:
            for iid in rejected:
                valid.append(iid)
                if len(valid) >= covisibility_frame:
                    break
        return valid

    def covis_frames_pose(
        self,
        frame_id: int | None,
        pred_qvec,
        pred_tvec,
        covisibility_frame: int = 50,
        q_th: float = 10.0,
        t_th: float = 10.0,
        obs_th: int = 5,
        ref_point_rows: np.ndarray | None = None,
        name_excludes: Sequence[str] = ("left", "right"),
    ) -> List[int]:
        """Reference ``get_covisibility_frames_by_pose``: frames within a
        rotation gate ranked by camera-center distance, backfilled by
        covisible-observation order. Side-facing RobotCar frames are
        excluded by name (reference hardcodes 'left'/'right')."""
        if ref_point_rows is None:
            ref_point_rows = self.observed_point_rows(frame_id)
        counts = self.covisibility_counts(ref_point_rows, obs_th)

        gated = []
        for iid, cnt in counts.items():
            row = self.image_row[iid]
            name = self.names[row]
            if any(s in name for s in name_excludes):
                continue
            qe, te = pose_error(pred_qvec, pred_tvec, self.qvecs[row], self.tvecs[row])
            if qe > q_th:
                continue
            gated.append((iid, te))
        gated.sort(key=lambda x: x[1])
        valid = [iid for iid, _ in gated[: covisibility_frame if covisibility_frame > 0 else None]]
        if covisibility_frame > 0 and len(valid) >= covisibility_frame:
            return valid
        for iid, _ in sorted(counts.items(), key=lambda kv: kv[1], reverse=True):
            if iid in valid:
                continue
            valid.append(iid)
            if covisibility_frame > 0 and len(valid) >= covisibility_frame:
                break
        return valid
