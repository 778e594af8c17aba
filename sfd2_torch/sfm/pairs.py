"""Candidate-pair generation (retrieval / covisibility / pose distance).

Port of ``sfd2_tpu/sfm/pairs.py``: ``hloc/pairs_from_retrieval.py``
(top-k global descriptor similarity, one matrix product),
``hloc/pairs_from_covisibility.py`` (top-k shared-3D-point counts) and
``hloc/pairs_from_poses.py`` (nearest camera centers with a rotation
gate). Host-side numpy: the work is small next to matching.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from sfd2_torch.geometry.np_pose import camera_center, qvec_to_rotmat
from sfd2_torch.sfm.map_index import MapIndex


def pairs_from_retrieval(query_names: Sequence[str], query_desc: np.ndarray,
                         db_names: Sequence[str], db_desc: np.ndarray, num_matched: int = 20,
                         allow_self: bool = False) -> List[Tuple[str, str]]:
    """Top-k DB entries by dot-product similarity; query_desc [Q, D],
    db_desc [N, D] global descriptors."""
    sim = np.asarray(query_desc, np.float32) @ np.asarray(db_desc, np.float32).T
    if not allow_self:
        for qi, qn in enumerate(query_names):
            for di, dn in enumerate(db_names):
                if qn == dn:
                    sim[qi, di] = -np.inf
    pairs = []
    k = min(num_matched, len(db_names))
    top = np.argsort(-sim, axis=1)[:, :k]
    for qi, qn in enumerate(query_names):
        for di in top[qi]:
            if np.isfinite(sim[qi, di]):
                pairs.append((qn, db_names[int(di)]))
    return pairs


def pairs_from_covisibility(map_index: MapIndex, num_matched: int = 20) -> List[Tuple[str, str]]:
    """For every DB image, its top-k most covisible companions
    (shared-3D-point counting, ``pairs_from_covisibility.py:20-28``)."""
    pairs = []
    inc = map_index.incidence
    covis = (inc @ inc.T).toarray()
    np.fill_diagonal(covis, 0)
    for r, name in enumerate(map_index.names):
        order = np.argsort(-covis[r])
        taken = 0
        for c in order:
            if covis[r, c] <= 0 or taken >= num_matched:
                break
            pairs.append((name, map_index.names[int(c)]))
            taken += 1
    return pairs


def pairs_from_poses(images: Dict, num_matched: int = 20,
                     rotation_threshold_deg: float = 30.0) -> List[Tuple[str, str]]:
    """Nearest camera centers, gated by viewing-direction angle
    (``pairs_from_poses.py:12``)."""
    ids = sorted(images.keys())
    centers = np.stack([camera_center(images[i].qvec, images[i].tvec) for i in ids])
    # Optical axes: cam z in world = Rᵀ e_z, the third row of R.
    axes = np.stack([qvec_to_rotmat(images[i].qvec)[2] for i in ids])
    d2 = np.sum((centers[:, None] - centers[None, :]) ** 2, axis=-1)
    ang = np.degrees(np.arccos(np.clip(axes @ axes.T, -1.0, 1.0)))
    invalid = ang > rotation_threshold_deg
    np.fill_diagonal(invalid, True)
    d2[invalid] = np.inf
    pairs = []
    for r, iid in enumerate(ids):
        for c in np.argsort(d2[r])[:num_matched]:
            if np.isfinite(d2[r, c]):
                pairs.append((images[iid].name, images[ids[int(c)]].name))
    return pairs
