"""Feature-track building from verified pairwise matches (host, numpy).

Port of ``sfd2_tpu/sfm/tracks.py``: the track-building stage inside
COLMAP's ``point_triangulator`` (``hloc/triangulation.py:129-147``) —
chaining verified two-view matches into multi-view tracks. Union-find
with path halving over (image, keypoint) observation nodes; a track that
observes one image twice keeps the first observation (COLMAP's conflict
handling). The JAX package runs the union-find in an optional C++
helper (union by rank) and falls back to a Python loop without ranks,
whose roots, and so the order of the tracks, differ; the port runs the
C++ helper's rule in Python, so it lists the tracks as the JAX package
does with its helper.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class UnionFind:
    """Union by rank with path halving: the rule of the JAX package's C++
    helper (``native/tracks.cpp``), so the roots — and the order of the
    tracks — are the ones the JAX package produces."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]  # path halving
            i = p[i]
        return i

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        rank = self.rank
        if rank[ra] < rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if rank[ra] == rank[rb]:
            rank[ra] += 1


def union_find_roots(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Root id per node after uniting the [E, 2] edges in order."""
    dsu = UnionFind(n_nodes)
    union, find = dsu.union, dsu.find
    for a, b in np.asarray(edges, np.int64).reshape(-1, 2).tolist():
        union(a, b)
    return np.fromiter((find(i) for i in range(n_nodes)), np.int64, n_nodes)


def build_tracks(num_keypoints: Dict[int, int],
                 verified_matches: Sequence[Tuple[int, int, np.ndarray]],
                 min_track_length: int = 2) -> List[List[Tuple[int, int]]]:
    """Chain matches into tracks.

    Args:
      num_keypoints: image_id → #keypoints.
      verified_matches: (image_id0, image_id1, matches [M, 2] kp-index
        pairs) per verified image pair.
      min_track_length: minimum observations to keep a track.

    Returns the tracks, each a list of (image_id, kp_idx) with at most one
    observation per image (its lowest keypoint index), in order of their
    union-find root.
    """
    image_ids = sorted(num_keypoints.keys())
    counts = np.array([num_keypoints[iid] for iid in image_ids], np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    offsets = dict(zip(image_ids, bounds[:-1].tolist()))
    total = int(bounds[-1])

    edge_list = [np.asarray(m, np.int64) + np.array([offsets[a], offsets[b]], np.int64)
                 for a, b, m in verified_matches if len(m)]
    edges = np.concatenate(edge_list) if edge_list else np.zeros((0, 2), np.int64)
    roots = union_find_roots(total, edges)

    # Nodes grouped by root (groups in root order, nodes ascending inside a
    # group: the sort is stable), then the first node of each image run.
    order = np.argsort(roots, kind="stable")
    group = roots[order]
    img_pos = np.searchsorted(bounds, order, side="right") - 1
    new_group = np.ones(total, bool)
    new_group[1:] = group[1:] != group[:-1]
    keep = new_group.copy()
    keep[1:] |= img_pos[1:] != img_pos[:-1]
    starts = np.nonzero(new_group)[0]
    track_of = np.cumsum(new_group) - 1
    lengths = np.bincount(track_of[keep], minlength=len(starts))

    kept = np.nonzero(keep)[0]
    iids = np.asarray(image_ids, np.int64)[img_pos[kept]].tolist()
    kps = (order[kept] - bounds[img_pos[kept]]).tolist()
    tracks: List[List[Tuple[int, int]]] = []
    pos = 0
    for n in lengths.tolist():
        if n >= min_track_length:
            tracks.append(list(zip(iids[pos:pos + n], kps[pos:pos + n])))
        pos += n
    return tracks


def build_tracks_arrays(n_images: int, kp_per_image: int, edges: np.ndarray,
                        min_track_length: int = 2):
    """Vectorised track builder for reconstruction-scale graphs: the
    semantics of :func:`build_tracks`, with nodes ``image_row *
    kp_per_image + kp_idx`` and flat output arrays instead of per-track
    lists. Returns ``(obs_img_row, obs_kp, obs_track, n_tracks)`` sorted by
    track id."""
    total = n_images * kp_per_image
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    roots = union_find_roots(total, edges)

    nodes = np.unique(edges)  # only nodes with ≥1 match edge form tracks
    _, track_of = np.unique(roots[nodes], return_inverse=True)
    img = nodes // kp_per_image
    kp = nodes % kp_per_image

    # One observation per (track, image): the first kp of each run.
    order = np.lexsort((kp, img, track_of))
    t_s, i_s, k_s = track_of[order], img[order], kp[order]
    first = np.ones(len(order), bool)
    first[1:] = (t_s[1:] != t_s[:-1]) | (i_s[1:] != i_s[:-1])
    t_s, i_s, k_s = t_s[first], i_s[first], k_s[first]

    # Track-length filter + dense renumbering.
    keep_tracks = np.bincount(t_s) >= min_track_length
    renum = np.cumsum(keep_tracks) - 1
    keep_obs = keep_tracks[t_s]
    return (i_s[keep_obs].astype(np.int32), k_s[keep_obs].astype(np.int32),
            renum[t_s[keep_obs]].astype(np.int64), int(keep_tracks.sum()))
