"""Two-view verification judged by the scene's ground truth.

A pair's matches are judged twice. ``reference/match.py`` holds each
match the matcher returned against float64 mutual nearest neighbours.
Here, what verification kept is held against the ground-truth point of
every keypoint (``Scene.db_point``): a kept match whose two keypoints
observe different points is an outlier that verification let through,
and a match of the same point that verification was given and did not
keep is a true match it dropped.

Verification is given a pair's matches as the mix states: in ascending
order of the first image's keypoint, at most ``max_matches`` of them. A
pair matched in the other direction is read back by inverting its
matches, which mutual matching makes one to one.
"""

from __future__ import annotations

import numpy as np


def given_matches(matches: np.ndarray, reversed_: bool, max_matches: int) -> np.ndarray:
    """[n, 2] (keypoint of image 0, keypoint of image 1) that verification
    reads of `matches`, the matcher's [K] answer (−1: none) for the pair as
    listed or, with `reversed_`, for the pair the other way round."""
    m = np.asarray(matches, np.int64)
    src = np.nonzero(m >= 0)[0]
    pairs = np.stack([src, m[src]], 1)
    if reversed_:
        pairs = pairs[:, ::-1]
        pairs = pairs[np.argsort(pairs[:, 0], kind="stable")]
    return pairs[:max_matches]


def verification_counts(point0: np.ndarray, point1: np.ndarray, given: np.ndarray,
                        kept: np.ndarray | None) -> tuple:
    """(kept, kept outliers, true matches given, true matches dropped) of
    one pair; `point0`, `point1` [K]: each keypoint's ground-truth point or
    −1; `kept` [m, 2] keypoint pairs, None where the pair was not kept."""
    kept = np.zeros((0, 2), np.int64) if kept is None else np.asarray(kept, np.int64)
    same_k = (point0[kept[:, 0]] == point1[kept[:, 1]]) & (point0[kept[:, 0]] >= 0)
    same_g = (point0[given[:, 0]] == point1[given[:, 1]]) & (point0[given[:, 0]] >= 0)
    k1 = len(point1)
    kept_keys = np.unique(kept[:, 0] * k1 + kept[:, 1])
    true_keys = given[same_g, 0] * k1 + given[same_g, 1]
    dropped = int((~np.isin(true_keys, kept_keys)).sum())
    return len(kept), int((~same_k).sum()), int(same_g.sum()), dropped
