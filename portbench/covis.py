"""The benchmark's covisibility pair rule, frozen.

hloc's ``pairs_from_covisibility`` (``hloc/pairs_from_covisibility.py``):
each DB image is paired with the ``num_matched`` DB images that share the
most 3D points with it, in descending order of that count; images that
share none are never paired. The list keeps its own order, image by
image. Counts here come from the scene's ground-truth observations
(``Scene.db_point``) in place of a triangulated model's. hloc leaves the
order of equal counts to ``argpartition``; here the lower image index
comes first, so that the list is a function of the seed alone.

The counts are exact: the observations are sorted by point, and for each
distance s along that order the pairs of observations s apart that see
the same point are counted into a dense [N, N] table on the device, for
every s up to the longest track.
"""

from __future__ import annotations

import numpy as np
import torch


def covisibility_counts(db_point: np.ndarray, device) -> torch.Tensor:
    """[N, N] int64 on `device`: the points images i and j both observe
    (0 on the diagonal). `db_point` [N, K]: each keypoint's point or −1;
    an image observes a point at most once."""
    n = len(db_point)
    obs = torch.from_numpy(np.ascontiguousarray(db_point)).to(device)
    image = torch.arange(n, device=obs.device)[:, None].expand_as(obs)
    seen = obs >= 0
    point, order = torch.sort(obs[seen], stable=True)
    image = image[seen][order]
    counts = torch.zeros(n * n, dtype=torch.int64, device=obs.device)
    s = 1
    while s < len(point):
        same = point[s:] == point[:-s]
        if not bool(same.any()):
            break  # sorted by point: no track is longer than s
        a, b = image[:-s][same], image[s:][same]
        counts += torch.bincount(a * n + b, minlength=n * n)
        counts += torch.bincount(b * n + a, minlength=n * n)
        s += 1
    return counts.view(n, n)


def pairs_from_covisibility(db_point: np.ndarray, num_matched: int, device) -> np.ndarray:
    """[M, 2] int64 rows (i, j) of DB images: for each i in order, its
    `num_matched` most covisible images j, most shared points first, the
    lower index first among equal counts."""
    counts = covisibility_counts(db_point, device)
    n = counts.shape[0]
    k = min(num_matched, max(n - 1, 0))
    if k == 0:
        return np.zeros((0, 2), np.int64)
    # One key per (count, j): descending count, then ascending j.
    key = counts * n + (n - 1 - torch.arange(n, device=counts.device))[None]
    top = torch.topk(key, k, dim=1).indices
    shared = torch.gather(counts, 1, top)
    rows = torch.arange(n, device=counts.device)[:, None].expand_as(top)
    keep = shared > 0
    return torch.stack([rows[keep], top[keep]], 1).cpu().numpy()
