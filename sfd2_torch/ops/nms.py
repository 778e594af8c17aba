"""Non-maximum suppression on dense score maps (PyTorch max-pool).

Port of ``sfd2_tpu/ops/nms.py::simple_nms`` (``nets/extractor.py:20``):
iterated max-pool suppression over [B, H, W] maps; and of
``nms_fast_host``, the grid-greedy NMS on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-pool with kernel 2r+1, stride 1, SAME (−inf) padding over [B, H, W]."""
    return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int = 4, iterations: int = 2) -> torch.Tensor:
    """Iterated max-pool NMS; non-maxima scores are zeroed (SuperPoint
    ``simple_nms`` semantics with two refinement rounds)."""
    if nms_radius < 0:
        raise ValueError(nms_radius)
    if nms_radius == 0:
        return scores
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, nms_radius)
    for _ in range(iterations):
        supp_mask = _maxpool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def nms_fast_host(points, scores, h: int, w: int, dist_thresh: int = 4):
    """Host-side grid-greedy NMS (``extract.py:17`` nms_fast): rasterise
    the candidates, visit them in descending score order, and suppress the
    (2r+1)² neighbourhood of each accepted point.

    points [N, 2] (x, y), scores [N] (numpy). Returns the indices of the
    kept points, in descending score."""
    import numpy as np

    grid = -np.ones((h, w), np.int64)
    order = np.argsort(-scores)
    xs = np.clip(np.rint(points[order, 0]).astype(int), 0, w - 1)
    ys = np.clip(np.rint(points[order, 1]).astype(int), 0, h - 1)
    kept = []
    r = dist_thresh
    for oi, x, y in zip(order, xs, ys):
        if grid[y, x] != -1:
            continue
        kept.append(int(oi))
        grid[max(y - r, 0): y + r + 1, max(x - r, 0): x + r + 1] = oi
    return np.array(kept, np.int64)
