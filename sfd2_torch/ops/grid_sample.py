"""Bilinear point sampling on dense feature maps (gathers).

Port of ``sfd2_tpu/ops/grid_sample.py``: sampling at K keypoints is a
gather of 4 neighbours + lerp, the semantics of ``F.grid_sample``
(``nets/extractor.py:206``) in pixel units; ``grid_sample_bilinear`` takes
torch's normalised grid (the training losses' flow warps).
"""

from __future__ import annotations

import torch


def sample_at_points(fmap: torch.Tensor, xy: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinearly sample `fmap` [H, W, C] at pixel coords `xy` [..., 2]
    (0..W-1 / 0..H-1 at pixel centers). `padding_mode` 'zeros' drops
    out-of-range taps, 'border' clamps them."""
    h, w, _ = fmap.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        vals = fmap[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if padding_mode == "zeros":
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            vals = torch.where(inside[..., None], vals, 0.0)
        return vals

    return (tap(y0i, x0i) * (1 - wx) * (1 - wy)
            + tap(y0i, x0i + 1) * wx * (1 - wy)
            + tap(y0i + 1, x0i) * (1 - wx) * wy
            + tap(y0i + 1, x0i + 1) * wx * wy)



def grid_sample_bilinear(fmap: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """torch-style grid_sample on one image: `fmap` [H, W, C], `grid`
    [..., 2] normalised (x, y) in [-1, 1] → [..., C] samples."""
    h, w, _ = fmap.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        px = (gx + 1) * 0.5 * (w - 1)
        py = (gy + 1) * 0.5 * (h - 1)
    else:
        px = ((gx + 1) * w - 1) * 0.5
        py = ((gy + 1) * h - 1) * 0.5
    return sample_at_points(fmap, torch.stack([px, py], -1), padding_mode)
