"""Bilinear map resize with torch-interpolate semantics.

Port of ``sfd2_tpu/ops/resize.py::resize_bilinear`` on the JAX package's
channels-last layout: [..., H, W, C] (or [..., H, W]) maps. The JAX
version reproduces ``F.interpolate(mode='bilinear')`` without
anti-aliasing; here that call is the implementation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize maps to `size` = (h, w). As in the JAX package, a tensor with
    ndim ≥ 3 is read as channels-last [..., H, W, C] and a 2-D tensor as
    one [H, W] map."""
    if x.ndim < 2:
        raise ValueError("need at least a 2D image")
    if x.ndim == 2:
        return resize_bilinear(x[..., None], size, align_corners)[..., 0]
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(size), mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, size[0], size[1], c)
