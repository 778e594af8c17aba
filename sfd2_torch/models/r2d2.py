"""R2D2-family descriptor networks (PyTorch): Quad_L2Net_ConfCFS and L2-Net.

Port of ``sfd2_tpu/models/r2d2.py`` (``nets/patchnet.py``,
``hloc/extractors/r2d2.py``). Dilated fully-convolutional design: each
stride becomes a growing dilation after its layer, with padding
``((k-1)·d)//2``, so every map stays at full resolution (for the k=2
layers, d is even and the symmetric pad of d/2 keeps the size exactly, as
the JAX package's explicit padding does). BatchNorm is affine-free.
The layers are the reference ``PatchNet.ops`` list (conv, then BN and
ReLU where the plan has them), so a reference checkpoint's ``ops.{i}``,
``clf`` and ``sal`` keys load by name. Inputs are NHWC; outputs are the
JAX package's layouts (``descriptors`` [B, H, W, dim], confidences
[B, H, W]).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.convert import float_state_dict
from sfd2_torch.models.layers import BN_EPS


def _conf(x: torch.Tensor) -> torch.Tensor:
    """BaseNet.softmax over channels of an NCHW map: 1-ch →
    softplus/(1+softplus); 2-ch → softmax[1]. Returns [B, 1, H, W]."""
    if x.shape[1] == 1:
        s = F.softplus(x)
        return s / (1 + s)
    return torch.softmax(x, dim=1)[:, 1:2]


class _DilatedStack(nn.Module):
    """PatchNet conv stack with stride→dilation conversion; ``plan`` holds
    (out, k, stride, bn, relu) per layer."""

    def __init__(self, plan: Tuple[tuple, ...], in_channels: int = 3, bn_affine: bool = False):
        super().__init__()
        self.ops = nn.ModuleList()
        dilation, cin = 1, in_channels
        for out, k, stride, bn, relu in plan:
            d = dilation
            self.ops.append(nn.Conv2d(cin, out, k, padding=((k - 1) * d) // 2, dilation=d))
            dilation *= stride
            if bn:
                self.ops.append(nn.BatchNorm2d(out, eps=BN_EPS, affine=bn_affine))
            if relu:
                self.ops.append(nn.ReLU())
            cin = out

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → NCHW features."""
        x = x.permute(0, 3, 1, 2)
        for op in self.ops:
            x = op(x)
        return x


def _quad_l2net_plan(dim: int = 128, mchan: int = 4) -> Tuple[tuple, ...]:
    def c(out, k=3, stride=1, bn=True, relu=True):
        return (out, k, stride, bn, relu)

    return (
        c(8 * mchan),
        c(8 * mchan),
        c(16 * mchan, stride=2),
        c(16 * mchan),
        c(32 * mchan, stride=2),
        c(32 * mchan),
        c(32 * mchan, k=2, stride=2, relu=False),
        c(32 * mchan, k=2, stride=2, relu=False),
        c(dim, k=2, stride=2, bn=False, relu=False),
    )


def _normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True), min=1e-12)


class QuadL2NetConfCFS(_DilatedStack):
    """Quad_L2Net_ConfCFS: trunk + reliability (2-ch from desc²) and
    repeatability (1-ch) heads. Returns full-resolution maps."""

    def __init__(self, dim: int = 128, mchan: int = 4):
        super().__init__(_quad_l2net_plan(dim, mchan))
        self.clf = nn.Conv2d(dim, 2, 1)
        self.sal = nn.Conv2d(dim, 1, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.trunk(x)
        sq = feats ** 2
        return {
            "descriptors": _normalize(feats).permute(0, 2, 3, 1),
            "reliability": _conf(self.clf(sq))[:, 0],
            "repeatability": _conf(self.sal(sq))[:, 0],
        }


def _l2net_plan(dim: int) -> Tuple[tuple, ...]:
    def c(out, k=3, stride=1, bn=True, relu=True):
        return (out, k, stride, bn, relu)

    return (c(32), c(32), c(64, stride=2), c(64), c(128, stride=2), c(128),
            c(dim, k=7, stride=8, bn=False, relu=False))


class L2Net(_DilatedStack):
    """Original L2-Net, always dilated → full-resolution ``dim``-D map."""

    def __init__(self, dim: int = 128):
        super().__init__(_l2net_plan(dim))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"descriptors": _normalize(self.trunk(x)).permute(0, 2, 3, 1)}


def convert_r2d2(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference r2d2 checkpoint's ``state_dict`` (``ops.{i}``, ``clf``,
    ``sal``; ``module.`` prefixes stripped or not) → the port's, float32
    (the BN counters int64)."""
    return float_state_dict(state)
