"""SuperPoint detector/descriptor network (PyTorch).

Port of ``sfd2_tpu/models/superpoint.py`` (``nets/superpoint.py:7``
SuperPointNet): VGG-style grayscale encoder with 2×2 max-pools, a
65-channel detector head normalised by ``exp`` (+1e-5, no max
subtraction, as the reference) and an 8×8 pixel-shuffle, and a 256-D
descriptor head. Internals are NCHW; inputs are NHWC ``[B, H, W, 1]`` and
the outputs are the JAX package's layouts (``scores`` [B, H, W], the other
maps [B, H/8, W/8, C]). Parameters carry the names of the public
``superpoint_v1.pth``, so that checkpoint loads by name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.convert import float_state_dict
from sfd2_torch.models.sfd2 import _pixel_shuffle_score

_CONVS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
          ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128),
          ("conv4b", 128, 128), ("convPa", 128, 256), ("convDa", 128, 256))


class SuperPoint(nn.Module):
    """Input [B, H, W, 1] grayscale in [0, 1]; H, W divisible by 8."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDb = nn.Conv2d(256, 256, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        for stage in ("1", "2", "3", "4"):
            x = F.relu(getattr(self, f"conv{stage}a")(x))
            x = F.relu(getattr(self, f"conv{stage}b")(x))
            if stage != "4":
                x = F.max_pool2d(x, 2, 2)
        semi = torch.exp(self.convPb(F.relu(self.convPa(x))).float())
        semi_norm = semi / (torch.sum(semi, dim=1, keepdim=True) + 1e-5)
        desc = self.convDb(F.relu(self.convDa(x))).float()
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)
        semi_nhwc = semi_norm.permute(0, 2, 3, 1)
        return {
            "scores": _pixel_shuffle_score(semi_norm),  # [B, H, W]
            "semi_norm": semi_nhwc,  # [B, H/8, W/8, 65]
            "semi": semi_nhwc[..., :64],  # dustbin dropped
            "descs": desc.permute(0, 2, 3, 1),  # [B, H/8, W/8, 256]
        }


def convert_superpoint(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``superpoint_v1.pth`` state_dict (prefixes stripped or not) → the
    port's: the same names, float32."""
    return float_state_dict(state)
