"""ResSegNet / ResSegNetV2 — the SFD2 detector/descriptor network (PyTorch).

Port of ``sfd2_tpu/models/sfd2.py``. Architecture:

  encoder   conv1a→conv1b(s2)→bn1b | conv2a→conv2b(s2)→bn2b |
            conv3a→conv3b→bn3b     | 3× grouped ResBlock      → out4 @1/4 res
  detector  convPa (s2 → 1/8 res) → convPb → 65-ch "semi" →
            exp-normalise (+1e-5) → drop dustbin → 8×8 pixel-shuffle
  descriptor convDa → convDb → L2-normalised [*, h/4, w/4, outdim]
  stability ConvSta on out4 → bilinear upsample → (V2) first-max class →
            {0.1, 0.5, 1.0}; (V1) sigmoid

Internals are NCHW; the public layouts are the JAX package's: inputs
NHWC ``[B, H, W, 3]``, ``score``/``stability`` ``[B, H, W]``,
``descriptors`` NHWC ``[B, h, w, outdim]``. Parameters carry the
reference checkpoint's names. When the parameters are bfloat16 the trunk
runs in bfloat16 and the heads' outputs are taken in float32.

``forward(x, training_outputs=True)`` is the ``det_train`` contract
(``nets/sfd2.py:356-402``) the trainer calls in train mode (BatchNorm on
batch statistics): it adds the normalised 65-channel ``semi`` map, the
softmax of the upsampled stability logits and, with ``require_feature``,
the encoder features ``(out2c, out3c)``; V2 folds ``score *= stability``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.layers import BNRelu, ConvBNReluConv, ConvUnit, ResBlock


class DetectionOutput(NamedTuple):
    score: torch.Tensor  # [B, H, W] full-res detection heatmap
    stability: Optional[torch.Tensor]  # [B, H, W] {0.1,0.5,1.0} (V2) / sigmoid (V1)
    descriptors: torch.Tensor  # [B, h/4, w/4, outdim], L2-normalised
    semi: Optional[torch.Tensor] = None  # [B, h/8, w/8, 65] normalised (training)
    stability_logits: Optional[torch.Tensor] = None  # [B, H, W, 3] softmax (training)
    features: tuple = ()  # (out2c, out3c) NHWC (training, require_feature)


def _pixel_shuffle_score(semi_norm: torch.Tensor) -> torch.Tensor:
    """[B, 65, Hc, Wc] normalised semi → [B, Hc*8, Wc*8] score map: drops
    the dustbin and inverts the 8×8 packing (channel c ↦ in-cell offset
    (c // 8, c % 8)), as ``nets/sfd2.py:332-337``."""
    b, _, hc, wc = semi_norm.shape
    score = semi_norm[:, :64].permute(0, 2, 3, 1).reshape(b, hc, wc, 8, 8)
    return score.permute(0, 1, 3, 2, 4).reshape(b, hc * 8, wc * 8)


class _ResSegBase(nn.Module):
    """Shared encoder + heads; V1/V2 differ only in the stability head."""

    sta_channels = 0
    fold_stability_into_score = False  # V2's det_train multiplies the score

    def __init__(self, outdim: int = 128, require_stability: bool = True,
                 require_feature: bool = False):
        super().__init__()
        self.require_stability = require_stability
        self.require_feature = require_feature
        self.conv1a = ConvUnit(3, 64)
        self.conv1b = ConvUnit(64, 64, stride=2, use_bn=False, relu=False)
        self.bn1b = BNRelu(64)
        self.conv2a = ConvUnit(64, 128)
        self.conv2b = ConvUnit(128, 128, stride=2, use_bn=False, relu=False)
        self.bn2b = BNRelu(128)
        self.conv3a = ConvUnit(128, 256)
        self.conv3b = ConvUnit(256, 256, use_bn=False, relu=False)
        self.bn3b = BNRelu(256)
        self.conv4 = nn.Sequential(*[ResBlock(256) for _ in range(3)])
        self.convPa = ConvBNReluConv(256, 256, first_stride=2)
        self.convDa = ConvBNReluConv(256, 256, first_stride=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDb = nn.Conv2d(256, outdim, 1)
        if require_stability:
            self.ConvSta = nn.Conv2d(256, self.sta_channels, 1)

    def _sta_map(self, sta: torch.Tensor, size, need_soft: bool = False):
        """(stability value map [B,H,W], softmax of the upsampled logits
        [B,H,W,C] or None); `need_soft` only for the training losses."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor, training_outputs: bool = False) -> DetectionOutput:
        """`x`: [B, H, W, 3] ImageNet-normalised images (NHWC)."""
        dt = self.conv1a[0].weight.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        out1c = self.bn1b(self.conv1b(self.conv1a(x)))
        return self._trunk(out1c, (x.shape[2], x.shape[3]), training_outputs)

    def forward_from_out1c(self, out1c: torch.Tensor) -> DetectionOutput:
        """Inference forward from the post-stem activation out1c
        [B, H/2, W/2, 64] (NHWC), as produced by ops/stem.py's
        ``fused_stem_apply`` or the CUDA stem kernel."""
        dt = self.conv2a[0].weight.dtype
        x = out1c.permute(0, 3, 1, 2).to(dt)
        return self._trunk(x, (x.shape[2] * 2, x.shape[3] * 2))

    def _trunk(self, out1c: torch.Tensor, full_size,
               training_outputs: bool = False) -> DetectionOutput:
        out2c = self.bn2b(self.conv2b(self.conv2a(out1c)))
        out3c = self.bn3b(self.conv3b(self.conv3a(out2c)))
        out4 = self.conv4(out3c)

        semi = torch.exp(self.convPb(self.convPa(out4)).float())
        semi_norm = semi / (torch.sum(semi, dim=1, keepdim=True) + 1e-5)
        score = _pixel_shuffle_score(semi_norm)

        desc = self.convDb(self.convDa(out4)).float()
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)

        stability = sta_soft = None
        if self.require_stability:
            stability, sta_soft = self._sta_map(self.ConvSta(out4).float(), full_size,
                                                training_outputs)
            if training_outputs and self.fold_stability_into_score:
                score = score * stability
        feats = ()
        if training_outputs and self.require_feature:
            feats = (out2c.permute(0, 2, 3, 1), out3c.permute(0, 2, 3, 1))
        return DetectionOutput(
            score=score, stability=stability, descriptors=desc.permute(0, 2, 3, 1),
            semi=semi_norm.permute(0, 2, 3, 1) if training_outputs else None,
            stability_logits=sta_soft, features=feats)


class ResSegNetV2(_ResSegBase):
    """V2: 3-class semantic-stability classifier head (``nets/sfd2.py:259``)."""

    sta_channels = 3
    fold_stability_into_score = True

    def _sta_map(self, sta, size, need_soft=False):
        # Upsample the logits, then first-max class → {0.1, 0.5, 1.0}
        # (nets/sfd2.py:345-347), written as the JAX package's select chain.
        up = F.interpolate(sta, size=tuple(size), mode="bilinear", align_corners=False)
        s0, s1, s2 = up[:, 0], up[:, 1], up[:, 2]
        is0 = (s0 >= s1) & (s0 >= s2)
        is1 = (~is0) & (s1 >= s2)
        values = torch.where(is0, 0.1, torch.where(is1, 0.5, 1.0)).to(torch.float32)
        soft = torch.softmax(up.permute(0, 2, 3, 1), dim=-1) if need_soft else None
        return values, soft


class ResSegNet(_ResSegBase):
    """V1: single-channel sigmoid stability head (``nets/sfd2.py:98``)."""

    sta_channels = 1

    def _sta_map(self, sta, size, need_soft=False):
        # Sigmoid, then upsample (nets/sfd2.py:179-180).
        return F.interpolate(torch.sigmoid(sta), size=tuple(size), mode="bilinear",
                             align_corners=False)[:, 0], None
