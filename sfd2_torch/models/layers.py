"""Shared conv/BN building blocks (NCHW, the reference's torch names).

Port of ``sfd2_tpu/models/layers.py``. The modules are laid out as the
reference network's ``nn.Sequential`` stacks (``nets/sfd2.py:14-96``) so a
reference ``state_dict`` loads by name: ``ConvUnit`` is
``[Conv2d, BatchNorm2d(affine=False), ReLU]`` (indices 0/1/2),
``ConvBNReluConv`` is ``[Conv2d, BatchNorm2d, ReLU, Conv2d]``. Padding is
torch's symmetric ``padding=p``, which is what the JAX package emulates
with explicit ``((p, p), (p, p))``. The grouped 3×3 conv of ``ResBlock``
is a native ``groups=32`` conv; ``GroupedConvAsDense`` was a TPU
matrix-unit workaround with the same weight layout.

Every BatchNorm is ``BatchNorm2d`` with Flax's running-variance rule (see
that class): in train mode it normalises with the batch statistics and
moves the running variance towards the *biased* batch variance, as
``flax.linen.BatchNorm`` does.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; Flax's 0.9 (sfd2_tpu/models/layers.py:24)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses the
    biased batch variance (``flax/linen/normalization.py``), where torch's
    uses the unbiased one, n/(n−1) times larger. Normalisation, momentum
    and the state_dict names (``running_mean``, ``running_var``,
    ``num_batches_tracked``) are torch's, so a trained model loads into
    ``Extractor`` and ``repack_stem_params`` unchanged. Eval mode is
    ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvUnit(nn.Sequential):
    """Conv2d (+ optional affine-free BN) (+ optional ReLU) — ``conv()``
    of the reference."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, use_bn: bool = True, relu: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, padding=padding)]
        if use_bn:
            layers.append(BatchNorm2d(cout, affine=False))
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BNRelu(nn.Sequential):
    """Affine-free BatchNorm + optional ReLU — ``batch_normalization()``."""

    def __init__(self, channels: int, relu: bool = True):
        layers = [BatchNorm2d(channels, affine=False)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    """1×1 → grouped 3×3 → 1×1 bottleneck with identity skip
    (``nets/sfd2.py:25-55``; groups=32, bias-free convs, affine BNs)."""

    def __init__(self, planes: int, groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes, 1, bias=False)
        self.bn3 = BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + x)


class ConvBNReluConv(nn.Sequential):
    """Conv(3×3, maybe stride 2) → affine BN → ReLU → Conv(3×3) — the
    ``convPa`` / ``convDa`` heads (``nets/sfd2.py:286-297``)."""

    def __init__(self, cin: int, cout: int, first_stride: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, 3, first_stride, padding=1),
            BatchNorm2d(cout),
            nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, padding=1),
        )
