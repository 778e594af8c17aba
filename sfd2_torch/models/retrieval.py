"""Global-descriptor retrieval model (PyTorch): ResNet-101 AP-GeM ("DIR").

Port of ``sfd2_tpu/models/retrieval.py`` (``hloc/extractors/dir.py``):
a torchvision-style ResNet bottleneck trunk (v1.5: the stride sits on
conv2) → generalized-mean pooling (p=3) → whitening FC → L2 norm, plus
dirtorch's optional PCA power-law whitening of the pooled descriptor
(host numpy). Internals are NCHW, the input NHWC. With
``dtype=torch.bfloat16`` (opt-in, as in the JAX package) the trunk runs in
bfloat16 and the pooling and whitening tail in float32. Parameters carry
torchvision's names (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``,
``downsample.{0,1}``) and ``whiten`` for the FC, the layout
``convert_dir_resnet`` reads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.convert import _strip_prefix
from sfd2_torch.models.layers import BN_EPS

# dirtorch preprocessing for Resnet-101-AP-GeM (``dir.py:63-66``).
DIR_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
DIR_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _Bottleneck(nn.Module):
    """torchvision Bottleneck: 1×1 → 3×3(stride) → 1×1(×4) + skip."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=BN_EPS)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                         nn.BatchNorm2d(planes * 4, eps=BN_EPS))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


def gem_pool(x: torch.Tensor, p: float = 3.0, eps: float = 1e-6) -> torch.Tensor:
    """Generalized-mean pooling over H, W: (mean clamp(x, eps)^p)^(1/p)
    (dirtorch GeneralizedMeanPoolingP, ``dir.py:29-31``). [B, H, W, C] →
    [B, C], computed in float32 whatever the input's dtype."""
    x = torch.clamp(x.float(), min=eps)
    return torch.mean(x ** p, dim=(1, 2)) ** (1.0 / p)


class ResNetGeM(nn.Module):
    """ResNet bottleneck trunk + GeM pooling + whitening FC + L2 norm.
    depths=(3, 4, 23, 3) is ResNet-101 (``Resnet-101-AP-GeM``); the class is
    depth-parametric so tests can run a small twin cheaply."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3), out_dim: int = 2048,
                 gem_p: float = 3.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.gem_p = tuple(depths), gem_p
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        inplanes, planes = 64, 64
        for li, depth in enumerate(self.depths):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(depth):
                blocks.append(_Bottleneck(inplanes, planes, stride if bi == 0 else 1,
                                          downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.whiten = nn.Linear(inplanes, out_dim)
        # The trunk in `dtype`, the tail in float32 (``.to(device)`` keeps both).
        for name, m in self.named_children():
            if name != "whiten":
                m.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        # torch MaxPool2d(3, stride=2, padding=1): implicit −inf padding.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(len(self.depths)):
            x = getattr(self, f"layer{li + 1}")(x)
        desc = self.whiten(gem_pool(x.permute(0, 2, 3, 1), self.gem_p))
        return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)


def pca_whiten(
    desc: np.ndarray,
    mean: np.ndarray,
    components: np.ndarray,  # [D_out, D_in] rows = principal axes
    variances: np.ndarray,  # [D_out] explained variances
    whitenp: float = 0.25,
    whitenv: int | None = None,
    whitenm: float = 1.0,
) -> np.ndarray:
    """PCA power-law whitening of pooled descriptors (dirtorch
    ``common.whiten_features``, ``dir.py:69-73``; conf whitenp=0.25,
    whitenv=None, whitenm=1.0): center, project onto the PCA basis
    (optionally truncated to ``whitenv`` dims), divide by
    ``whitenm·var^whitenp``, L2-normalise."""
    k = components.shape[0] if whitenv is None else int(whitenv)
    proj = (desc - mean) @ components[:k].T
    proj = proj / (whitenm * np.power(variances[:k], whitenp))
    return proj / np.maximum(np.linalg.norm(proj, axis=-1, keepdims=True), 1e-12)


def resnet_depths(state: Mapping[str, Any]) -> tuple:
    """The blocks per layer of a torchvision-named ResNet state_dict."""
    blocks: Dict[int, int] = {}
    for k in state:
        m = re.match(r"(?:.*\.)?layer(\d+)\.(\d+)\.", k)
        if m:
            li, bi = int(m.group(1)), int(m.group(2))
            blocks[li] = max(blocks.get(li, 0), bi + 1)
    return tuple(blocks[i] for i in sorted(blocks))


def convert_dir_resnet(state: Mapping[str, Any],
                       depths: Sequence[int] | None = None) -> Dict[str, torch.Tensor]:
    """A torch ResNet-GeM state_dict (torchvision naming: conv1/bn1/
    layer{i}.{j}.conv{k}/bn{k}/downsample.{0,1}, plus whiten.{weight,bias}
    for the FC; ``module.`` prefixes stripped or not) → the port's
    ResNetGeM state_dict, float32 (BN counters int64, 0 where absent).
    `depths` defaults to the blocks the state_dict holds; a missing key
    raises ``KeyError``."""
    sd = _strip_prefix(state)
    depths = resnet_depths(sd) if depths is None else tuple(depths)
    with torch.device("meta"):
        keys = ResNetGeM(depths, out_dim=sd["whiten.weight"].shape[0]).state_dict().keys()
    out: Dict[str, torch.Tensor] = {}
    for k in keys:
        if k.endswith("num_batches_tracked"):
            out[k] = sd.get(k, torch.tensor(0)).to(torch.long).reshape(())
        elif k not in sd:
            raise KeyError(f"DIR checkpoint lacks {k}")
        else:
            out[k] = sd[k].to(torch.float32).contiguous()
    return out
