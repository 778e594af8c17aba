"""Baseline extractor architectures (PyTorch): D2-Net, CAPS ResUNet, SGD2 nets.

Port of ``sfd2_tpu/models/baselines.py``:
* D2-Net (``hloc/extractors/d2net.py``): VGG16 → conv4_3 dense features
  (two stride-2 max-pools, a stride-1 2×2 average pool that shrinks the
  map by 1 px, a dilated conv4 block; output stride 4), and the hard
  detection of its test path.
* CAPS (``hloc/extractors/caps.py:215-379``): a torchvision ResNet-50
  encoder (conv1, layers 1–3), a coarse 128-D head at 1/16 and a U-Net
  decoder with a fine 128-D head at 1/4; descriptors are coarse‖fine
  sampled at the keypoints.
* SGD2 (``hloc/extractors/sgd2.py:89-166,293-400``): SPD2L2Net and
  L2SegNetNB, full-resolution dilated trunks with affine-free BatchNorm, a
  sigmoid score head and an L2-normalised descriptor head.

Internals are NCHW; inputs are NHWC and outputs the JAX package's NHWC
layouts. Modules are laid out as the reference networks (D2-Net's
``model.{i}`` Sequential, CAPS's ``firstconv``/``layer{i}.{j}``/decoder
names, SGD2's ``conv{s}.{i}`` Sequentials), so the converters of
``convert_baselines.py`` only strip prefixes.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.layers import BN_EPS
from sfd2_torch.ops.grid_sample import sample_at_points
from sfd2_torch.ops.resize import resize_bilinear


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# D2-Net
# ---------------------------------------------------------------------------


class D2NetDense(nn.Module):
    """VGG16 → conv4_3 dense features (output stride 4, 512 channels).
    `use_relu` appends the final ReLU (reference conf ``d2net.py:18``)."""

    def __init__(self, use_relu: bool = True):
        super().__init__()

        def conv(cin, cout, dilation=1):
            return [nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation), nn.ReLU()]

        layers = [*conv(3, 64), *conv(64, 64), nn.MaxPool2d(2, 2),
                  *conv(64, 128), *conv(128, 128), nn.MaxPool2d(2, 2),
                  *conv(128, 256), *conv(256, 256), *conv(256, 256),
                  nn.AvgPool2d(2, stride=1),  # no padding: shrinks the map by 1 px
                  *conv(256, 512, 2), *conv(512, 512, 2), *conv(512, 512, 2)]
        if not use_relu:
            layers.pop()
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.model(_nchw(x)))


def d2net_hard_detect(features: torch.Tensor, edge_threshold: float = 5.0):
    """D2-Net HardDetectionModule: a cell fires iff its value is (a) the
    channel-wise max, (b) a 3×3 spatial local max in its channel (−inf
    padding), and (c) not edge-like (Hessian trace²/det test on the
    channel-max map, edge-padded).

    features [B, h, w, C]. Returns (mask [B, h, w] bool, score [B, h, w] =
    the channel max where detected, else 0)."""
    depth_max = torch.amax(features, dim=-1)
    is_depth_max = features >= depth_max[..., None]
    local_max = _nhwc(F.max_pool2d(_nchw(features), 3, stride=1, padding=1))
    is_local_max = features >= local_max

    f = depth_max
    pad = F.pad(f[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    dii = pad[:, :-2, 1:-1] - 2 * f + pad[:, 2:, 1:-1]
    djj = pad[:, 1:-1, :-2] - 2 * f + pad[:, 1:-1, 2:]
    dij = 0.25 * (pad[:, 2:, 2:] + pad[:, :-2, :-2] - pad[:, 2:, :-2] - pad[:, :-2, 2:])
    det = dii * djj - dij * dij
    tr = dii + djj
    r = edge_threshold
    not_edge = (det > 0) & (tr * tr / torch.where(det == 0, 1e-12, det) <= (r + 1) ** 2 / r)

    fired = torch.any(is_depth_max & is_local_max, dim=-1) & not_edge
    return fired, torch.where(fired, depth_max, 0.0)


# ---------------------------------------------------------------------------
# CAPS ResUNet (ResNet-50 encoder)
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    """torchvision ResNet Bottleneck (1×1 → 3×3 → 1×1·4, affine BN)."""

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


def res_layer(inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    """A torchvision ResNet layer: the first block strides and projects."""
    return nn.Sequential(Bottleneck(inplanes, planes, stride, downsample=True),
                         *[Bottleneck(planes * 4, planes) for _ in range(blocks - 1)])


class _CapsConv(nn.Module):
    """CAPS `conv` block: Conv → BN(affine) → ELU (``caps.py:287-299``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, (kernel - 1) // 2)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 of an NCHW map with align_corners=True (``caps.py:305``)."""
    h, w = x.shape[2], x.shape[3]
    return _nchw(resize_bilinear(_nhwc(x), (2 * h, 2 * w), align_corners=True))


class _CapsUpconv(nn.Module):
    """CAPS `upconv`: bilinear ×2, then a `conv` block (names
    ``upconv{i}.conv.{conv,bn}``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv = _CapsConv(cin, features, kernel)

    def forward(self, x):
        return self.conv(_upsample2(x))


class CapsResUNet(nn.Module):
    """ResUNet (``caps.py:300-379``): ResNet-50 layers 1-3 encoder, coarse
    128-D head at 1/16, U-Net decoder with skip concats, fine 128-D head
    at 1/4. Returns (coarse, fine), NHWC."""

    def __init__(self, coarse_dim: int = 128, fine_dim: int = 128,
                 layers: Tuple[int, int, int] = (3, 4, 6)):
        super().__init__()
        self.firstconv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.firstbn = nn.BatchNorm2d(64, eps=BN_EPS)
        self.layer1 = res_layer(64, 64, layers[0], 1)  # 1/4, 256
        self.layer2 = res_layer(256, 128, layers[1], 2)  # 1/8, 512
        self.layer3 = res_layer(512, 256, layers[2], 2)  # 1/16, 1024
        self.conv_coarse = _CapsConv(1024, coarse_dim, 1)
        self.upconv3 = _CapsUpconv(1024, 512, 3)
        self.iconv3 = _CapsConv(512 + 512, 512, 3)
        self.upconv2 = _CapsUpconv(512, 256, 3)
        self.iconv2 = _CapsConv(256 + 256, 256, 3)
        self.conv_fine = _CapsConv(256, fine_dim, 1)

    @staticmethod
    def _skip(up, enc):
        # The reference pads the UPSAMPLED map and concats [encoder,
        # upsampled] (``caps.py:344-356``).
        dh, dw = enc.shape[2] - up.shape[2], enc.shape[3] - up.shape[3]
        up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return torch.cat([enc, up], dim=1)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.firstbn(self.firstconv(_nchw(x))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # implicit −inf padding
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        coarse = self.conv_coarse(x3)
        y = self.iconv3(self._skip(self.upconv3(x3), x2))
        y = self.iconv2(self._skip(self.upconv2(y), x1))
        return _nhwc(coarse), _nhwc(self.conv_fine(y))


def caps_sample_descriptors(coarse: torch.Tensor, fine: torch.Tensor, xy: torch.Tensor,
                            image_hw) -> torch.Tensor:
    """Sample concat(coarse, fine) at pixel keypoints (CAPSNet
    ``sample_feat_by_coord`` + the wrapper's concat, ``caps.py:421-424``):
    normalised coords with c = (dim−1)/2, grid_sample align_corners=False.
    coarse/fine: [h, w, C] maps; xy: [N, 2]; image_hw: full-res (H, W)."""
    h_img, w_img = image_hw
    out = []
    for fmap in (coarse, fine):
        h, w = fmap.shape[0], fmap.shape[1]
        cx = (xy[:, 0] - (w_img - 1) / 2) / ((w_img - 1) / 2)  # [-1, 1]
        cy = (xy[:, 1] - (h_img - 1) / 2) / ((h_img - 1) / 2)
        px = ((cx + 1) * w - 1) / 2  # align_corners=False
        py = ((cy + 1) * h - 1) / 2
        # The JAX function passes padding_mode="edge", which its
        # sample_at_points treats as clamping, i.e. "border" here.
        out.append(sample_at_points(fmap, torch.stack([px, py], -1), padding_mode="border"))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# SGD2 prototypes
# ---------------------------------------------------------------------------


class _SgdConvBNRelu(nn.Sequential):
    """Conv → BN(affine=False) [→ ReLU] with explicit dilation/padding.
    Stages flatten these units into one Sequential (``_stage``), so the
    keys are the reference's ``conv{s}.{i}``."""

    def __init__(self, cin: int, features: int, kernel: int = 3, padding: int = 1,
                 dilation: int = 1, relu: bool = True):
        layers = [nn.Conv2d(cin, features, kernel, padding=padding, dilation=dilation),
                  nn.BatchNorm2d(features, eps=BN_EPS, affine=False)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


def _stage(cin: int, specs, tail: bool = False) -> Tuple[nn.Sequential, int]:
    """Flat Sequential of `_SgdConvBNRelu` units, (features, kernel,
    padding, dilation, relu) each; `tail` appends the kernel-2 dilated conv
    without BN (``sgd2.py:123``). Returns (stage, out channels)."""
    units = []
    for f, k, p, d, r in specs:
        units.append(_SgdConvBNRelu(cin, f, k, p, d, relu=r))
        cin = f
    layers = list(itertools.chain.from_iterable(units))
    if tail:
        layers.append(nn.Conv2d(cin, 128, 2, padding=8, dilation=16))
        cin = 128
    return nn.Sequential(*layers), cin


def _heads(x: torch.Tensor, conv_pb: nn.Conv2d, conv_db: nn.Conv2d):
    score = torch.sigmoid(conv_pb(x))[:, 0]
    desc = conv_db(x)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)
    return score, _nhwc(desc)


class SPD2L2Net(nn.Module):
    """``sgd2.py:89`` — single dilated trunk at full resolution (``conv1``,
    the torch Sequential conv1.0 .. conv1.28); heads: sigmoid score
    (convPb) + L2-normalised `outdim` descriptors (convDb)."""

    def __init__(self, outdim: int = 128):
        super().__init__()
        self.conv1, c = _stage(3, [
            (16, 3, 1, 1, True), (16, 3, 1, 1, True),
            (32, 3, 1, 1, True), (32, 3, 1, 1, True),
            (64, 3, 1, 1, True), (64, 3, 2, 2, True),
            (128, 3, 2, 2, True), (128, 3, 4, 4, True),
            (128, 2, 2, 4, False), (128, 2, 4, 8, False)], tail=True)
        self.convDb = nn.Conv2d(c, outdim, 1)
        self.convPb = nn.Conv2d(c, 1, 1)

    def forward(self, x: torch.Tensor):
        return _heads(self.conv1(_nchw(x)), self.convPb, self.convDb)


class L2SegNetNB(nn.Module):
    """``sgd2.py:293`` — staged conv1..conv6 variant (the net the Sgd2
    wrapper instantiates, ``:861``); `require_feature` also returns the
    stage-1..3 feature maps (NHWC)."""

    def __init__(self, outdim: int = 128, require_feature: bool = False):
        super().__init__()
        self.require_feature = require_feature
        self.conv1, c = _stage(3, [(16, 3, 1, 1, True), (16, 3, 1, 1, True)])
        self.conv2, c = _stage(c, [(24, 3, 1, 1, True), (24, 3, 1, 1, True)])
        self.conv3, c = _stage(c, [(32, 3, 1, 1, True), (32, 3, 1, 1, True)])
        self.conv4, c = _stage(c, [(64, 3, 1, 1, True), (64, 3, 2, 2, True)])
        self.conv5, c = _stage(c, [(128, 3, 2, 2, True), (128, 3, 4, 4, True)])
        self.conv6, c = _stage(c, [(128, 2, 2, 4, False), (128, 2, 4, 8, False)], tail=True)
        self.convDb = nn.Conv2d(c, outdim, 1)
        self.convPb = nn.Conv2d(c, 1, 1)

    def forward(self, x: torch.Tensor):
        out1 = self.conv1(_nchw(x))
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        score, desc = _heads(self.conv6(self.conv5(self.conv4(out3))), self.convPb, self.convDb)
        if self.require_feature:
            return score, desc, (_nhwc(out1), _nhwc(out2), _nhwc(out3))
        return score, desc
