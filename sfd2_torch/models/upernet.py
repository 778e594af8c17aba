"""UPerNet-ConvNeXt semantic segmentor — the training teacher.

Port of ``sfd2_tpu/models/upernet.py`` (``nets/semseg/segnet.py:28-33``:
mmseg's ``upernet_convnext_base_fp16_512x512_160k_ade20k``, which labels
the training images with ADE20k-150 classes, ``trainer.py:287``):
``ConvNeXt`` + mmseg's UPerHead (pool scales (1, 2, 3, 6), 512 channels,
150 classes, conv → BN (running statistics) → ReLU modules,
align_corners=False) + the auxiliary FCNHead (in_index 2, 256 channels).

The modules carry mmseg's names (``backbone.*``, ``decode_head.{
psp_modules.N.1, bottleneck, lateral_convs.N, fpn_convs.N,
fpn_bottleneck}.{conv,bn}``, ``decode_head.conv_seg``,
``auxiliary_head.{convs.0,conv_seg}``), so an mmseg checkpoint loads by
name (``load_mmseg_state_dict``; ``convert_upernet`` returns the
converted state_dict, the JAX package's conversion entry). The teacher is
frozen: eval mode, float32 unless bf16 is asked for. ``Segmentor`` keeps
the reference's ``SegNet.evaluate`` contract with slide inference (all
crops in one batched call) or whole-image inference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.convert import float_state_dict
from sfd2_torch.models.convnext import ARCH_SETTINGS, ConvNeXt
from sfd2_torch.utils.device import resolve_device

# mmseg ADE20k normalisation (configs/_base_/datasets/ade20k.py).
ADE20K_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
ADE20K_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch's ``AdaptiveAvgPool2d((out, out))`` on NHWC [B, H, W, C] →
    [B, out, out, C]: bin i spans rows ⌊i·H/out⌋ … ⌈(i+1)·H/out⌉, as the
    JAX package's ``adaptive_avg_pool``. The PSP modules run the same
    pooling on NCHW (``nn.AdaptiveAvgPool2d``)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)


class ConvModule(nn.Module):
    """mmseg ConvModule: conv (no bias) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UPerHead(nn.Module):
    """mmseg UPerHead: PSP on the deepest stage + top-down FPN fuse."""

    def __init__(self, in_channels: Sequence[int], channels: int = 512, num_classes: int = 150,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.psp_modules = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(in_channels[-1], channels, 1))
            for s in pool_scales)
        self.bottleneck = ConvModule(in_channels[-1] + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvModule(channels, channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):  # NCHW
        x3 = feats[-1]
        psp = [x3] + [_up(m(x3), x3.shape[2:]) for m in self.psp_modules]
        laterals = [conv(feats[i]) for i, conv in enumerate(self.lateral_convs)]
        laterals.append(self.bottleneck(torch.cat(psp, 1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _up(laterals[i], laterals[i - 1].shape[2:])
        outs = [conv(laterals[i]) for i, conv in enumerate(self.fpn_convs)] + [laterals[-1]]
        outs = [outs[0]] + [_up(f, outs[0].shape[2:]) for f in outs[1:]]
        # Dropout(0.1) is the identity at inference (frozen teacher).
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, 1))).float()


class FCNHead(nn.Module):
    """mmseg FCNHead auxiliary head (num_convs=1, concat_input=False)."""

    def __init__(self, cin: int, channels: int = 256, num_classes: int = 150):
        super().__init__()
        self.convs = nn.Sequential(ConvModule(cin, channels, 3))
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x):
        return self.conv_seg(self.convs(x)).float()


class ConvNeXtUPerNet(nn.Module):
    """EncoderDecoder(ConvNeXt, UPerHead, FCNHead): logits at 1/4 of the
    input resolution (mmseg resizes them to the input before argmax)."""

    def __init__(self, arch: str = "base", num_classes: int = 150, head_channels: int = 512,
                 aux_channels: int = 256):
        super().__init__()
        ch = ARCH_SETTINGS[arch]["channels"]
        self.backbone = ConvNeXt(arch, out_indices=(0, 1, 2, 3))
        self.decode_head = UPerHead(ch, head_channels, num_classes)
        self.auxiliary_head = FCNHead(ch[2], aux_channels, num_classes)

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        """[B, H, W, 3] (ADE20k-normalised) → logits [B, H/4, W/4, classes]
        float32 (and the auxiliary head's with `with_aux`)."""
        dt = self.decode_head.conv_seg.weight.dtype
        feats = self.backbone.features_nchw(x.permute(0, 3, 1, 2).to(dt))
        logits = self.decode_head(feats).permute(0, 2, 3, 1)
        if with_aux:
            return logits, self.auxiliary_head(feats[2]).permute(0, 2, 3, 1)
        return logits


def _mmseg_entries(state: Mapping[str, Any], keys) -> Dict[str, torch.Tensor]:
    """The entries of an mmseg state_dict (a ``state_dict`` entry or bare,
    ``module.`` prefixes stripped, float32) that `keys` names. The
    auxiliary head may be missing (mmseg drops it from some exports); any
    other missing key raises."""
    if "state_dict" in state and isinstance(state["state_dict"], Mapping):
        state = state["state_dict"]
    sd = float_state_dict(state)
    missing = [k for k in keys if k not in sd and not k.startswith("auxiliary_head.")
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"segmentor checkpoint lacks {missing[:8]}")
    return {k: sd[k] for k in keys if k in sd}


def load_mmseg_state_dict(model: ConvNeXtUPerNet, state: Mapping[str, Any]) -> ConvNeXtUPerNet:
    """An mmseg ``upernet_convnext_*`` state_dict → `model`, by name
    (``_mmseg_entries``)."""
    model.load_state_dict(_mmseg_entries(state, model.state_dict().keys()), strict=False)
    return model


def convert_upernet(state: Mapping[str, Any], arch: str = "base") -> Dict[str, torch.Tensor]:
    """An mmseg ``upernet_convnext_*`` state_dict → the state_dict of
    ``ConvNeXtUPerNet(arch)``: the JAX package's ``convert_upernet`` entry,
    which returns Flax variables. The port's modules carry mmseg's names,
    so the conversion selects and casts (``_mmseg_entries``); the auxiliary
    head where the checkpoint has one."""
    with torch.device("meta"):  # the key names only: no weights are made
        keys = ConvNeXtUPerNet(arch).state_dict().keys()
    return _mmseg_entries(state, keys)


def seeded_segmentor(arch: str = "base", seed: int = 0, **kwargs) -> ConvNeXtUPerNet:
    """A ConvNeXtUPerNet with seeded weights at the JAX init scale."""
    from sfd2_torch.pipeline.extractors import seeded_init_

    return seeded_init_(ConvNeXtUPerNet(arch, **kwargs), seed)


@dataclasses.dataclass
class SegmentorConfig:
    crop: int = 512  # slide window (test_cfg crop_size)
    stride: int = 341  # slide stride (test_cfg stride)
    mode: str = "slide"  # 'slide' (the shipped test_cfg) or 'whole'
    pad_multiple: int = 32
    bf16: Optional[bool] = None  # None: float32, as the JAX package off a TPU


class Segmentor:
    """The reference ``SegNet.evaluate`` contract: an RGB image (HWC,
    uint8 or float in 0..255) → ADE20k label map [H, W] int32, 0-based
    (callers add 1 for the 1..150 convention, ``trainer.py:290``)."""

    def __init__(self, model: Optional[ConvNeXtUPerNet] = None,
                 config: Optional[SegmentorConfig] = None, device="cuda", seed: int = 0):
        self.config = config or SegmentorConfig()
        self.device = resolve_device(device)
        model = model or seeded_segmentor(seed=seed)
        dt = torch.bfloat16 if self.config.bf16 else torch.float32
        self.model = model.eval().requires_grad_(False).to(self.device, dt)

    def _pad(self, img: np.ndarray, size: int | None = None):
        h, w = img.shape[:2]
        m = self.config.pad_multiple
        ph = max(size or 0, -((-h) // m) * m)
        pw = max(size or 0, -((-w) // m) * m)
        out = np.zeros((ph, pw, 3), np.float32)
        out[:h, :w] = (img.astype(np.float32) - ADE20K_MEAN) / ADE20K_STD
        return out, (h, w)

    @torch.no_grad()
    def _logits(self, x: np.ndarray, size) -> torch.Tensor:
        """Logits [N, C, size] of NHWC crops `x`, on the device."""
        logits = self.model(torch.from_numpy(x).to(self.device))
        return _up(logits.permute(0, 3, 1, 2), size)

    def logits_whole(self, img: np.ndarray) -> np.ndarray:
        """Whole-image logits at input resolution, [H, W, classes] f32."""
        x, (h, w) = self._pad(img)
        return self._logits(x[None], x.shape[:2])[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()

    def logits_slide(self, img: np.ndarray) -> np.ndarray:
        """Slide-window logits, every crop in one batched call; logits
        summed and divided by the crop count as mmseg's slide_inference."""
        c, s = self.config.crop, self.config.stride
        x, (h, w) = self._pad(img, size=c)
        ph, pw = x.shape[:2]
        ys = list(range(0, max(ph - c, 0) + 1, s))
        xs = list(range(0, max(pw - c, 0) + 1, s))
        if ys[-1] + c < ph:
            ys.append(ph - c)
        if xs[-1] + c < pw:
            xs.append(pw - c)
        crops = np.stack([x[y:y + c, xx:xx + c] for y in ys for xx in xs])
        logits = self._logits(crops, (c, c))
        acc = torch.zeros(logits.shape[1], ph, pw, device=logits.device)
        cnt = torch.zeros(1, ph, pw, device=logits.device)
        k = 0
        for y in ys:
            for xx in xs:
                acc[:, y:y + c, xx:xx + c] += logits[k]
                cnt[:, y:y + c, xx:xx + c] += 1.0
                k += 1
        return (acc / cnt)[:, :h, :w].permute(1, 2, 0).cpu().numpy()

    def evaluate(self, img: np.ndarray) -> np.ndarray:
        """0-based label map, the reference ``SegNet.evaluate``."""
        logits = self.logits_slide(img) if self.config.mode == "slide" else self.logits_whole(img)
        return np.argmax(logits, axis=-1).astype(np.int32)


def upernet_from_flax(variables, arch: str = "base") -> Dict[str, torch.Tensor]:
    """The JAX package's ConvNeXtUPerNet variables ({'params',
    'batch_stats'}) → ConvNeXtUPerNet's state_dict (mmseg names); the
    auxiliary head where the variables have one."""
    from sfd2_torch.models.convert import _conv_weight, _vec
    from sfd2_torch.models.convnext import convnext_from_flax

    params, stats = variables["params"], variables["batch_stats"]
    sd = convnext_from_flax(params["backbone"], arch, prefix="backbone.")

    def conv_module(name, p, s):
        sd[f"{name}.conv.weight"] = _conv_weight(p["conv"]["kernel"])
        sd[f"{name}.bn.weight"] = _vec(p["bn"]["scale"])
        sd[f"{name}.bn.bias"] = _vec(p["bn"]["bias"])
        sd[f"{name}.bn.running_mean"] = _vec(s["bn"]["mean"])
        sd[f"{name}.bn.running_var"] = _vec(s["bn"]["var"])
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def cls_conv(name, p):
        sd[f"{name}.weight"] = _conv_weight(p["kernel"])
        sd[f"{name}.bias"] = _vec(p["bias"])

    dp, ds = params["decode_head"], stats["decode_head"]
    for i in range(4):
        conv_module(f"decode_head.psp_modules.{i}.1", dp[f"psp{i}"], ds[f"psp{i}"])
    conv_module("decode_head.bottleneck", dp["psp_bottleneck"], ds["psp_bottleneck"])
    for i in range(3):
        conv_module(f"decode_head.lateral_convs.{i}", dp[f"lateral{i}"], ds[f"lateral{i}"])
        conv_module(f"decode_head.fpn_convs.{i}", dp[f"fpn{i}"], ds[f"fpn{i}"])
    conv_module("decode_head.fpn_bottleneck", dp["fpn_bottleneck"], ds["fpn_bottleneck"])
    cls_conv("decode_head.conv_seg", dp["conv_seg"])
    if "auxiliary_head" in params:
        ap, ast = params["auxiliary_head"], stats["auxiliary_head"]
        conv_module("auxiliary_head.convs.0", ap["conv0"], ast["conv0"])
        cls_conv("auxiliary_head.conv_seg", ap["conv_seg"])
    return sd
