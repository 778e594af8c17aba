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
crops in one batched call) or whole-image inference, and runs mmseg's
test pipeline (keep-ratio resize, slide, resize back, argmax) on the
device for a batch of images (``segment_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from sfd2_torch.models.convert import float_state_dict
from sfd2_torch.models.convnext import ARCH_SETTINGS, LN_EPS, ConvNeXt
from sfd2_torch.ops.segment_tail import TailPlan, segment_tail, tail_plan
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import count, span

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
    input resolution (mmseg resizes them to the input before argmax).
    `ln_eps`: the backbone's LayerNorm epsilon (1e-6 in mmseg's configs)."""

    def __init__(self, arch: str = "base", num_classes: int = 150, head_channels: int = 512,
                 aux_channels: int = 256, ln_eps: float = LN_EPS):
        super().__init__()
        ch = ARCH_SETTINGS[arch]["channels"]
        self.backbone = ConvNeXt(arch, out_indices=(0, 1, 2, 3), ln_eps=ln_eps)
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
    # mmseg's test-pipeline Resize: img_scale as (long, short), keep_ratio.
    # None: the image at its own size (the JAX package's behaviour).
    scale: Optional[Tuple[int, int]] = None
    fp16: bool = False  # float16 autocast (convs and linears), as mmseg's fp16 config


MAX_CROPS = 16  # crops a forward: a call with more (full-resolution slides) runs several


def rescale_size(h: int, w: int, scale: Sequence[int]) -> Tuple[int, int]:
    """mmcv's ``rescale_size`` for ``keep_ratio=True``: the largest size of
    the image's aspect within (long, short) = `scale`, each side rounded
    half up."""
    f = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def slide_starts(n: int, crop: int, stride: int) -> Tuple[int, ...]:
    """mmseg's ``slide_inference`` grid along a side of `n` ≥ `crop`: starts
    every `stride`, the last clamped to end at the far edge."""
    grids = max(n - crop + stride - 1, 0) // stride + 1
    return tuple(min(i * stride, n - crop) for i in range(grids))


class SlidePlan(NamedTuple):
    """Where an image of one size goes: resized to `resized`, zero-padded
    (after normalisation) to `canvas`, cut into crops of `crop` at
    `ys` × `xs`."""

    resized: Tuple[int, int]
    canvas: Tuple[int, int]
    crop: Tuple[int, int]
    ys: Tuple[int, ...]
    xs: Tuple[int, ...]


def slide_plan(cfg: SegmentorConfig, h: int, w: int, mode: Optional[str] = None) -> SlidePlan:
    """The resize, canvas and crops of an [h, w] image under `cfg`, in
    `mode` (the configuration's by default)."""
    mode = mode or cfg.mode
    rh, rw = (h, w) if cfg.scale is None else rescale_size(h, w, cfg.scale)
    m = cfg.pad_multiple
    ph, pw = -(-rh // m) * m, -(-rw // m) * m
    if mode == "whole":
        return SlidePlan((rh, rw), (ph, pw), (ph, pw), (0,), (0,))
    c = cfg.crop
    if cfg.scale is not None:  # mmseg slides over the resized image itself
        ph, pw = rh, rw
    ph, pw = max(ph, c), max(pw, c)
    ys, xs = slide_starts(ph, c, cfg.stride), slide_starts(pw, c, cfg.stride)
    return SlidePlan((rh, rw), (max(ph, ys[-1] + c), max(pw, xs[-1] + c)), (c, c), ys, xs)


class Segmentor:
    """The reference ``SegNet.evaluate`` contract: an RGB image (HWC,
    uint8 or float in 0..255) → ADE20k label map [H, W], 0-based
    (callers add 1 for the 1..150 convention, ``trainer.py:290``).

    One device path serves every entry (``segment_batch``): each image
    copied to the device once; there the keep-ratio resize (``scale``;
    bilinear, half-pixel centres, rounded to uint8 levels as
    ``mmcv.imresize`` gives them), the ADE20k normalisation, the zero pad
    and the crops (mmseg's slide grid, or the whole padded image); every
    crop of the call through the network in one forward (under float16
    autocast with ``fp16``); then ``ops/segment_tail.py`` averages the
    crops' logits, resizes the image's part back to its size and takes
    the argmax, writing uint8 labels; one fetch. With ``scale=None`` and
    a slide, the image is padded to a multiple of ``pad_multiple`` and at
    least a crop, as the JAX package pads it."""

    def __init__(self, model: Optional[ConvNeXtUPerNet] = None,
                 config: Optional[SegmentorConfig] = None, device="cuda", seed: int = 0):
        self.config = config or SegmentorConfig()
        self.device = resolve_device(device)
        model = model or seeded_segmentor(seed=seed)
        dt = torch.bfloat16 if self.config.bf16 else torch.float32
        self.model = model.eval().requires_grad_(False).to(self.device, dt)
        self._autocast = torch.float16 if self.config.fp16 else None
        self._mean = torch.from_numpy(ADE20K_MEAN).to(self.device)[:, None, None]
        self._std = torch.from_numpy(ADE20K_STD).to(self.device)[:, None, None]
        self._tails: Dict[tuple, TailPlan] = {}

    def plan(self, h: int, w: int, mode: Optional[str] = None) -> SlidePlan:
        """``slide_plan`` of an [h, w] image under this configuration."""
        return slide_plan(self.config, h, w, mode)

    def _upload(self, images: Sequence) -> torch.Tensor:
        """[B, H, W, 3] on the device: one copy per image, in its own dtype
        (uint8, or float32 for float images)."""
        shape = np.shape(images[0])
        if len(shape) != 3 or shape[2] != 3 or any(np.shape(im) != shape for im in images):
            raise ValueError(f"segment_batch: need RGB images [H, W, 3] of one shape, got "
                             f"{[np.shape(im) for im in images]}")
        u8 = all(np.asarray(im).dtype == np.uint8 for im in images)
        with span("segment.upload"):
            x = torch.empty((len(images), *shape), device=self.device,
                            dtype=torch.uint8 if u8 else torch.float32)
            for i, im in enumerate(images):
                im = np.asarray(im)
                x[i].copy_(torch.from_numpy(np.ascontiguousarray(
                    im if u8 else im.astype(np.float32))))
        return x

    def _prep(self, x: torch.Tensor, plan: SlidePlan) -> torch.Tensor:
        """[B, H, W, 3] → normalised crops [B · crops, 3, crop_h, crop_w]."""
        with span("segment.prep"):
            y = x.permute(0, 3, 1, 2).float()
            if plan.resized != tuple(x.shape[1:3]):
                y = _up(y, plan.resized)
                if x.dtype == torch.uint8:  # the resized image in uint8 levels
                    y = y.round_().clamp_(0, 255)
            y = (y - self._mean) / self._std
            (rh, rw), (ch, cw), (cy, cx) = plan.resized, plan.canvas, plan.crop
            y = F.pad(y, (0, cw - rw, 0, ch - rh))
            crops = torch.stack([y[:, :, a:a + cy, b:b + cx] for a in plan.ys for b in plan.xs], 1)
            return crops.reshape(-1, 3, cy, cx)

    def _forward(self, crops: torch.Tensor) -> torch.Tensor:
        """Crops [N, 3, h, w] → logits [N, h/4, w/4, classes] float32,
        contiguous; at most ``MAX_CROPS`` crops a forward."""
        with span("segment.forward"), torch.autocast(self.device.type, dtype=self._autocast,
                                                      enabled=self._autocast is not None):
            dt = self.model.decode_head.conv_seg.weight.dtype
            out = [self.model.decode_head(self.model.backbone.features_nchw(part.to(dt)))
                   for part in crops.split(MAX_CROPS)]
            return torch.cat(out).permute(0, 2, 3, 1).float().contiguous()

    def _tail(self, logits: torch.Tensor, plan: SlidePlan, size, labels: bool) -> torch.Tensor:
        """Labels [B, H, W] uint8 at `size` or, without `labels`, the
        averaged logits [B, rh, rw, classes] at the resized scale."""
        out = tuple(size) if labels else plan.resized
        key = (plan, out, tuple(logits.shape[1:3]), labels)
        with span("segment.fuse"):
            tail = self._tails.get(key)
            if tail is None:
                tail = self._tails[key] = tail_plan(out, plan.resized, plan.ys, plan.xs,
                                                    plan.crop, logits.shape[1:3], self.device)
            n = len(logits) // (len(plan.ys) * len(plan.xs))
            return segment_tail(logits, tail, n, labels)

    @torch.inference_mode()
    def segment_batch(self, images: Sequence) -> np.ndarray:
        """RGB images of one shape [H, W, 3] (uint8, or float in 0..255) →
        0-based labels [B, H, W] uint8 on the host."""
        with span("segment.batch", images=len(images)):
            x = self._upload(images)
            plan = self.plan(*x.shape[1:3])
            crops = self._prep(x, plan)
            count("segment.images", len(x))
            count("segment.crops", len(crops), tag="crops")
            labels = self._tail(self._forward(crops), plan, x.shape[1:3], True)
            with span("segment.fetch"):
                return labels.cpu().numpy()

    @torch.inference_mode()
    def logits_batch(self, images: Sequence, mode: Optional[str] = None) -> torch.Tensor:
        """The crops' averaged logits [B, rh, rw, classes] float32 at the
        resized scale (the image's own size with ``scale=None``), on the
        device: ``segment_batch``'s path up to its resize back."""
        x = self._upload(images)
        plan = self.plan(*x.shape[1:3], mode)
        return self._tail(self._forward(self._prep(x, plan)), plan, None, False)

    def logits_whole(self, img: np.ndarray) -> np.ndarray:
        """Whole-image logits at the (resized) image's size, [h, w, classes] f32."""
        return self.logits_batch([img], "whole")[0].cpu().numpy()

    def logits_slide(self, img: np.ndarray) -> np.ndarray:
        """Slide-window logits, summed over the crops and divided by their
        count as mmseg's slide_inference, [h, w, classes] f32."""
        return self.logits_batch([img], "slide")[0].cpu().numpy()

    def evaluate(self, img: np.ndarray) -> np.ndarray:
        """0-based label map [H, W] uint8, the reference ``SegNet.evaluate``."""
        return self.segment_batch([img])[0]


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
