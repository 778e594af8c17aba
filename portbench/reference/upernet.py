"""Plain reference of the segment cells: UPerNet on ConvNeXt and mmseg's
ADE20k test pipeline, in float32 with TF32 off.

Follows mmseg's ``upernet_convnext_base_fp16_512x512_160k_ade20k`` and its
``_base_/datasets/ade20k.py`` test pipeline, as SFD2's
``nets/semseg/segnet.py`` runs it through ``inference_segmentor``:

* ``Resize(img_scale=(2048, 512), keep_ratio=True)`` (``mmcv.rescale_size``,
  then a bilinear resize of the uint8 image), ``Normalize`` with ADE20k's
  mean and std (the images are RGB already);
* ``slide_inference``: crops of 512 every 341 pixels, the last clamped to
  the far edge; each crop through ConvNeXt (mmcls: 4×4 stem, blocks of
  depthwise 7×7, LayerNorm with eps 1e-6, 4× MLP with exact GELU, layer
  scale, residual; a LayerNorm on each output stage) and the UPerHead
  (PPM at pool scales 1, 2, 3, 6, top-down FPN, conv → BN → ReLU modules,
  bilinear with align_corners False); the crop's logits resized to the
  crop, summed over the crops and divided by their count;
* the averaged logits resized to the original size (bilinear) and the
  argmax over the classes.

One crop at a time, so that it fits at any size. Departures from mmseg:
the resize runs in float32 (``F.interpolate``, no antialiasing, as
``cv2.INTER_LINEAR``) rounded half to even to uint8 levels, where cv2
computes in 11-bit fixed point (a level apart at most); where the resized
image is smaller than a crop it is zero-padded (after normalisation) to
the crop, where mmseg would run a smaller crop (the cells' images never
are); the softmax before the argmax is left out (it moves no label); the
network runs in float32, where the configuration's ``fp16`` runs it
under float16 autocast.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def _ln_last(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _ln2d(x, sd, name, eps):
    return _ln_last(x.permute(0, 2, 3, 1), sd, name, eps).permute(0, 3, 1, 2)


def backbone(sd: dict, x: torch.Tensor, config: dict) -> list:
    """Normalised NCHW crops → the four stages' normed features (NCHW)."""
    bb = config["backbone"]
    eps, k = bb["layer_norm_eps"], bb.get("kernel", 7)
    feats = []
    for i, depth in enumerate(bb["depths"]):
        p = f"backbone.downsample_layers.{i}"
        if i == 0:
            x = F.conv2d(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"], stride=4)
            x = _ln2d(x, sd, f"{p}.1", eps)
        else:
            x = _ln2d(x, sd, f"{p}.0", eps)
            x = F.conv2d(x, sd[f"{p}.1.weight"], sd[f"{p}.1.bias"], stride=2)
        for j in range(depth):
            q = f"backbone.stages.{i}.{j}"
            y = F.conv2d(x, sd[f"{q}.depthwise_conv.weight"], sd[f"{q}.depthwise_conv.bias"],
                         padding=k // 2, groups=x.shape[1])
            y = _ln_last(y.permute(0, 2, 3, 1), sd, f"{q}.norm", eps)
            y = F.gelu(F.linear(y, sd[f"{q}.pointwise_conv1.weight"],
                                sd[f"{q}.pointwise_conv1.bias"]))
            y = F.linear(y, sd[f"{q}.pointwise_conv2.weight"], sd[f"{q}.pointwise_conv2.bias"])
            x = x + (y * sd[f"{q}.gamma"]).permute(0, 3, 1, 2)
        feats.append(_ln2d(x, sd, f"backbone.norm{i}", eps))
    return feats


def _conv_module(sd, name, x, eps):
    w = sd[f"{name}.conv.weight"]
    x = F.conv2d(x, w, None, padding=w.shape[-1] // 2)
    x = F.batch_norm(x, sd[f"{name}.bn.running_mean"], sd[f"{name}.bn.running_var"],
                     sd[f"{name}.bn.weight"], sd[f"{name}.bn.bias"], False, 0.0, eps)
    return F.relu(x)


def head(sd: dict, feats: list, config: dict) -> torch.Tensor:
    """The UPerHead: features → logits [N, classes, h/4, w/4]."""
    hd = config["decode_head"]
    eps = hd["batch_norm_eps"]
    top = feats[-1]
    psp = [top] + [_resize(_conv_module(sd, f"decode_head.psp_modules.{i}.1",
                                        F.adaptive_avg_pool2d(top, s), eps), top.shape[2:])
                   for i, s in enumerate(hd["pool_scales"])]
    lat = [_conv_module(sd, f"decode_head.lateral_convs.{i}", f, eps)
           for i, f in enumerate(feats[:-1])]
    lat.append(_conv_module(sd, "decode_head.bottleneck", torch.cat(psp, 1), eps))
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + _resize(lat[i], lat[i - 1].shape[2:])
    outs = [_conv_module(sd, f"decode_head.fpn_convs.{i}", lat[i], eps)
            for i in range(len(lat) - 1)] + [lat[-1]]
    outs = [outs[0]] + [_resize(o, outs[0].shape[2:]) for o in outs[1:]]
    x = _conv_module(sd, "decode_head.fpn_bottleneck", torch.cat(outs, 1), eps)
    return F.conv2d(x, sd["decode_head.conv_seg.weight"], sd["decode_head.conv_seg.bias"])


def forward(sd: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    return head(sd, backbone(sd, x, config), config)


def rescale_size(h: int, w: int, img_scale) -> tuple:
    """mmcv's ``rescale_size`` with keep_ratio: scale factor min(long /
    long side, short / short side), each side ``int(side · f + 0.5)``."""
    f = min(max(img_scale) / max(h, w), min(img_scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def prepared(image_u8: np.ndarray, config: dict, device) -> torch.Tensor:
    """uint8 [H, W, 3] → the normalised resized image [1, 3, rh, rw]."""
    tp = config["test_pipeline"]
    x = torch.from_numpy(np.ascontiguousarray(image_u8)).to(device).permute(2, 0, 1)[None].float()
    size = rescale_size(*image_u8.shape[:2], tp["img_scale"])
    if size != tuple(image_u8.shape[:2]):
        x = _resize(x, size).round().clamp(0, 255)
    mean = torch.tensor(tp["mean"], device=device)[:, None, None]
    std = torch.tensor(tp["std"], device=device)[:, None, None]
    return (x - mean) / std


@torch.no_grad()
def slide_logits(sd: dict, image_u8: np.ndarray, config: dict, device) -> torch.Tensor:
    """mmseg's slide_inference on the resized image: averaged logits
    [classes, rh, rw], crop by crop."""
    x = prepared(image_u8, config, device)
    rh, rw = x.shape[2:]
    (ch, cw), (sh, sw) = config["test_cfg"]["crop_size"], config["test_cfg"]["stride"]
    x = F.pad(x, (0, max(cw - rw, 0), 0, max(ch - rh, 0)))
    ph, pw = x.shape[2:]
    preds = torch.zeros((1, config["decode_head"]["num_classes"], ph, pw), device=device)
    count = torch.zeros((1, 1, ph, pw), device=device)
    for hi in range(max(ph - ch + sh - 1, 0) // sh + 1):
        for wi in range(max(pw - cw + sw - 1, 0) // sw + 1):
            y1, x1 = hi * sh, wi * sw
            y2, x2 = min(y1 + ch, ph), min(x1 + cw, pw)
            y1, x1 = max(y2 - ch, 0), max(x2 - cw, 0)
            crop = x[:, :, y1:y2, x1:x2]
            preds[:, :, y1:y2, x1:x2] += _resize(forward(sd, crop, config), crop.shape[2:])
            count[:, :, y1:y2, x1:x2] += 1
    return (preds / count)[0, :, :rh, :rw]


@torch.no_grad()
def labels_and_margin(avg: torch.Tensor, size) -> tuple:
    """The averaged logits resized to `size`: (argmax [H, W], top-1 less
    top-2 logit [H, W])."""
    top2 = _resize(avg[None], size)[0].topk(2, dim=0)
    return top2.indices[0], top2.values[0] - top2.values[1]


def compare(logits, labels, ref_avg: torch.Tensor, ref_labels: torch.Tensor,
            ref_margin: torch.Tensor, margin_std: float) -> dict:
    """The program's averaged logits [rh, rw, classes] (or None) and labels
    [H, W] against the reference's: ``logit_gap`` (max absolute gap over
    the reference logits' standard deviation; None when the shapes
    differ) and ``label_miss_share`` (labels that differ, among pixels
    whose top-2 margin in the reference exceeds `margin_std` standard
    deviations)."""
    std = float(ref_avg.std())
    gap = None
    if logits is not None and tuple(logits.shape) == tuple(ref_avg.permute(1, 2, 0).shape):
        gap = float((logits.to(ref_avg.device).float() - ref_avg.permute(1, 2, 0)).abs().max()) / std
    sure = ref_margin > margin_std * std
    labels = torch.as_tensor(np.asarray(labels), device=ref_labels.device).long()
    miss = float((labels != ref_labels)[sure].float().mean()) if bool(sure.any()) else 1.0
    return {"logit_gap": gap, "label_miss_share": miss, "sure_share": float(sure.float().mean())}
