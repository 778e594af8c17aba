"""ConvNeXt backbone (the semantic teacher's encoder).

Port of ``sfd2_tpu/models/convnext.py`` (``nets/convnext.py``): a 4×4 s4
patchify stem + LayerNorm, stages of [depthwise 7×7 → LayerNorm →
Linear(4×) → GELU → Linear → γ-scale → residual] blocks with LayerNorm +
2×2 s2 conv downsampling between stages, and a LayerNorm on each output
stage; layer_scale_init_value 1.0 as in the reference's constructor.

The modules carry mmcls's names (``downsample_layers.{i}.{0,1}``,
``stages.{i}.{j}.{depthwise_conv,norm,pointwise_conv1,pointwise_conv2,
gamma}``, ``norm{i}``), so a ConvNeXt checkpoint (``convert_convnext``)
or an mmseg UPerNet one (``models/upernet.py::load_mmseg_state_dict``)
loads by name. Convolutions run NCHW; LayerNorm and the pointwise Linear
layers run on the channels-last view. ``forward`` takes and returns NHWC,
as the JAX module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

ARCH_SETTINGS = {
    "tiny": {"depths": (3, 3, 9, 3), "channels": (96, 192, 384, 768)},
    "small": {"depths": (3, 3, 27, 3), "channels": (96, 192, 384, 768)},
    "base": {"depths": (3, 3, 27, 3), "channels": (128, 256, 512, 1024)},
    "large": {"depths": (3, 3, 27, 3), "channels": (192, 384, 768, 1536)},
}
LN_EPS = 1e-5


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (mmcls ``LayerNorm2d``)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=LN_EPS)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, channels: int, mlp_ratio: int = 4, layer_scale_init_value: float = 1.0):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(channels, channels, 7, padding=3, groups=channels)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.pointwise_conv1 = nn.Linear(channels, mlp_ratio * channels)
        self.pointwise_conv2 = nn.Linear(mlp_ratio * channels, channels)
        self.gamma = (nn.Parameter(torch.full((channels,), float(layer_scale_init_value)))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x):  # NCHW
        y = self.depthwise_conv(x).permute(0, 2, 3, 1)
        y = self.pointwise_conv2(F.gelu(self.pointwise_conv1(self.norm(y))))
        if self.gamma is not None:
            y = y * self.gamma
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, arch: str = "base", out_indices: Tuple[int, ...] = (0, 1)):
        super().__init__()
        depths, channels = ARCH_SETTINGS[arch]["depths"], ARCH_SETTINGS[arch]["channels"]
        self.out_indices = tuple(out_indices)
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(3, channels[0], 4, 4), LayerNorm2d(channels[0]))]
            + [nn.Sequential(LayerNorm2d(channels[i - 1]), nn.Conv2d(channels[i - 1], channels[i],
                                                                      2, 2))
               for i in range(1, len(depths))])
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(channels[i]) for _ in range(depths[i])])
            for i in range(len(depths)))
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm2d(channels[i]))

    def features_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            x = stage(down(x))
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
        return tuple(outs)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[B, H, W, 3] → the out_indices stages, each [B, h, w, C]."""
        return tuple(f.permute(0, 2, 3, 1)
                     for f in self.features_nchw(x.permute(0, 3, 1, 2)))


def convert_convnext(state) -> dict:
    """An mmcls ConvNeXt state_dict (``module.`` / ``backbone.`` prefixes
    stripped, as the JAX package's ``convert_convnext``) → this module's:
    the same names, float32."""
    out = {}
    for k, v in state.items():
        if k.startswith(("module.", "backbone.")):
            k = k.split(".", 1)[1]
        out[k] = torch.as_tensor(v).to(torch.float32).contiguous()
    return out


def convnext_from_flax(params, arch: str = "base", prefix: str = "") -> dict:
    """The JAX package's ConvNeXt params (``stem_conv``, ``down{i}_*``,
    ``stage{i}_block{j}``, ``out_norm{i}``) → this module's state_dict
    (mmcls names), keys prefixed with `prefix`."""
    from sfd2_torch.models.convert import _conv_weight, _vec

    sd = {}

    def conv(name, p):
        sd[f"{prefix}{name}.weight"] = _conv_weight(p["kernel"])
        sd[f"{prefix}{name}.bias"] = _vec(p["bias"])

    def ln(name, p):
        sd[f"{prefix}{name}.weight"] = _vec(p["scale"])
        sd[f"{prefix}{name}.bias"] = _vec(p["bias"])

    def dense(name, p):
        sd[f"{prefix}{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel"], np.float32).T))
        sd[f"{prefix}{name}.bias"] = _vec(p["bias"])

    conv("downsample_layers.0.0", params["stem_conv"])
    ln("downsample_layers.0.1", params["stem_norm"])
    depths = ARCH_SETTINGS[arch]["depths"]
    for i in range(1, len(depths)):
        ln(f"downsample_layers.{i}.0", params[f"down{i}_norm"])
        conv(f"downsample_layers.{i}.1", params[f"down{i}_conv"])
    for i, d in enumerate(depths):
        for j in range(d):
            blk, pre = params[f"stage{i}_block{j}"], f"stages.{i}.{j}"
            conv(f"{pre}.depthwise_conv", blk["dwconv"])
            ln(f"{pre}.norm", blk["norm"])
            dense(f"{pre}.pointwise_conv1", blk["pw1"])
            dense(f"{pre}.pointwise_conv2", blk["pw2"])
            if "gamma" in blk:
                sd[f"{prefix}{pre}.gamma"] = _vec(blk["gamma"])
    for i in range(len(depths)):
        if f"out_norm{i}" in params:
            ln(f"norm{i}", params[f"out_norm{i}"])
    return sd
