"""Seeded UPerNet-ConvNeXt weights by mmseg's names, made on the device.

Names and shapes come from the configuration (depths, widths, head
channels, pool scales, classes), as an mmseg ``upernet_convnext``
checkpoint holds them without its auxiliary head (which does not run at
inference); the program loads them through ``load_mmseg_state_dict`` and
the plain reference reads them by name.

Drawn so that no part is an identity and precision shows: every
convolution and linear weight normal, scaled so that each ConvNeXt
block's residual branch (depthwise 7×7, LayerNorm, 4× MLP with GELU)
has about unit standard deviation, the size of its stage's input (the
stage starts after a LayerNorm and a stride-2 convolution of unit gain),
with layer scale γ = 1 ± 0.1. ConvNeXt's published initial γ of 1e-6
would make the 33 blocks near-identities. The head's convolutions (each
followed by BatchNorm and ReLU) take He's scale, sqrt(2 / fan_in).
LayerNorm and BatchNorm affine weights are 1 ± 0.1 and every bias is
N(0, 0.1²); BatchNorm running means uniform with standard deviation 0.1
and variances uniform in [0.8, 1.2), near (0, 1).
"""

from __future__ import annotations

import math

import torch

from portbench.scene import sub_seed

BIAS_STD = 0.1


def _gelu_second_moment() -> float:
    """E[gelu(z)²] for z ~ N(0, 1), by quadrature."""
    z = torch.linspace(-12.0, 12.0, 240001, dtype=torch.float64)
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    g = z * 0.5 * (1 + torch.erf(z / math.sqrt(2)))
    return float((g * g * pdf).sum() * (z[1] - z[0]))


def layers(config: dict) -> tuple:
    """(weights, vectors, norms): weights as (name, shape, std), vectors
    (biases, LayerNorm and BatchNorm affine parameters, γ) as (name, size,
    centre), BatchNorms as (name, channels)."""
    bb, hd = config["backbone"], config["decode_head"]
    depths, widths = bb["depths"], bb["widths"]
    ratio, k = bb.get("mlp_ratio", 4), bb.get("kernel", 7)
    g2 = _gelu_second_moment()
    w, v, bn = [], [], []

    def ln(name, c):
        v.extend([(f"{name}.weight", c, 1.0), (f"{name}.bias", c, 0.0)])

    def lin(name, shape, std, bias=True):
        w.append((f"{name}.weight", shape, std))
        if bias:
            v.append((f"{name}.bias", shape[0], 0.0))

    lin("backbone.downsample_layers.0.0", (widths[0], 3, 4, 4), 1 / math.sqrt(48))
    ln("backbone.downsample_layers.0.1", widths[0])
    for i, (d, c) in enumerate(zip(depths, widths)):
        if i:
            ln(f"backbone.downsample_layers.{i}.0", widths[i - 1])
            lin(f"backbone.downsample_layers.{i}.1", (c, widths[i - 1], 2, 2),
                1 / math.sqrt(4 * widths[i - 1]))
        for j in range(d):
            p = f"backbone.stages.{i}.{j}"
            lin(f"{p}.depthwise_conv", (c, 1, k, k), 1 / k)
            ln(f"{p}.norm", c)
            lin(f"{p}.pointwise_conv1", (ratio * c, c), 1 / math.sqrt(c))
            lin(f"{p}.pointwise_conv2", (c, ratio * c), 1 / math.sqrt(ratio * c * g2))
            v.append((f"{p}.gamma", c, 1.0))
        ln(f"backbone.norm{i}", c)

    ch, top = hd["channels"], widths[-1]

    def conv_module(name, cin, kk):
        lin(f"{name}.conv", (ch, cin, kk, kk), math.sqrt(2 / (cin * kk * kk)), bias=False)
        v.extend([(f"{name}.bn.weight", ch, 1.0), (f"{name}.bn.bias", ch, 0.0)])
        bn.append((f"{name}.bn", ch))

    for s in range(len(hd["pool_scales"])):
        conv_module(f"decode_head.psp_modules.{s}.1", top, 1)
    conv_module("decode_head.bottleneck", top + len(hd["pool_scales"]) * ch, 3)
    for i, c in enumerate(widths[:-1]):
        conv_module(f"decode_head.lateral_convs.{i}", c, 1)
        conv_module(f"decode_head.fpn_convs.{i}", ch, 3)
    conv_module("decode_head.fpn_bottleneck", len(widths) * ch, 3)
    lin("decode_head.conv_seg", (hd["num_classes"], ch, 1, 1), 1 / math.sqrt(ch))
    return w, v, bn


def make_state_dict(config: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 11))
    weights, vectors, norms = layers(config)

    def draw(sizes, sample):
        flat = sample(sum(sizes))
        return flat.split(list(sizes))

    sd = {}
    for (name, shape, std), t in zip(weights, draw([math.prod(s) for _, s, _ in weights],
                                                 lambda n: torch.randn(n, generator=gen,
                                                                       device=dev))):
        sd[name] = (t * std).reshape(shape)
    for (name, _, centre), t in zip(vectors, draw([n for _, n, _ in vectors],
                                                lambda n: torch.randn(n, generator=gen,
                                                                      device=dev))):
        sd[name] = centre + BIAS_STD * t
    stats = draw([2 * c for _, c in norms], lambda n: torch.rand(n, generator=gen, device=dev))
    for (name, c), t in zip(norms, stats):
        sd[f"{name}.running_mean"] = BIAS_STD * math.sqrt(12) * (t[:c] - 0.5)
        sd[f"{name}.running_var"] = 0.8 + 0.4 * t[c:]
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=dev)
    return {k: t.contiguous() for k, t in sd.items()}
