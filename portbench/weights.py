"""Seeded ResSegNetV2 weights, made on the device in a few large calls.

Every convolution weight is drawn from one normal sample, scaled per
layer by He's rule (sqrt(2 / fan_in)); biases, the BatchNorms' running
means and affine parameters from a second sample; running variances from
a uniform one in [0.5, 1.5), so that no normalisation is an identity.
Names are the reference checkpoint's, which the program's ``Extractor``
loads and the plain reference reads.
"""

from __future__ import annotations

import math

import torch

from portbench.flops import SFD2_LAYERS, SFD2_NORMS
from portbench.scene import sub_seed


def make_state_dict(seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 7))
    wshapes = [(f"{n}.weight", (co, ci // g, k, k)) for n, ci, co, k, _, g, _, _ in SFD2_LAYERS]
    small = [(f"{n}.bias", (co,)) for n, _, co, _, _, _, bias, _ in SFD2_LAYERS if bias]
    small += [(f"{n}.running_mean", (c,)) for n, c, _ in SFD2_NORMS]
    small += [x for n, c, aff in SFD2_NORMS if aff
              for x in ((f"{n}.weight", (c,)), (f"{n}.bias", (c,)))]
    var = [(f"{n}.running_var", (c,)) for n, c, _ in SFD2_NORMS]

    def draw(shapes, sample):
        flat = sample(sum(math.prod(s) for _, s in shapes))
        out, lo = {}, 0
        for name, s in shapes:
            out[name] = flat[lo:lo + math.prod(s)].reshape(s)
            lo += math.prod(s)
        return out

    sd = draw(wshapes, lambda n: torch.randn(n, generator=gen, device=dev))
    for name, s in wshapes:
        sd[name] *= math.sqrt(2.0 / math.prod(s[1:]))
    smalls = draw(small, lambda n: torch.randn(n, generator=gen, device=dev) * 0.1)
    for name, t in smalls.items():
        sd[name] = t + 1.0 if name.endswith(".weight") else t
    sd.update(draw(var, lambda n: torch.rand(n, generator=gen, device=dev) + 0.5))
    for n, c, _ in SFD2_NORMS:
        sd[f"{n}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=dev)
    return {k: v.contiguous() for k, v in sd.items()}
