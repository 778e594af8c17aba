"""Fused space-to-depth stem (inference) — the plain version of kernel K1.

Port of ``sfd2_tpu/ops/stem.py``. It computes the encoder stem
``conv1a → bn1a → relu → conv1b(s2) → bn1b → relu`` of
``nets/sfd2.py:268-272`` on the stride-2 grid: the input is
space-to-depth packed ([B,H,W,3] → [B,H/2,W/2,12]), conv1a's four output
phase planes become 256 channels of one 3×3 conv, conv1b becomes a 2×2
conv over them with (1, 0) padding, and both affine-free BNs and the
biases are folded into the weights. This function is the contract that
``ops/cuda_stem.py::fused_stem_cuda`` is held to.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from sfd2_torch.models.layers import BN_EPS


class PackedStem(NamedTuple):
    """Repacked stem parameters, HWIO as in the JAX package."""

    w1: torch.Tensor  # [3, 3, 12, 256]  conv1a as s2d conv, bn1a folded
    b1: torch.Tensor  # [256]
    w2: torch.Tensor  # [2, 2, 256, 64]  conv1b as s2d conv
    b2: torch.Tensor  # [64]             conv1b bias + bn1b fold


# conv1b tap dy → (s2d tap dyB, phase p): rows 2y'+dy−1 of out1a.
_ROW_MAP = {0: (0, 1), 1: (1, 0), 2: (1, 1)}


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, H/2, W/2, 4C]; channel (p·2+q)·C + c holds input
    pixel (2y+p, 2x+q, c). H, W must be even."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _phase_tap(d: int):
    """conv1a tap d (0..2) seen from output phase 0 → (s2d tap, phase)."""
    s = d - 1
    return (s >> 1) + 1, s & 1


def repack_stem_params(state: Mapping[str, torch.Tensor]) -> PackedStem:
    """Build the s2d stem weights from a ResSegNet state_dict (reference
    names ``conv1a.0``, ``conv1a.1``, ``conv1b.0``, ``bn1b.0``). All folds
    are computed in float32."""
    f32 = lambda k: torch.as_tensor(state[k]).detach().to("cpu", torch.float32)
    w1 = f32("conv1a.0.weight").permute(2, 3, 1, 0)  # HWIO [3,3,3,64]
    b1 = f32("conv1a.0.bias")
    w2 = f32("conv1b.0.weight").permute(2, 3, 1, 0)  # [3,3,64,64]
    b2 = f32("conv1b.0.bias")

    inv1 = 1.0 / torch.sqrt(f32("conv1a.1.running_var") + BN_EPS)
    w1f = w1 * inv1
    b1f = b1 * inv1 - f32("conv1a.1.running_mean") * inv1
    inv2 = 1.0 / torch.sqrt(f32("bn1b.0.running_var") + BN_EPS)
    w2f = w2 * inv2
    b2f = b2 * inv2 - f32("bn1b.0.running_mean") * inv2

    ci, co = 3, 64
    w1p = torch.zeros(3, 3, 4 * ci, 4 * co)
    for p in range(2):
        for dy in range(3):
            dY, pp = _phase_tap(p + dy)
            for q in range(2):
                for dx in range(3):
                    dX, qq = _phase_tap(q + dx)
                    w1p[dY, dX, (pp * 2 + qq) * ci:(pp * 2 + qq + 1) * ci,
                        (p * 2 + q) * co:(p * 2 + q + 1) * co] = w1f[dy, dx]
    w2p = torch.zeros(2, 2, 4 * co, co)
    for dy in range(3):
        dyB, p = _ROW_MAP[dy]
        for dx in range(3):
            dxB, q = _ROW_MAP[dx]
            w2p[dyB, dxB, (p * 2 + q) * co:(p * 2 + q + 1) * co, :] = w2f[dy, dx]
    return PackedStem(w1=w1p, b1=b1f.repeat(4), w2=w2p, b2=b2f)


def unpack_stem_params(packed: PackedStem):
    """The folded direct 3×3 weights inside a PackedStem (exact copies):
    (w1 [3,3,3,64], b1 [64], w2 [3,3,64,64], b2 [64]), HWIO."""
    w1 = torch.empty(3, 3, 3, 64, dtype=packed.w1.dtype, device=packed.w1.device)
    w2 = torch.empty(3, 3, 64, 64, dtype=packed.w2.dtype, device=packed.w2.device)
    for dy in range(3):
        dY, pp = _phase_tap(dy)
        dyB, p = _ROW_MAP[dy]
        for dx in range(3):
            dX, qq = _phase_tap(dx)
            dxB, q = _ROW_MAP[dx]
            w1[dy, dx] = packed.w1[dY, dX, (pp * 2 + qq) * 3:(pp * 2 + qq + 1) * 3, :64]
            w2[dy, dx] = packed.w2[dyB, dxB, (p * 2 + q) * 64:(p * 2 + q + 1) * 64, :]
    return w1, packed.b1[:64], w2, packed.b2


def fused_stem_apply(x: torch.Tensor, packed: PackedStem,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] → out1c [B, H/2, W/2, 64] ≡ relu(bn1b(conv1b(relu(
    bn1a(conv1a(x)))))). `dtype` is the conv operand and output dtype;
    bias, ReLU and the hand-off between the two convs are float32."""
    dev = x.device
    x2 = space_to_depth(x).permute(0, 3, 1, 2).to(dtype)
    w1 = packed.w1.to(dev, dtype).permute(3, 2, 0, 1)
    w2 = packed.w2.to(dev, dtype).permute(3, 2, 0, 1)
    b1 = packed.b1.to(dev, torch.float32)[None, :, None, None]
    b2 = packed.b2.to(dev, torch.float32)[None, :, None, None]
    a = torch.relu(F.conv2d(x2, w1, padding=1).float() + b1)
    a = F.pad(a.to(dtype), (1, 0, 1, 0))
    out = torch.relu(F.conv2d(a, w2).float() + b2)
    return out.to(dtype).permute(0, 2, 3, 1)
