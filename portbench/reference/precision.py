"""Roundings of float32 values to the lower precisions the controls run in."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero), as float32: what a TF32 tensor core reads of each operand."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 → float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448, e4m3's largest finite value), back to float32:
    the operand an fp8 convolution or product reads."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
