"""K1 — the fused encoder stem as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_stem.py``. The kernel
(``csrc/stem.cu``) computes what ``ops/stem.py::fused_stem_apply``
computes, from the normalised NHWC image [B, H, W, 3] (H, W even) to
out1c [B, H/2, W/2, 64], keeping the full-resolution conv1a activation in
shared memory. It takes the folded direct 3×3 weights, which are exact
copies of entries of the ``PackedStem``, as the tensor cores read them
(``stem_tc_w1_image``, ``stem_tc_weight_image``: TF32 hi and lo parts in
the kernel's k order and 128-byte swizzle, made once per
``StemWeights``). The TPU kernel's host-side s2d plane-row packing, halo
rows and W%256 / H%8 constraints are not carried over: they existed for
the TPU's lane layout.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.stem import PackedStem, fused_stem_apply, unpack_stem_params


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: keep 10 mantissa bits, round to
    nearest, ties away from zero (on the magnitude bits)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def stem_tc_k_channel() -> torch.Tensor:
    """[64]: the input channel at each k position of one conv1b tap in the
    kernel's order. k-step s (8 positions) holds, at position j, channel
    16(s // 2) + 4(j mod 4) + 2(s mod 2) + j // 4: a thread's float4 of
    four channels feeds two k-steps of its A fragment."""
    kpos = torch.arange(64)
    s, j = kpos // 8, kpos % 8
    return 16 * (s // 2) + 4 * (j % 4) + 2 * (s % 2) + j // 4


def _hi_lo_swizzled(w: torch.Tensor) -> torch.Tensor:
    """w [..., K, 64] (k, co), K a multiple of 32 → [..., 2 (hi, lo),
    K / 32 (k chunk), 64 co, 32]: hi = tf32(w), lo = tf32(w − hi), each row
    co of a chunk Bᵀ's 32 k positions (128 bytes) with its 16-byte pieces
    in wgmma's 128-byte swizzle: logical piece q at q ^ (co mod 8)."""
    hi = tf32_round(w)
    bt = torch.stack([hi, tf32_round(w - hi)], -3).transpose(-1, -2)  # [..., 2, co, K]
    lead, k = bt.shape[:-3], bt.shape[-1]
    bt = bt.reshape(*lead, 2, 64, k // 32, 8, 4).transpose(-4, -3)  # [..., 2, kc, co, piece, 4]
    co = torch.arange(64, device=w.device)[:, None]
    logical = torch.arange(8, device=w.device)[None, :] ^ (co % 8)
    return bt[..., co, logical, :].reshape(*lead, 2, k // 32, 64, 32).contiguous()


def stem_tc_w1_image(w1: torch.Tensor) -> torch.Tensor:
    """conv1a's weights w1 [3, 3, 3, 64] (dy, dx, ci, co) as the kernel's
    shared memory holds them: [2 (hi, lo), 1, 64 co, 32] float32, k =
    (dy·3 + dx)·3 + ci, the terms k ≥ 27 zero."""
    w = torch.zeros(32, 64, dtype=torch.float32, device=w1.device)
    w[:27] = w1.reshape(27, 64)
    return _hi_lo_swizzled(w)


def stem_tc_weight_image(w2: torch.Tensor) -> torch.Tensor:
    """conv1b's weights w2 [3, 3, 64, 64] (dy, dx, ci, co) as the kernel's
    shared memory holds one tap: [9 taps, 2 (hi, lo), 2 (k chunk), 64 co,
    32] float32, the k positions in ``stem_tc_k_channel``'s order."""
    w = w2.reshape(9, 64, 64).float()
    return _hi_lo_swizzled(w[:, stem_tc_k_channel().to(w.device), :])


class StemWeights:
    """Kernel-shaped constants from a PackedStem, on one device:
    w1 [27, 64] and w2 [576, 64] ((dy, dx, ci) × co), b1/b2 [64], f32, and
    the images the kernel reads, w1_tc = stem_tc_w1_image(w1) and w2_tc =
    stem_tc_weight_image(w2)."""

    def __init__(self, packed: PackedStem, device="cuda"):
        self.packed = PackedStem(*(t.to(device, torch.float32) for t in packed))
        w1, b1, w2, b2 = unpack_stem_params(self.packed)
        self.w1 = w1.reshape(27, 64).contiguous()
        self.b1 = b1.contiguous()
        self.w2 = w2.reshape(576, 64).contiguous()
        self.w1_tc = stem_tc_w1_image(w1)
        self.w2_tc = stem_tc_weight_image(w2)
        self.b2 = b2.contiguous()


def stem_lib(defines=()) -> ctypes.CDLL:
    lib = cuda_build.load("stem", defines)
    fn = lib.sfd2_stem_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def fused_stem_cuda(x: torch.Tensor, weights: StemWeights,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] float32 normalised image → out1c [B, H/2, W/2, 64] in
    `out_dtype` (float32 or bfloat16); the arithmetic is float32."""
    if x.device.type == "cpu":
        packed = PackedStem(*(t.to("cpu") for t in weights.packed))
        return fused_stem_apply(x.float(), packed, torch.float32).to(out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_cuda: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem_cuda: need float32 [B,H,W,3], got {x.dtype} {tuple(x.shape)}")
    b, h, w, _ = x.shape
    if h % 2 or w % 2 or b == 0:
        raise ValueError(f"fused_stem_cuda: H and W must be even, got {h}x{w}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_stem_cuda: unsupported out_dtype {out_dtype}")
    for t in (weights.w1_tc, weights.b1, weights.w2_tc, weights.b2):
        if t.device != x.device:
            raise ValueError("fused_stem_cuda: weights are on another device")
    x = x.contiguous()
    out = torch.empty((b, h // 2, w // 2, 64), dtype=out_dtype, device=x.device)
    stem_launch(stem_lib(), x, weights, out)
    fused_stem_cuda.launches += 1
    fused_stem_cuda.shapes[(b, h, w)] += 1
    return out


def stem_launch(lib: ctypes.CDLL, x: torch.Tensor, weights: StemWeights,
                out: torch.Tensor) -> None:
    """One launch of the stem library `lib` (``stem_lib()``, or a
    measurement variant ``stem_lib(defines)``) on checked, contiguous CUDA
    tensors."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.sfd2_stem_forward(
            x.data_ptr(), weights.w1_tc.data_ptr(), weights.b1.data_ptr(),
            weights.w2_tc.data_ptr(), weights.b2.data_ptr(), out.data_ptr(),
            *x.shape[:3], int(out.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, code, "fused_stem_cuda")


fused_stem_cuda.launches = 0
fused_stem_cuda.shapes = collections.Counter()  # (b, h, w) of each launch
