"""K1 — the fused encoder stem as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_stem.py``. The kernel
(``csrc/stem.cu``) computes what ``ops/stem.py::fused_stem_apply``
computes, from the normalised NHWC image [B, H, W, 3] (H, W even) to
out1c [B, H/2, W/2, 64], keeping the full-resolution conv1a activation in
shared memory. It takes the folded direct 3×3 weights, which are exact
copies of entries of the ``PackedStem``. The TPU kernel's host-side s2d
plane-row packing, halo rows and W%256 / H%8 constraints are not carried
over: they existed for the TPU's lane layout.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.stem import PackedStem, fused_stem_apply, unpack_stem_params


class StemWeights:
    """Kernel-shaped constants from a PackedStem, on one device:
    w1 [27, 64] and w2 [576, 64] ((dy, dx, ci) × co), b1/b2 [64], f32."""

    def __init__(self, packed: PackedStem, device="cuda"):
        self.packed = PackedStem(*(t.to(device, torch.float32) for t in packed))
        w1, b1, w2, b2 = unpack_stem_params(self.packed)
        self.w1 = w1.reshape(27, 64).contiguous()
        self.b1 = b1.contiguous()
        self.w2 = w2.reshape(576, 64).contiguous()
        self.b2 = b2.contiguous()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("stem")
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
    for t in (weights.w1, weights.b1, weights.w2, weights.b2):
        if t.device != x.device:
            raise ValueError("fused_stem_cuda: weights are on another device")
    x = x.contiguous()
    out = torch.empty((b, h // 2, w // 2, 64), dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.sfd2_stem_forward(
            x.data_ptr(), weights.w1.data_ptr(), weights.b1.data_ptr(),
            weights.w2.data_ptr(), weights.b2.data_ptr(), out.data_ptr(),
            b, h, w, int(out_dtype == torch.bfloat16), stream)
    cuda_build.check(lib, code, "fused_stem_cuda")
    fused_stem_cuda.launches += 1
    fused_stem_cuda.shapes[(b, h, w)] += 1
    return out


fused_stem_cuda.launches = 0
fused_stem_cuda.shapes = collections.Counter()  # (b, h, w) of each launch
