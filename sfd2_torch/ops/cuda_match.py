"""K2 — the fused mutual-NN matcher as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_match.py::mutual_nn_match_pallas``,
with the contract of ``ops/matching.py::mutual_nn_match`` (max-equality
mutuality: an exact tie between rows is granted to every tying row). The
kernel (``csrc/match.cu``) runs on the tensor cores through K5's tiles
(``csrc/nn_tc.cuh``): f32 descriptors as 3×TF32 (within about 1e-6 of the
plain f32 product), bf16 natively as bf16 × bf16, accumulation in f32; any
N1, N2 (ragged edges are masked in the kernel, so there is no tiled
fallback), any C % 4 == 0, and a batch stride of 0 on ``desc0``/``valid0``
to broadcast one query to every bank without copying it. Then a last pass
decides the matches from the merged row and column keys.

The wrapper allocates the scratch (``nn_tc_scratch``): the operands padded
to whole 128-byte rows, split into TF32 hi and lo for f32, and the 64-bit
keys. It lives for one call; at the engine's [64, 4096, 128] with the
query broadcast the split banks take 64·4096·128·4·2 B ≈ 268 MB.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.matching import mutual_nn_match


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("match")
    fn = lib.sfd2_mutual_nn_match
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check_rows(t: torch.Tensor, name: str, align: int, what: str):
    if t.stride(-1) != 1 or (t.ndim == 3 and t.stride(1) != t.shape[2]):
        raise ValueError(f"{what}: {name} rows must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: {name} is not {align}-byte aligned")


def check_match_args(desc0: torch.Tensor, desc1: torch.Tensor, valid0, valid1, what: str):
    """Validate the arguments of a matcher kernel (K2, K4, K5, K6) on CUDA
    tensors: C % 4 == 0. Returns (b, n1, n2, c, valid0, valid1) with absent masks
    made all-valid (valid0 broadcast with batch stride 0)."""
    if desc0.device.type != "cuda" or desc1.device != desc0.device:
        raise ValueError(f"{what}: unsupported devices {desc0.device}, {desc1.device}")
    if desc0.ndim != 3 or desc1.ndim != 3:
        raise ValueError(f"{what}: need [B, N, C] descriptors")
    b, n1, c = desc0.shape
    n2 = desc1.shape[1]
    if desc1.shape[0] != b or desc1.shape[2] != c:
        raise ValueError(f"{what}: shapes {tuple(desc0.shape)} vs {tuple(desc1.shape)}")
    if desc0.dtype != desc1.dtype or desc0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtypes {desc0.dtype}, {desc1.dtype}")
    if c % 4 or c == 0 or b == 0 or n1 == 0 or n2 == 0:
        raise ValueError(f"{what}: unsupported shape B={b} N1={n1} N2={n2} C={c}")
    dev = desc0.device
    if valid0 is None:
        valid0 = torch.ones((1, n1), dtype=torch.bool, device=dev).expand(b, n1)
    if valid1 is None:
        valid1 = torch.ones((b, n2), dtype=torch.bool, device=dev)
    if valid0.shape != (b, n1) or valid1.shape != (b, n2) \
            or valid0.dtype != torch.bool or valid1.dtype != torch.bool \
            or valid0.device != dev or valid1.device != dev:
        raise ValueError(f"{what}: valid masks must be bool [B, N] on the descriptors' device")
    align = 16 if desc0.dtype == torch.float32 else 8
    _check_rows(desc0, "desc0", align, what)
    _check_rows(desc1, "desc1", align, what)
    _check_rows(valid0, "valid0", 1, what)
    _check_rows(valid1, "valid1", 1, what)
    return b, n1, n2, c, valid0, valid1


NN_TC_ROW_BYTES = 128  # ROW_BYTES of csrc/nn_tc.cuh: C is padded to whole 128-byte rows


def nn_tc_scratch(desc0: torch.Tensor, desc1: torch.Tensor, seconds: bool = False):
    """Scratch of the tensor-core matcher kernels K2, K4, K5 and K6
    (``csrc/nn_tc.cuh``), in one allocation: each operand padded with zeros
    to whole 128-byte rows, [B or 1, N, Cp] (one batch entry for a stride-0
    operand), twice over (TF32 hi and lo) for f32; the 64-bit (value,
    index) keys of rows [B, N1] and columns [B, N2]; with ``seconds`` (K4)
    also the encoded int32 second values of rows and columns. Returns
    (buffer, its region addresses): keep the buffer alive while the kernel
    runs."""
    b, n1, c = desc0.shape
    n2 = desc1.shape[1]
    per = NN_TC_ROW_BYTES // desc0.element_size()
    cp = -(-c // per) * per
    copies = 1 if desc0.dtype == torch.bfloat16 else 2
    sizes = [copies * n1 * (1 if desc0.stride(0) == 0 else b) * cp * desc0.element_size(),
             copies * n2 * (1 if desc1.stride(0) == 0 else b) * cp * desc1.element_size(),
             8 * b * n1, 8 * b * n2] + ([4 * b * n1, 4 * b * n2] if seconds else [])
    starts = [0]
    for size in sizes[:-1]:
        starts.append(starts[-1] + -(-size // 256) * 256)
    buf = torch.empty(starts[-1] + sizes[-1], dtype=torch.uint8, device=desc0.device)
    return buf, [buf.data_ptr() + start for start in starts]


def mutual_nn_match_cuda(desc0: torch.Tensor, desc1: torch.Tensor,
                         valid0: torch.Tensor | None = None,
                         valid1: torch.Tensor | None = None):
    """desc0 [B, N1, C], desc1 [B, N2, C] (float32 or bfloat16), optional
    valid0 [B, N1] / valid1 [B, N2] bool → (matches0 [B, N1] int32 with −1
    for no match, scores0 [B, N1] float32)."""
    if desc0.device.type == "cpu":
        return mutual_nn_match(desc0, desc1, valid0, valid1)
    b, n1, n2, c, valid0, valid1 = check_match_args(desc0, desc1, valid0, valid1,
                                                     "mutual_nn_match_cuda")
    dev = desc0.device
    lib = _lib()
    buf, scratch = nn_tc_scratch(desc0, desc1)
    matches = torch.empty((b, n1), dtype=torch.int32, device=dev)
    scores = torch.empty((b, n1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sfd2_mutual_nn_match(
            desc0.data_ptr(), desc1.data_ptr(), valid0.data_ptr(), valid1.data_ptr(),
            desc0.stride(0), desc1.stride(0), valid0.stride(0), valid1.stride(0),
            b, n1, n2, c, int(desc0.dtype == torch.bfloat16),
            *scratch, matches.data_ptr(), scores.data_ptr(), stream)
    cuda_build.check(lib, code, "mutual_nn_match_cuda")
    mutual_nn_match_cuda.launches += 1
    mutual_nn_match_cuda.shapes[(b, n1, n2, c, desc0.stride(0) == 0)] += 1
    return matches, scores


mutual_nn_match_cuda.launches = 0
# (b, n1, n2, c, desc0 broadcast with batch stride 0) of each launch
mutual_nn_match_cuda.shapes = collections.Counter()
