"""K2 — the fused mutual-NN matcher as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_match.py::mutual_nn_match_pallas``,
with the contract of ``ops/matching.py::mutual_nn_match`` (max-equality
mutuality: an exact tie between rows is granted to every tying row). The
kernel (``csrc/match.cu``) takes any N1, N2 (ragged edges are masked in
the kernel, so there is no tiled fallback), C % 4 == 0 up to 256, f32 or
bf16 descriptors (bf16 is widened to f32, accumulation is f32), and a
batch stride of 0 on ``desc0``/``valid0`` to broadcast one query to every
bank without copying it.

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
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check_rows(t: torch.Tensor, name: str, align: int):
    if t.stride(-1) != 1 or (t.ndim == 3 and t.stride(1) != t.shape[2]):
        raise ValueError(f"mutual_nn_match_cuda: {name} rows must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"mutual_nn_match_cuda: {name} is not {align}-byte aligned")


def mutual_nn_match_cuda(desc0: torch.Tensor, desc1: torch.Tensor,
                         valid0: torch.Tensor | None = None,
                         valid1: torch.Tensor | None = None):
    """desc0 [B, N1, C], desc1 [B, N2, C] (float32 or bfloat16), optional
    valid0 [B, N1] / valid1 [B, N2] bool → (matches0 [B, N1] int32 with −1
    for no match, scores0 [B, N1] float32)."""
    if desc0.device.type == "cpu":
        return mutual_nn_match(desc0, desc1, valid0, valid1)
    if desc0.device.type != "cuda" or desc1.device != desc0.device:
        raise ValueError(f"mutual_nn_match_cuda: unsupported devices {desc0.device}, {desc1.device}")
    if desc0.ndim != 3 or desc1.ndim != 3:
        raise ValueError("mutual_nn_match_cuda: need [B, N, C] descriptors")
    b, n1, c = desc0.shape
    n2 = desc1.shape[1]
    if desc1.shape[0] != b or desc1.shape[2] != c:
        raise ValueError(f"mutual_nn_match_cuda: shapes {tuple(desc0.shape)} vs {tuple(desc1.shape)}")
    if desc0.dtype != desc1.dtype or desc0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mutual_nn_match_cuda: unsupported dtypes {desc0.dtype}, {desc1.dtype}")
    if c % 4 or not 0 < c <= 256 or b == 0 or n1 == 0 or n2 == 0:
        raise ValueError(f"mutual_nn_match_cuda: unsupported shape B={b} N1={n1} N2={n2} C={c}")
    dev = desc0.device
    if valid0 is None:
        valid0 = torch.ones((1, n1), dtype=torch.bool, device=dev).expand(b, n1)
    if valid1 is None:
        valid1 = torch.ones((b, n2), dtype=torch.bool, device=dev)
    if valid0.shape != (b, n1) or valid1.shape != (b, n2) \
            or valid0.dtype != torch.bool or valid1.dtype != torch.bool \
            or valid0.device != dev or valid1.device != dev:
        raise ValueError("mutual_nn_match_cuda: valid masks must be bool [B, N] on the descriptors' device")
    align = 16 if desc0.dtype == torch.float32 else 8
    _check_rows(desc0, "desc0", align)
    _check_rows(desc1, "desc1", align)
    _check_rows(valid0, "valid0", 1)
    _check_rows(valid1, "valid1", 1)

    rmax = torch.empty((b, n1), dtype=torch.float32, device=dev)
    ridx = torch.empty((b, n1), dtype=torch.int32, device=dev)
    cmax = torch.empty((b, n2), dtype=torch.int32, device=dev)
    matches = torch.empty((b, n1), dtype=torch.int32, device=dev)
    scores = torch.empty((b, n1), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sfd2_mutual_nn_match(
            desc0.data_ptr(), desc1.data_ptr(), valid0.data_ptr(), valid1.data_ptr(),
            desc0.stride(0), desc1.stride(0), valid0.stride(0), valid1.stride(0),
            b, n1, n2, c, int(desc0.dtype == torch.bfloat16),
            rmax.data_ptr(), ridx.data_ptr(), cmax.data_ptr(),
            matches.data_ptr(), scores.data_ptr(), stream)
    cuda_build.check(lib, code, "mutual_nn_match_cuda")
    mutual_nn_match_cuda.launches += 1
    mutual_nn_match_cuda.shapes[(b, n1, n2, c)] += 1
    return matches, scores


mutual_nn_match_cuda.launches = 0
mutual_nn_match_cuda.shapes = collections.Counter()  # (b, n1, n2, c) of each launch
