"""K4 — the fused mutual-NN + symmetric ratio matcher as a hand-written
CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_match.py::
mutual_nn_ratio_match_pallas``, with the contract of
``ops/matching.py::mutual_nn_ratio_match`` (max-equality mutuality,
multiset top-2 on rows and columns). The kernel (``csrc/match_ratio.cu``)
runs on the tensor cores through K6's tiles (``csrc/nn_tc.cuh``): f32
descriptors as 3×TF32 (within about 1e-6 of the plain f32 product), bf16
natively as bf16 × bf16, accumulation in f32; each similarity is computed
once, the tiles' row and column top-2 merge by atomics (the second value by
the loser rule), and a last pass applies mutuality and the ratio test. It
takes any N1, N2 (ragged edges are masked in the kernel, so the TPU's tiled
fallback K6 is not on this path), any C % 4 == 0, and a batch stride of 0
on ``desc0``/``valid0``.

The wrapper allocates the scratch (``cuda_match.nn_tc_scratch`` with the
second values): the padded, split operands, the keys and the seconds,
O(B·(N1 + N2)) beside the operands, for one call.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.cuda_match import check_match_args, nn_tc_scratch
from sfd2_torch.ops.matching import mutual_nn_ratio_match


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("match_ratio")
    fn = lib.sfd2_mutual_nn_ratio_match
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, f,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def mutual_nn_ratio_match_cuda(desc0: torch.Tensor, desc1: torch.Tensor, ratio: float = 0.9,
                               valid0: torch.Tensor | None = None,
                               valid1: torch.Tensor | None = None):
    """desc0 [B, N1, C], desc1 [B, N2, C] (float32 or bfloat16), optional
    valid masks → (matches0 [B, N1] int32 with −1 for no match, scores0
    [B, N1] float32)."""
    if desc0.device.type == "cpu":
        return mutual_nn_ratio_match(desc0, desc1, ratio, valid0, valid1)
    what = "mutual_nn_ratio_match_cuda"
    b, n1, n2, c, valid0, valid1 = check_match_args(desc0, desc1, valid0, valid1, what)
    dev = desc0.device
    lib = _lib()
    buf, scratch = nn_tc_scratch(desc0, desc1, seconds=True)
    matches = torch.empty((b, n1), dtype=torch.int32, device=dev)
    scores = torch.empty((b, n1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sfd2_mutual_nn_ratio_match(
            desc0.data_ptr(), desc1.data_ptr(), valid0.data_ptr(), valid1.data_ptr(),
            desc0.stride(0), desc1.stride(0), valid0.stride(0), valid1.stride(0),
            b, n1, n2, c, int(desc0.dtype == torch.bfloat16), float(ratio),
            *scratch, matches.data_ptr(), scores.data_ptr(), stream)
    cuda_build.check(lib, code, what)
    mutual_nn_ratio_match_cuda.launches += 1
    mutual_nn_ratio_match_cuda.shapes[(b, n1, n2, c, desc0.stride(0) == 0)] += 1
    return matches, scores


mutual_nn_ratio_match_cuda.launches = 0
# (b, n1, n2, c, desc0 broadcast with batch stride 0) of each launch
mutual_nn_ratio_match_cuda.shapes = collections.Counter()
