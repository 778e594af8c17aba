"""K5 — bidirectional nearest neighbour as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_match.py::nn_argmax_pallas``, with the
contract of ``ops/matching.py::nn_argmax`` (row reduction over
``s + col_bias``, column reduction over ``s + row_bias``, lowest index on
an exact tie both ways). It is the public op ``nn_argmax`` and the kernel of
the NNM large-bank route (``ops/matching.py::mutual_nn_match_tiled``). The
kernel (``csrc/nn_argmax.cu`` on ``csrc/nn_tc.cuh``) runs on the tensor
cores: f32 descriptors as 3×TF32, bf16 as bf16, f32 accumulation. It takes
any N1, N2, any C % 4 == 0, and a batch stride of 0 on ``desc0``/``valid0``
to broadcast one query to every bank without copying it. The wrapper
allocates its scratch (``cuda_match.nn_tc_scratch``): the zero-padded (and,
for f32, TF32-split) operands and one 64-bit key per row and per column.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.cuda_match import check_match_args, nn_tc_scratch
from sfd2_torch.ops.matching import nn_argmax


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("nn_argmax")
    fn = lib.sfd2_nn_argmax
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def nn_argmax_cuda(desc0: torch.Tensor, desc1: torch.Tensor,
                   valid0: torch.Tensor | None = None, valid1: torch.Tensor | None = None):
    """desc0 [B, N1, C], desc1 [B, N2, C] (float32 or bfloat16), optional
    valid0 [B, N1] / valid1 [B, N2] bool → (max12 [B, N1] f32, nn12 [B, N1]
    int32, max21 [B, N2] f32, nn21 [B, N2] int32)."""
    if desc0.device.type == "cpu":
        return nn_argmax(desc0, desc1, valid0, valid1)
    what = "nn_argmax_cuda"
    b, n1, n2, c, valid0, valid1 = check_match_args(desc0, desc1, valid0, valid1, what)
    dev = desc0.device
    lib = _lib()
    buf, scratch = nn_tc_scratch(desc0, desc1)
    rmax = torch.empty((b, n1), dtype=torch.float32, device=dev)
    ridx = torch.empty((b, n1), dtype=torch.int32, device=dev)
    cmax = torch.empty((b, n2), dtype=torch.float32, device=dev)
    cidx = torch.empty((b, n2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sfd2_nn_argmax(
            desc0.data_ptr(), desc1.data_ptr(), valid0.data_ptr(), valid1.data_ptr(),
            desc0.stride(0), desc1.stride(0), valid0.stride(0), valid1.stride(0),
            b, n1, n2, c, int(desc0.dtype == torch.bfloat16),
            *scratch, rmax.data_ptr(), ridx.data_ptr(),
            cmax.data_ptr(), cidx.data_ptr(), stream)
    cuda_build.check(lib, code, what)
    nn_argmax_cuda.launches += 1
    nn_argmax_cuda.shapes[(b, n1, n2, c, desc0.stride(0) == 0)] += 1
    return rmax, ridx, cmax, cidx


nn_argmax_cuda.launches = 0
# (b, n1, n2, c, desc0 broadcast with batch stride 0) of each launch
nn_argmax_cuda.shapes = collections.Counter()
