"""K6 — bidirectional top-2 nearest neighbours as a hand-written CUDA kernel
(Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_match.py::nn_top2_pallas``, with the
contract of ``ops/matching.py::nn_top2`` (the biases and lowest-index
argmax of ``nn_argmax``, multiset second values). It is the public op
``nn_top2`` and the kernel of the NNR large-bank route
(``ops/matching.py::mutual_nn_ratio_match_tiled``). The kernel
(``csrc/nn_top2.cu`` on ``csrc/nn_tc.cuh``, K5's tensor-core tiles) computes
each similarity once and reduces it both ways; tiles merge by atomics
(K5's keys, the second value by the loser rule). It takes any N1, N2, any
C % 4 == 0, f32 (3×TF32) or bf16 descriptors (accumulation is f32), and a
batch stride of 0 on ``desc0``/``valid0``. The wrapper allocates K5's
scratch (``cuda_match.nn_tc_scratch``).

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.cuda_match import check_match_args, nn_tc_scratch
from sfd2_torch.ops.matching import nn_top2


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("nn_top2")
    fn = lib.sfd2_nn_top2
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p,
                       p]
        fn.restype = ctypes.c_int
    return lib


def nn_top2_cuda(desc0: torch.Tensor, desc1: torch.Tensor,
                 valid0: torch.Tensor | None = None, valid1: torch.Tensor | None = None):
    """desc0 [B, N1, C], desc1 [B, N2, C] (float32 or bfloat16), optional
    valid masks → (max12, nn12, max12_2nd [B, N1], max21, nn21, max21_2nd
    [B, N2]); values f32, indices int32."""
    if desc0.device.type == "cpu":
        return nn_top2(desc0, desc1, valid0, valid1)
    what = "nn_top2_cuda"
    b, n1, n2, c, valid0, valid1 = check_match_args(desc0, desc1, valid0, valid1, what)
    dev = desc0.device
    lib = _lib()
    buf, scratch = nn_tc_scratch(desc0, desc1)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty((b, n1), **f32), torch.empty((b, n1), **i32), torch.empty((b, n1), **f32),
           torch.empty((b, n2), **f32), torch.empty((b, n2), **i32), torch.empty((b, n2), **f32))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sfd2_nn_top2(
            desc0.data_ptr(), desc1.data_ptr(), valid0.data_ptr(), valid1.data_ptr(),
            desc0.stride(0), desc1.stride(0), valid0.stride(0), valid1.stride(0),
            b, n1, n2, c, int(desc0.dtype == torch.bfloat16),
            *scratch, *(t.data_ptr() for t in out), stream)
    cuda_build.check(lib, code, what)
    nn_top2_cuda.launches += 1
    nn_top2_cuda.shapes[(b, n1, n2, c, desc0.stride(0) == 0)] += 1
    return out


nn_top2_cuda.launches = 0
# (b, n1, n2, c, desc0 broadcast with batch stride 0) of each launch
nn_top2_cuda.shapes = collections.Counter()
