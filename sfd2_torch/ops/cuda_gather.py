"""K3 — the row gather as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_gather.py::gather_rows_pallas``, with
the contract of ``ops/gather.py::gather_rows_plain``: ``out[m, :] =
table[idx[m], :]`` for a float32 table [N, C] with C ≤ 16 and int32 idx
[M], 0 ≤ idx < N (an index outside the table yields a row of NaN rather
than a read out of bounds). The kernel (``csrc/gather.cu``) is one pass
with threads over M×C.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.gather import gather_rows_plain

MAX_C = 16


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gather")
    fn = lib.sfd2_gather_rows
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, ll, ll, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, C] float32, idx [M] int32 → [M, C] float32."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows_cuda: unsupported devices {table.device}, {idx.device}")
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows_cuda: need table [N, C] and idx [M], got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    n, c = table.shape
    m = idx.shape[0]
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows_cuda: unsupported dtypes {table.dtype}, {idx.dtype}")
    if not 0 < c <= MAX_C:
        raise ValueError(f"gather_rows_cuda: C={c} outside 1..{MAX_C}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows_cuda: table and idx must be contiguous")
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = lib.sfd2_gather_rows(table.data_ptr(), idx.data_ptr(), n, m, c,
                                    out.data_ptr(), stream)
    cuda_build.check(lib, code, "gather_rows_cuda")
    gather_rows_cuda.launches += 1
    gather_rows_cuda.shapes[(n, m, c)] += 1
    return out


gather_rows_cuda.launches = 0
gather_rows_cuda.shapes = collections.Counter()  # (n, m, c) of each launch
