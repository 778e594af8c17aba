"""K3 — the row gather as a hand-written CUDA kernel (Hopper).

Counterpart of ``sfd2_tpu/ops/pallas_gather.py::gather_rows_pallas``, with
the contract of ``ops/gather.py::gather_rows_plain``: ``out[m, :] =
table[idx[m], :]`` for a float32 table [N, C] with C ≤ 16 and int32 idx
[M], 0 ≤ idx < N (an index outside the table yields a row of NaN rather
than a read out of bounds). The kernel (``csrc/gather.cu``) is one pass
with threads over M×C.

A launch is a microsecond of device work, so the wrapper's host time is
the cost: the C entry point and its ``argtypes`` are resolved once and
kept here (no ``cuda_build`` lock per call), the checks compare dtype,
rank and contiguity before anything allocates, and the device context is
entered only when the table is not on the current device. Bundle
adjustment replays its K3 launches from a CUDA graph (``sfm/ba.py``):
``graph_capture_record`` and ``count_graph_replays`` keep ``launches`` and
``shapes`` equal to the kernels that really ran.

On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes

import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.ops.gather import gather_rows_plain

MAX_C = 16

_kernel = None  # the C entry point sfd2_gather_rows, resolved on first use


def _entry():
    global _kernel
    if _kernel is None:
        fn = cuda_build.load("gather").sfd2_gather_rows
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, ll, ll, i, p, p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, C] float32, idx [M] int32 → [M, C] float32."""
    if not table.is_cuda:
        if table.device.type == "cpu":
            return gather_rows_plain(table, idx)
        raise ValueError(f"gather_rows_cuda: unsupported devices {table.device}, {idx.device}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows_cuda: need table [N, C] and idx [M], got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows_cuda: unsupported dtypes {table.dtype}, {idx.dtype}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows_cuda: table and idx must be contiguous")
    n, c = table.shape
    m = idx.shape[0]
    if not 0 < c <= MAX_C:
        raise ValueError(f"gather_rows_cuda: C={c} outside 1..{MAX_C}")
    dev = table.get_device()
    if idx.get_device() != dev:
        raise ValueError(f"gather_rows_cuda: unsupported devices {table.device}, {idx.device}")
    out = table.new_empty((m, c))
    if m == 0:
        return out
    fn = _entry()
    if dev == torch.cuda.current_device():
        code = fn(table.data_ptr(), idx.data_ptr(), n, m, c, out.data_ptr(),
                  torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            code = fn(table.data_ptr(), idx.data_ptr(), n, m, c, out.data_ptr(),
                      torch._C._cuda_getCurrentRawStream(dev))
    if code:
        cuda_build.check(cuda_build.load("gather"), code, "gather_rows_cuda")
    gather_rows_cuda.launches += 1
    gather_rows_cuda.shapes[(n, m, c)] += 1
    return out


gather_rows_cuda.launches = 0
gather_rows_cuda.shapes = collections.Counter()  # (n, m, c) of each launch


@contextlib.contextmanager
def graph_capture_record():
    """Around a CUDA-graph capture: yields a Counter that receives the K3
    launch shapes recorded inside, and leaves ``launches`` and ``shapes`` as
    they were before it (a captured launch runs only when the graph is
    replayed; ``count_graph_replays`` counts it then)."""
    launches = gather_rows_cuda.launches
    before = collections.Counter(gather_rows_cuda.shapes)
    captured = collections.Counter()
    try:
        yield captured
    finally:
        captured.update(gather_rows_cuda.shapes - before)
        gather_rows_cuda.launches = launches
        gather_rows_cuda.shapes.clear()
        gather_rows_cuda.shapes.update(before)


def count_graph_replays(captured: collections.Counter, replays: int = 1) -> None:
    """Count the K3 launches of `replays` replays of a graph whose capture
    recorded `captured` (from ``graph_capture_record``)."""
    for key, n in captured.items():
        gather_rows_cuda.shapes[key] += n * replays
    gather_rows_cuda.launches += sum(captured.values()) * replays
