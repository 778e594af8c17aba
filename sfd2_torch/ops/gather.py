"""Row gather ``out[m] = table[idx[m]]``: the plain version of kernel K3
(``cuda_gather.py``).

Port of ``sfd2_tpu/ops/pallas_gather.py::gather_rows``, the row gather
that bundle adjustment runs on its camera and point tables. On the TPU it
dispatched to a Pallas chunk walk below a crossover size and to XLA's
gather above it; that crossover existed for the TPU's in-register gather.
Here the dispatch is K3's wrapper itself: a CUDA tensor always goes to
the kernel and a CPU tensor to this plain version. The reference's
``idx_sorted`` hint is not carried: nothing here reads a sort order.
"""

from __future__ import annotations

import torch


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3's plain version: table [N, C], idx [M] int32 → [M, C]."""
    return table.index_select(0, idx)
