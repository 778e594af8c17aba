"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``; asking for CUDA where there is
none raises instead of silently running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array on `device` without waiting for the device (the
    copy is staged; a blocking copy would synchronise with queued work)."""
    return torch.from_numpy(a).to(device, non_blocking=True)
