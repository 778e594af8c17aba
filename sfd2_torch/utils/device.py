"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``; asking for CUDA where there is
none raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
