"""A cell's controls, one file per driver kind: ``controls/<kind>.py``.

Each file names its controls in ``CONTROLS`` and defines
``control(cell, seed, device, which)``: the compared numbers of control
`which`, through the driver's own ``verify``: the reference put in the
program's place and computed one precision below the configuration's, or
the program with a fault planted. ``program(cell, seed, device)``,
where a kind has it, gives the program's own readings of one timed-size
call. ``portbench/control.py`` loads the file by the mix's driver name.
"""

from __future__ import annotations

import torch


class full_precision:
    """TF32 off in matmuls and cuDNN convolutions inside the block (the
    references' setting) or, with ``False``, the flags the process started
    with (a run's window)."""

    START = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def __init__(self, on: bool = True):
        self.flags = (False, False) if on else self.START

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
