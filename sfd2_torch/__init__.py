"""sfd2_torch — the PyTorch/CUDA port of sfd2_tpu for NVIDIA Hopper.

Mirrors ``sfd2_tpu/`` module for module (``sfd2_torch/<pkg>/<mod>.py`` is
the counterpart of ``sfd2_tpu/<pkg>/<mod>.py``). Imports torch, numpy and
scipy only; the Pallas kernels of the query path are replaced by
hand-written CUDA kernels in ``csrc/`` (``ops/cuda_stem.py``,
``ops/cuda_match.py``), built with nvcc at first use.
"""
