"""Device meshes and the helpers that split work over them.

Port of ``sfd2_tpu/parallel/mesh.py``. The JAX package runs one program
over a ``jax.sharding.Mesh``: one process drives every device, and
``NamedSharding`` annotations split a batch over the ``data`` axis. The
port keeps that single-process model for matching and extraction: a
`Mesh` is an array of ``torch.device``s with axis names, `put_batch`
splits dim 0 of every tensor evenly into one chunk per device of an axis,
and `put_replicated` copies tensors or modules to every device; the
caller launches each device's share and gathers the results. A mesh may
name one device several times (``["cpu"] * 8`` in tests, ``["cuda:0"] * 4``
on one card), the counterpart of XLA's forced host devices: the split,
pad and gather logic then runs on one device.

Training is data-parallel with one process per device instead
(``parallel/distributed.py``), the torch idiom for it.

Axes:
  data  — batch / keyframe data parallelism (extraction, matching)
  model — reserved for sharding the descriptor bank / BA point blocks
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes; ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = ("data",)):
        """`devices`: an object array of ``torch.device``s, one axis per name."""
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {arr.ndim} with axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along `axis` (at index 0 of every other axis)."""
        a = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, a, 0).reshape(self.devices.shape[a], -1)[:, 0])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(n_devices: int | None = None, axis_names: Sequence[str] = ("data",),
              shape: Sequence[int] | None = None, devices=None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device), the first
    `n_devices` of them, laid out as `shape` (default: all on the first
    axis)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] * n for the CPU")
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def shard_batch(mesh: Mesh, axis: str = "data") -> List[torch.device]:
    """Where the chunks of a [B, ...] batch split over `axis` go."""
    return mesh.axis_devices(axis)


def replicate(mesh: Mesh) -> List[torch.device]:
    """Where a replicated value goes: every device of the mesh."""
    return list(mesh.devices.ravel())


def _map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def to_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def put_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """A pytree of [B, ...] tensors or arrays → one tree per device of
    `axis`, each leaf's chunk of B / n rows on that device. B must be
    divisible by the axis size (pad with invalid rows)."""
    devices = shard_batch(mesh, axis)
    n = len(devices)
    leaves = []
    _map(leaves.append, tree)
    for leaf in leaves:
        if leaf.shape[0] % n:
            raise ValueError(f"batch {leaf.shape[0]} not divisible by mesh axis {axis}={n}")
    return [_map(lambda x, i=i, d=d: to_tensor(x)[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                 .to(d), tree) for i, d in enumerate(devices)]


def put_replicated(mesh: Mesh, tree, axis: str | None = None) -> list:
    """One copy of `tree` per device of the mesh (or of `axis` only, where
    each device there runs its own share of a batch): tensors and arrays
    moved there, an ``nn.Module`` deep-copied there."""
    def place(d):
        if isinstance(tree, torch.nn.Module):
            return copy.deepcopy(tree).to(d)
        return _map(lambda x: to_tensor(x).to(d), tree)

    return [place(d) for d in (replicate(mesh) if axis is None else shard_batch(mesh, axis))]


def gather_batch(chunks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The chunks of `put_batch` results concatenated on `device`."""
    return torch.cat([c.to(device) for c in chunks])
