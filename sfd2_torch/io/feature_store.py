"""Per-image feature store: HDF5 file or in-memory dict, one interface.

Port of ``sfd2_tpu/io/feature_store.py`` (``FeatureStore`` and
``ImageFeatures``). The reference layout is kept: one group per image
with ``keypoints`` [N, 2], ``descriptors`` **[C, N]**, ``scores`` [N],
``image_size`` and optional ``labels``. ``FeatureStore(path)`` opens an
HDF5 file (h5py is imported only then); ``FeatureStore()`` with no path
keeps the same groups in a dict, for machines without h5py.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

import numpy as np


class ImageFeatures(NamedTuple):
    keypoints: np.ndarray  # [N, 2] float32 (x, y)
    descriptors: np.ndarray  # [N, C] float32
    scores: np.ndarray  # [N] float32
    image_size: np.ndarray | None  # [2] (w, h) or None
    labels: np.ndarray | None = None  # [N] int32 semantic ids (0 = none)


def _open_h5(path: Path, mode: str):
    """Open an HDF5 store; append/write modes recover only from a
    truncated non-HDF5 stub left by a killed writer."""
    import h5py

    try:
        return h5py.File(path, mode)
    except OSError:
        if mode in ("a", "w") and path.exists() and not h5py.is_hdf5(str(path)):
            path.unlink()
            return h5py.File(path, mode)
        raise


class FeatureStore:
    """Read/write per-image features (reference-compatible layout)."""

    def __init__(self, path: os.PathLike | None = None, mode: str = "r"):
        self.path = Path(path) if path is not None else None
        self._groups: Dict[str, Dict[str, np.ndarray]] | None = None
        self._f = None
        if self.path is None:
            self._groups = {}
        else:
            self._f = _open_h5(self.path, mode)

    def close(self):
        if self._f is not None:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __contains__(self, name: str) -> bool:
        return name in (self._groups if self._f is None else self._f)

    def keys(self) -> Iterable[str]:
        if self._f is None:
            return list(self._groups)
        import h5py

        def walk(group, prefix=""):
            for k, v in group.items():
                full = f"{prefix}/{k}" if prefix else k
                if isinstance(v, h5py.Group):
                    if "keypoints" in v:
                        yield full
                    else:
                        yield from walk(v, full)

        return list(walk(self._f))

    def write(self, name: str, feats: ImageFeatures, as_half: bool = False) -> None:
        """`as_half` stores descriptors as float16; reads upcast to float32."""
        desc = np.ascontiguousarray(np.asarray(feats.descriptors).T)  # [C, N]
        if as_half:
            desc = desc.astype(np.float16)
        data = {
            "keypoints": np.asarray(feats.keypoints, np.float32),
            "descriptors": desc,
            "scores": np.asarray(feats.scores, np.float32),
        }
        if feats.image_size is not None:
            data["image_size"] = np.asarray(feats.image_size)
        if feats.labels is not None:
            data["labels"] = np.asarray(feats.labels, np.int32)
        if self._f is None:
            self._groups[name] = data
            return
        if name in self._f:
            del self._f[name]
        grp = self._f.create_group(name)
        for key, arr in data.items():
            grp.create_dataset(key, data=arr)

    def read(self, name: str) -> ImageFeatures:
        grp = self._groups[name] if self._f is None else self._f[name]
        kpts = np.asarray(grp["keypoints"][()], np.float32)
        desc = np.asarray(grp["descriptors"][()], np.float32)
        if desc.shape[0] != kpts.shape[0] and desc.shape[1] == kpts.shape[0]:
            desc = desc.T  # stored [C, N]
        scores = np.asarray(grp["scores"][()], np.float32).reshape(-1)
        size = grp["image_size"][()] if "image_size" in grp else None
        labels = np.asarray(grp["labels"][()], np.int32) if "labels" in grp else None
        return ImageFeatures(kpts[:, :2], desc, scores, size, labels)

    def read_padded(self, name: str, k: int, with_labels: bool = False):
        """(keypoints [k,2], descriptors [k,C], scores [k], valid [k]) — plus
        labels [k] int32 (0-filled when absent) if `with_labels`."""
        f = self.read(name)
        n = min(len(f.keypoints), k)
        c = f.descriptors.shape[1]
        kp = np.zeros((k, 2), np.float32)
        de = np.zeros((k, c), np.float32)
        sc = np.zeros((k,), np.float32)
        va = np.zeros((k,), bool)
        kp[:n] = f.keypoints[:n]
        de[:n] = f.descriptors[:n]
        sc[:n] = f.scores[:n]
        va[:n] = True
        if with_labels:
            lb = np.zeros((k,), np.int32)
            if f.labels is not None:
                lb[:n] = f.labels[:n]
            return kp, de, sc, va, lb
        return kp, de, sc, va
