"""Feature and match stores: HDF5 file or in-memory dict, one interface.

Port of ``sfd2_tpu/io/feature_store.py``. The reference layouts are kept:
one group per image with ``keypoints`` [N, 2], ``descriptors`` **[C, N]**,
``scores`` [N], ``image_size`` and optional ``labels``; one group per
pair, named ``names_to_pair(n0, n1)``, with ``matches0`` and
``matching_scores0`` (``hloc/match_features.py:113-119``). A store opened
with a path is an HDF5 file (h5py is imported only then); with no path it
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


def names_to_pair(name0: str, name1: str) -> str:
    """hloc pair-group key (``hloc/utils/parsers.py:66``)."""
    return "_".join((name0.replace("/", "-"), name1.replace("/", "-")))


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


class MatchStore:
    """Read/write pairwise matches (reference-compatible layout)."""

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

    def _store(self):
        return self._groups if self._f is None else self._f

    def has_pair(self, name0: str, name1: str) -> bool:
        store = self._store()
        return names_to_pair(name0, name1) in store or names_to_pair(name1, name0) in store

    def write(self, name0, name1, matches0: np.ndarray, scores0: np.ndarray | None = None):
        # int32, not the reference's int16: max_keypoints is a free knob and
        # indices above 32767 must not wrap.
        data = {"matches0": np.asarray(matches0, np.int32)}
        if scores0 is not None:
            data["matching_scores0"] = np.asarray(scores0, np.float16)
        key = names_to_pair(name0, name1)
        if self._f is None:
            self._groups[key] = data
            return
        if key in self._f:
            del self._f[key]
        grp = self._f.create_group(key)
        for k, arr in data.items():
            grp.create_dataset(k, data=arr)

    def _read_group(self, key: str):
        grp = self._store()[key]
        m = np.asarray(grp["matches0"][()]).astype(np.int64)
        s = (np.asarray(grp["matching_scores0"][()]).astype(np.float32)
             if "matching_scores0" in grp else np.zeros(len(m), np.float32))
        return m, s

    def read(self, name0, name1, num_keypoints0: int | None = None):
        """(matches0 [N0] int64, scores0 [N0] float32); reading a reversed
        pair inverts the match direction. For reversed reads, pass
        `num_keypoints0` (name0's keypoint count) to size the output;
        otherwise it covers only up to the largest matched index."""
        key = names_to_pair(name0, name1)
        if key in self._store():
            return self._read_group(key)
        m_rev, s_rev = self._read_group(names_to_pair(name1, name0))
        # Invert: matches0_fwd[j] = i where m_rev[i] = j.
        max_idx = int(m_rev.max()) + 1 if m_rev.size and m_rev.max() >= 0 else 0
        n0 = max(num_keypoints0 if num_keypoints0 is not None else max_idx, 0)
        m = np.full(n0, -1, np.int64)
        s = np.zeros(n0, np.float32)
        src = np.nonzero(m_rev >= 0)[0]
        src = src[m_rev[src] < n0]
        m[m_rev[src]] = src
        s[m_rev[src]] = s_rev[src]
        return m, s
