"""Native (C++) host kernels of the port, loaded with ctypes.

``sfd2_torch/csrc/tracks.cpp`` (the union-find of track building, union
by rank with path halving) is compiled on first use with
``g++ -O3 -std=c++17 -shared -fPIC`` into
``sfd2_torch/_build/libsfd2_tracks.so``, under a lock, and rebuilt when
the source is newer than the library. A failed build raises: there is no
quiet fallback to Python (``sfm/tracks.py::UnionFind`` is the plain
version the tests hold this one against).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "tracks.cpp"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsfd2_tracks.so"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compile() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """The loaded union-find library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIB_PATH.exists() or SRC.stat().st_mtime > LIB_PATH.stat().st_mtime:
                _compile()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.uf_build.restype = ctypes.c_int64
            arr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.uf_build.argtypes = [ctypes.c_int64, ctypes.c_int64, arr, arr, arr]
            _lib = lib
        return _lib


def union_find_roots(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Root id per node after uniting the [E, 2] edges in order."""
    lib = get_lib()
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(edges) and (edges.min() < 0 or edges.max() >= n_nodes):
        raise IndexError(f"edge node out of range [0, {n_nodes})")
    a = np.ascontiguousarray(edges[:, 0])
    b = np.ascontiguousarray(edges[:, 1])
    out = np.empty(n_nodes, np.int64)
    lib.uf_build(n_nodes, len(edges), a, b, out)
    return out
