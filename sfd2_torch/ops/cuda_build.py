"""Build and load the port's CUDA kernels: nvcc → shared library → ctypes.

Each ``sfd2_torch/csrc/<name>.cu`` is compiled on its own for ``sm_90a``
into ``sfd2_torch/_build/lib<name>-<hash>.so`` (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt) and loaded with ctypes; ``SOURCE_FLAGS``
adds a source's own flags. Nothing is built when a module is imported:
``load`` builds on first use, ``build`` compiles several sources in
parallel (one nvcc process each, all started together). ``defines`` (``-D``
names) build a variant of a source beside it, under a hash of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# twoview.cu mirrors the rounding of torch's elementwise ops, one rounding
# per op: no product and sum contracted into an FMA that the source does
# not write as fmaf (csrc/twoview.cu says why).
SOURCE_FLAGS: Dict[str, list] = {"twoview": ["-fmad=false"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # by name, "+"-joined with a variant's defines


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _flags(name: str, defines: Sequence[str]) -> list[str]:
    return [*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *(f"-D{d}" for d in defines)]


def _paths(name: str, defines: Sequence[str] = ()):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(_flags(name, defines)).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def kernel_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Iterable[str] | None = None, defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile the named sources (all of csrc/ by default) that are not
    built yet; returns nvcc's output (with ``-Xptxas -v``: registers,
    shared memory and spills) per source. Raises if any build fails."""
    names = list(names) if names is not None else kernel_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, out = _paths(name, defines)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name, defines), "-o", str(tmp), str(src)]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    key = "+".join((name, *defines))
    with _lock:
        if key not in _libs:
            _, out = _paths(name, defines)
            if not out.exists():
                build([name], defines)
            lib = ctypes.CDLL(str(out))
            lib.sfd2_error_string.argtypes = [ctypes.c_int]
            lib.sfd2_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return _libs[key]


def sass(name: str) -> str:
    """The SASS of the built library for csrc/<name>.cu (``cuobjdump -sass``,
    from the toolkit beside nvcc), built first if needed."""
    load(name)
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_paths(name)[1])], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.sfd2_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
