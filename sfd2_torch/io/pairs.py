"""Pair-list and query-list parsing (host-side).

Port of ``sfd2_tpu/io/pairs.py``. Capability parity: ``it_loc/parsers.py``
/ ``hloc/utils/parsers.py`` — query-with-intrinsics lists (``name model w
h params…``), retrieval pair files (``query db`` per line, e.g. NetVLAD
top-50), the Extended CMU-Seasons list variant with its fixed per-camera
OPENCV intrinsics, pair files (``write_pairs``, ``read_pairs``), and the
``names_to_pair`` key convention (one definition, in
``io/feature_store.py``, re-exported here).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from sfd2_torch.io.feature_store import names_to_pair  # noqa: F401  (the hloc key, re-exported)

# Fixed intrinsics of the two ECMU cameras (``it_loc/parsers.py:28-33``).
_ECMU_INTRINSICS = (
    "OPENCV 1024 768 868.993378 866.063001 525.942323 420.042529 "
    "-0.399431 0.188924 0.000153 0.000571"
)

QueryInfo = Tuple[str, int, int, np.ndarray]  # (model, width, height, params)


def parse_image_lists_with_intrinsics(path) -> List[Tuple[str, QueryInfo]]:
    path = Path(path)
    files = sorted(Path(path.parent).glob(path.name))
    if not files:
        raise FileNotFoundError(f"no query list matches {path}")
    results: List[Tuple[str, QueryInfo]] = []
    for lfile in files:
        for line in Path(lfile).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            elems = line.split(" ")
            name, model, width, height = elems[:4]
            params = np.array(elems[4:], dtype=np.float64)
            results.append((name, (model, int(width), int(height), params)))
    return results


def parse_img_lists_for_extended_cmu_seasons(path) -> List[Tuple[str, QueryInfo]]:
    path = Path(path)
    files = sorted(Path(path.parent).glob(path.name))
    if not files:
        raise FileNotFoundError(f"no ECMU query list matches {path}")
    results: List[Tuple[str, QueryInfo]] = []
    k = _ECMU_INTRINSICS.split(" ")
    info = (k[0], int(k[1]), int(k[2]), np.array(k[3:], dtype=np.float64))
    for lfile in files:
        for name in Path(lfile).read_text().splitlines():
            name = name.strip()
            if name:
                results.append((name, info))
    return results


def parse_retrieval(path) -> Dict[str, List[str]]:
    """query → ordered list of retrieved DB names."""
    retrieval: Dict[str, List[str]] = defaultdict(list)
    for line in Path(path).read_text().rstrip("\n").split("\n"):
        if not line.strip():
            continue
        q, r = line.split(" ")[:2]
        retrieval[q].append(r)
    return dict(retrieval)


def write_pairs(path, pairs: List[Tuple[str, str]]) -> None:
    Path(path).write_text("\n".join(f"{a} {b}" for a, b in pairs) + "\n")


def read_pairs(path) -> List[Tuple[str, str]]:
    """The (name0, name1) pairs of a pair file, one ``name0 name1`` per line."""
    return [tuple(line.split(" ")[:2]) for line in Path(path).read_text().splitlines()
            if line.strip()]
