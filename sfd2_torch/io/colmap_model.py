"""COLMAP model record types (host-side numpy).

The ``Image`` and ``Point3D`` records of ``sfd2_tpu/io/colmap_model.py``;
the binary/text readers and writers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Image:
    image_id: int
    qvec: np.ndarray  # [4] w,x,y,z (world->cam)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2]
    point3D_ids: np.ndarray  # [N] int64, -1 = no 3D point


@dataclasses.dataclass(frozen=True)
class Point3D:
    id: int
    xyz: np.ndarray  # [3]
    rgb: np.ndarray  # [3] uint8
    error: float
    image_ids: np.ndarray  # [T] int32
    point2D_idxs: np.ndarray  # [T] int32
