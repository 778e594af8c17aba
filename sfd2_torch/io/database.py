"""COLMAP-compatible SQLite database (artifact-store interop).

Port of ``sfd2_tpu/io/database.py`` (standard library ``sqlite3`` and
numpy only). Capability parity: ``hloc/utils/database.py`` — the COLMAP ``database.db``
schema (cameras / images / keypoints / descriptors / matches /
two_view_geometries), numpy blob codecs, and the pair-id packing
``pair_id = image_id1 * 2147483647 + image_id2`` with id1 ≤ id2
normalisation (``:113-122``). Lets this framework's maps be consumed by
external COLMAP tooling and vice versa; the native pipeline itself
exchanges arrays in memory / HDF5 and only exports here on demand.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sfd2_torch.geometry.cameras import CAMERA_MODEL_NAMES

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - image_id2) // MAX_IMAGE_ID, image_id2


def _blob(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def _unblob(blob, dtype, shape) -> np.ndarray:
    if blob is None:
        return np.zeros(shape, dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(shape).copy()


class ColmapDatabase:
    def __init__(self, path):
        self.conn = sqlite3.connect(str(path))
        self.conn.executescript(_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def add_camera(
        self, model_id: int, width: int, height: int, params,
        prior_focal_length: bool = False, camera_id: Optional[int] = None,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id, model_id, width, height,
                _blob(np.asarray(params, np.float64)), int(prior_focal_length),
            ),
        )
        return cur.lastrowid

    def add_image(
        self, name: str, camera_id: int,
        prior_q=(None,) * 4, prior_t=(None,) * 3, image_id: Optional[int] = None,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        kp = np.asarray(keypoints, np.float32)
        if kp.ndim != 2 or kp.shape[1] not in (2, 4, 6):
            raise ValueError(f"keypoints must be [N, 2|4|6], got {kp.shape}")
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], _blob(kp)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        de = np.ascontiguousarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, de.shape[0], de.shape[1], _blob(de)),
        )

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        m = np.asarray(matches, np.uint32)
        if m.ndim != 2 or m.shape[1] != 2:
            raise ValueError(f"matches must be [M, 2], got {m.shape}")
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2), m.shape[0], 2, _blob(m)),
        )

    def add_two_view_geometry(
        self, image_id1: int, image_id2: int, matches: np.ndarray,
        F=np.eye(3), E=np.eye(3), H=np.eye(3), config: int = 2,
    ):
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                image_ids_to_pair_id(image_id1, image_id2), m.shape[0], 2,
                _blob(m), config,
                _blob(np.asarray(F, np.float64)),
                _blob(np.asarray(E, np.float64)),
                _blob(np.asarray(H, np.float64)),
                _blob(np.zeros(4)), _blob(np.zeros(3)),
            ),
        )

    # ------------------------------------------------------------------
    def get_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (image_id,)
        ).fetchone()
        return _unblob(row[2], np.float32, (row[0], row[1]))

    def get_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pid = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?", (pid,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        m = _unblob(row[2], np.uint32, (row[0], row[1]))
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def get_two_view_geometry(self, image_id1: int, image_id2: int):
        pid = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data, config, F FROM two_view_geometries WHERE pair_id=?",
            (pid,),
        ).fetchone()
        if row is None:
            return None
        m = _unblob(row[2], np.uint32, (row[0], row[1]))
        if image_id1 > image_id2:
            m = m[:, ::-1]
        f = _unblob(row[4], np.float64, (3, 3))
        return m, int(row[3]), f


def export_to_database(cameras, images, features, db_path, verified=None):
    """Export a model's cameras/images/keypoints (+ optional verified
    matches) into a COLMAP database (``create_db_from_model`` +
    ``import_features``/``import_matches`` parity,
    ``hloc/triangulation.py:33-112``)."""
    with ColmapDatabase(db_path) as db:
        for cam in cameras.values():
            model_id, _ = CAMERA_MODEL_NAMES[cam.model]
            db.add_camera(
                model_id, cam.width, cam.height, cam.params,
                prior_focal_length=True, camera_id=cam.camera_id,
            )
        for iid, im in images.items():
            db.add_image(
                im.name, im.camera_id,
                prior_q=tuple(float(v) for v in im.qvec),
                prior_t=tuple(float(v) for v in im.tvec),
                image_id=iid,
            )
            kp = features.read(im.name).keypoints + 0.5  # COLMAP origin
            db.add_keypoints(iid, kp)
        if verified:
            name_to_id = {im.name: iid for iid, im in images.items()}
            for n0, n1, pairs in verified:
                db.add_matches(name_to_id[n0], name_to_id[n1], pairs)
                db.add_two_view_geometry(name_to_id[n0], name_to_id[n1], pairs)
