"""COLMAP sparse-model reader/writer (binary + text), host-side numpy.

Port of ``sfd2_tpu/io/colmap_model.py`` (capability parity with
``hloc/utils/read_write_model.py``). The on-disk formats are COLMAP's:

  cameras.bin / cameras.txt    camera_id, model, width, height, params[]
  images.bin  / images.txt     image_id, qvec(wxyz), tvec, camera_id, name,
                               and the 2D point list with 3D-point ids
  points3D.bin/ points3D.txt   point3D_id, xyz, rgb, error, track

Large arrays are read in bulk with ``np.frombuffer``. The module is plain
numpy, so its code is the JAX package's with the port's ``Camera``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Dict

import numpy as np

from sfd2_torch.geometry.cameras import CAMERA_MODEL_IDS, CAMERA_MODEL_NAMES, Camera


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


# ---------------------------------------------------------------------------
# Binary codecs
# ---------------------------------------------------------------------------


def _read_cameras_bin(path: Path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name, num_params = CAMERA_MODEL_IDS[model_id]
            params = np.frombuffer(f.read(8 * num_params), dtype="<f8").copy()
            cameras[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cameras


def _write_cameras_bin(cameras: Dict[int, Camera], path: Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, num_params = CAMERA_MODEL_NAMES[cam.model]
            params = np.asarray(cam.params, dtype="<f8")
            if params.size != num_params:
                raise ValueError(f"camera {cam.camera_id}: {cam.model} takes {num_params} "
                                 f"parameters, got {params.size}")
            f.write(struct.pack("<iiQQ", cam.camera_id, model_id, cam.width, cam.height))
            f.write(params.tobytes())


def _read_next_string(f) -> str:
    chars = []
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            break
        chars.append(c)
    return b"".join(chars).decode("utf-8")


def _read_images_bin(path: Path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            image_id = struct.unpack("<i", f.read(4))[0]
            qt = np.frombuffer(f.read(56), dtype="<f8")
            camera_id = struct.unpack("<i", f.read(4))[0]
            name = _read_next_string(f)
            (n_pts,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(f.read(24 * n_pts), dtype="<u1").reshape(n_pts, 24)
            xys = raw[:, :16].copy().view("<f8").reshape(n_pts, 2)
            p3d = raw[:, 16:].copy().view("<i8").reshape(n_pts)
            images[image_id] = Image(image_id, qt[:4].copy(), qt[4:].copy(), camera_id,
                                     name, xys, p3d)
    return images


def _write_images_bin(images: Dict[int, Image], path: Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            if n:
                rec = np.empty((n, 24), dtype="<u1")
                rec[:, :16] = np.ascontiguousarray(im.xys, "<f8").view("<u1").reshape(n, 16)
                rec[:, 16:] = np.ascontiguousarray(im.point3D_ids, "<i8").view("<u1").reshape(n, 8)
                f.write(rec.tobytes())


def _read_points3d_bin(path: Path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.frombuffer(f.read(24), dtype="<f8").copy()
            rgb = np.frombuffer(f.read(3), dtype="<u1").copy()
            (error,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            track = np.frombuffer(f.read(8 * track_len), dtype="<i4").reshape(track_len, 2)
            points[pid] = Point3D(pid, xyz, rgb, error, track[:, 0].copy(), track[:, 1].copy())
    return points


def _write_points3d_bin(points: Dict[int, Point3D], path: Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<Q", pt.id))
            f.write(np.asarray(pt.xyz, "<f8").tobytes())
            f.write(np.asarray(pt.rgb, "<u1").tobytes())
            f.write(struct.pack("<d", float(pt.error)))
            t = len(pt.image_ids)
            f.write(struct.pack("<Q", t))
            track = np.empty((t, 2), dtype="<i4")
            track[:, 0] = pt.image_ids
            track[:, 1] = pt.point2D_idxs
            f.write(track.tobytes())


# ---------------------------------------------------------------------------
# Text codecs
# ---------------------------------------------------------------------------


def _data_lines(path: Path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]


def _read_cameras_txt(path: Path) -> Dict[int, Camera]:
    cameras = {}
    for line in _data_lines(path):
        elems = line.split()
        cam_id = int(elems[0])
        cameras[cam_id] = Camera(cam_id, elems[1], int(elems[2]), int(elems[3]),
                                 np.array(elems[4:], dtype=np.float64))
    return cameras


def _write_cameras_txt(cameras: Dict[int, Camera], path: Path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n")


def _read_images_txt(path: Path) -> Dict[int, Image]:
    images = {}
    lines = _data_lines(path)
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(pts, dtype=np.float64).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[image_id] = Image(image_id, np.array(elems[1:5], dtype=np.float64),
                                 np.array(elems[5:8], dtype=np.float64), int(elems[8]),
                                 elems[9], arr[:, :2].copy(), arr[:, 2].astype(np.int64))
    return images


def _write_images_txt(images: Dict[int, Image], path: Path) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(images)}\n")
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in [*im.qvec, *im.tvec])
            f.write(f"{im.image_id} {pose} {im.camera_id} {im.name}\n")
            f.write(" ".join(f"{x} {y} {int(pid)}"
                             for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")


def _read_points3d_txt(path: Path) -> Dict[int, Point3D]:
    points = {}
    for line in _data_lines(path):
        elems = line.split()
        pid = int(elems[0])
        track = np.array(elems[8:], dtype=np.int32).reshape(-1, 2)
        points[pid] = Point3D(pid, np.array(elems[1:4], dtype=np.float64),
                              np.array(elems[4:7], dtype=np.uint8), float(elems[7]),
                              track[:, 0].copy(), track[:, 1].copy())
    return points


def _write_points3d_txt(points: Dict[int, Point3D], path: Path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {len(points)}\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def detect_model_format(path: os.PathLike) -> str:
    path = Path(path)
    if (path / "cameras.bin").exists():
        return ".bin"
    if (path / "cameras.txt").exists():
        return ".txt"
    raise FileNotFoundError(f"no COLMAP model found at {path}")


_CODECS = {
    ".bin": (_read_cameras_bin, _read_images_bin, _read_points3d_bin,
             _write_cameras_bin, _write_images_bin, _write_points3d_bin),
    ".txt": (_read_cameras_txt, _read_images_txt, _read_points3d_txt,
             _write_cameras_txt, _write_images_txt, _write_points3d_txt),
}


def _codec(ext: str):
    if ext not in _CODECS:
        raise ValueError(f"unknown model format {ext!r}")
    return _CODECS[ext]


def read_model(path: os.PathLike, ext: str | None = None):
    """Read (cameras, images, points3D) dicts from a COLMAP model dir."""
    path = Path(path)
    ext = ext or detect_model_format(path)
    read_cams, read_imgs, read_pts = _codec(ext)[:3]
    return (read_cams(path / f"cameras{ext}"), read_imgs(path / f"images{ext}"),
            read_pts(path / f"points3D{ext}"))


def write_model(cameras, images, points3d, path: os.PathLike, ext: str = ".bin"):
    path = Path(path)
    write_cams, write_imgs, write_pts = _codec(ext)[3:]
    path.mkdir(parents=True, exist_ok=True)
    write_cams(cameras, path / f"cameras{ext}")
    write_imgs(images, path / f"images{ext}")
    write_pts(points3d, path / f"points3D{ext}")
