"""Synthetic corridor scene builder for benchmarks and statistical tests.

Port of ``sfd2_tpu/utils/synth.py``: a COLMAP-style map (cameras, images,
points3d) and a feature store whose geometry mimics a street-level
localization slice — a corridor of 3D points with stable random
descriptors, DB cameras sweeping along x, and held-out queries with
ground-truth poses. Given the same arguments it draws the same numbers as
the JAX package's builder. The features go into a caller-owned
``FeatureStore``, which may be the in-memory dict store.

``two_view_pairs`` (no JAX counterpart) draws padded match batches of
two-view geometry with planted outliers, for F-RANSAC's kernel tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from sfd2_torch.geometry.cameras import Camera, canonicalize_params
from sfd2_torch.io.colmap_model import Image, Point3D
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.localization.engine import _np_project
from sfd2_torch.sfm.map_index import MapIndex


@dataclasses.dataclass
class SynthScene:
    map_index: MapIndex
    cam_model: str
    width: int
    height: int
    cam_params: List[float]
    # (query_name, gt_qvec, gt_tvec, retrieved_db_image_ids)
    queries: List[Tuple[str, np.ndarray, np.ndarray, List[int]]]

    @property
    def qinfo(self):
        return (self.cam_model, self.width, self.height, np.asarray(self.cam_params))


def build_corridor_scene(
    store: FeatureStore,
    n_images: int = 100,
    n_queries: int = 20,
    n_points: int = 3000,
    desc_dim: int = 64,
    kp_per_image: int = 800,
    kp_per_query: int = 600,
    retrieval_k: int = 10,
    noise_px: float = 0.3,
    desc_noise: float = 0.05,
    outlier_frac: float = 0.0,
    seed: int = 99,
    width: int = 640,
    height: int = 480,
) -> SynthScene:
    """Corridor map + queries written into `store`; `outlier_frac` replaces
    that fraction of each query's descriptors with fresh random vectors."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    cam_params = [520.0, 520.0, width / 2.0, height / 2.0]
    cam8 = canonicalize_params("PINHOLE", cam_params)
    span = max(4.0, n_images * 0.4)

    pts = np.stack([
        rng.uniform(-2, span + 2, n_points),
        rng.uniform(-3, 3, n_points),
        rng.uniform(8, 15, n_points),
    ], 1)
    pdesc = rng.normal(size=(n_points, desc_dim)).astype(np.float32)
    pdesc /= np.linalg.norm(pdesc, axis=1, keepdims=True)

    cameras = {1: Camera(1, "PINHOLE", width, height, np.array(cam_params))}
    images = {}
    obs = {i: [] for i in range(n_points)}
    queries = []

    def in_frame(xy, depth):
        return ((depth > 0) & (xy[:, 0] > 8) & (xy[:, 0] < width - 8)
                & (xy[:, 1] > 8) & (xy[:, 1] < height - 8))

    for i in range(n_images):
        iid = i + 1
        r = Rotation.from_rotvec(rng.normal(size=3) * 0.03)
        q = r.as_quat()[[3, 0, 1, 2]]
        t = -r.as_matrix() @ np.array([i * span / max(n_images - 1, 1), 0, 0])
        xy, depth = _np_project(pts, q, t, cam8)
        idx = np.nonzero(in_frame(xy, depth))[0][:kp_per_image]
        kp = xy[idx] + rng.normal(size=(len(idx), 2)) * noise_px
        de = pdesc[idx] + rng.normal(size=(len(idx), desc_dim)).astype(np.float32) * desc_noise
        de /= np.linalg.norm(de, axis=1, keepdims=True)
        name = f"db/{iid:05d}.jpg"
        images[iid] = Image(iid, q, t, 1, name, kp, idx.astype(np.int64))
        store.write(name, ImageFeatures(kp.astype(np.float32), de,
                                        rng.random(len(idx)).astype(np.float32), None))
        for row, p in enumerate(idx):
            obs[int(p)].append((iid, row))

    points3d = {}
    for p, o in obs.items():
        if len(o) >= 2:
            points3d[p] = Point3D(p, pts[p], np.zeros(3, np.uint8), 0.4,
                                  np.array([x[0] for x in o], np.int32),
                                  np.array([x[1] for x in o], np.int32))
    for iid in list(images):
        im = images[iid]
        p3d = np.array([p if p in points3d else -1 for p in im.point3D_ids], np.int64)
        images[iid] = Image(iid, im.qvec, im.tvec, 1, im.name, im.xys, p3d)

    for qi in range(n_queries):
        cx = rng.uniform(0.05 * span, 0.95 * span)
        r = Rotation.from_rotvec(rng.normal(size=3) * 0.02)
        q = r.as_quat()[[3, 0, 1, 2]]
        t = -r.as_matrix() @ np.array([cx, 0.1, -0.1])
        xy, depth = _np_project(pts, q, t, cam8)
        idx = np.nonzero(in_frame(xy, depth))[0][:kp_per_query]
        kp = xy[idx] + rng.normal(size=(len(idx), 2)) * noise_px
        de = pdesc[idx] + rng.normal(size=(len(idx), desc_dim)).astype(np.float32) * desc_noise
        if outlier_frac > 0 and len(idx):
            n_out = int(len(idx) * outlier_frac)
            bad = rng.choice(len(idx), n_out, replace=False)
            de[bad] = rng.normal(size=(n_out, desc_dim)).astype(np.float32)
        de /= np.linalg.norm(de, axis=1, keepdims=True)
        qname = f"q/{qi:03d}.jpg"
        store.write(qname, ImageFeatures(kp.astype(np.float32), de,
                                         rng.random(len(idx)).astype(np.float32), None))
        step = span / max(n_images - 1, 1)
        near = sorted(images, key=lambda iid: abs((iid - 1) * step - cx))
        queries.append((qname, q, t, near[:retrieval_k]))

    return SynthScene(map_index=MapIndex(cameras, images, points3d), cam_model="PINHOLE",
                      width=width, height=height, cam_params=cam_params, queries=queries)


def _two_view_camera(rng):
    """A second camera turned by 2–15° about a random axis and moved by
    about a metre, mostly sideways."""
    w = rng.normal(size=3)
    w *= math.radians(rng.uniform(2, 15)) / np.linalg.norm(w)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + math.sin(th) * k + (1 - math.cos(th)) * k @ k, rng.normal(size=3) * [1, .3, .3]


def two_view_pairs(rng: np.random.Generator, b: int, n: int, outliers=(0.05, 0.3), n_valid=None,
                   mask: float | None = None, all_out: int = 0):
    """b seeded pairs of n padded matches for two-view verification, between
    two 1024×768 views (f = 800, depths 3–20 m, 0.5 px noise): xy1, xy2
    [b, n, 2] float32, a share of each pair's matches drawn from `outliers`
    (all of them in the last `all_out` pairs) moved to random pixels; valid
    [b, n] bool, the first `n_valid` (all by default) or each position with
    probability `mask`; truth [b, n] bool, the matches left in place."""
    xy1 = np.zeros((b, n, 2), np.float32)
    xy2 = np.zeros((b, n, 2), np.float32)
    truth = np.zeros((b, n), bool)
    for i in range(b):
        z = rng.uniform(3, 20, n)
        u = rng.uniform((0, 0), (1024, 768), (n, 2))
        pts = np.concatenate([(u - [512, 384]) / 800.0 * z[:, None], z[:, None]], 1)
        rot, t = _two_view_camera(rng)
        q = pts @ rot.T + t
        p2 = 800.0 * q[:, :2] / q[:, 2:] + [512, 384] + rng.normal(0, 0.5, u.shape)
        bad = rng.random(n) < (1.0 if i >= b - all_out else rng.uniform(*outliers))
        p2[bad] = rng.uniform((0, 0), (1024, 768), (int(bad.sum()), 2))
        xy1[i], xy2[i], truth[i] = u + rng.normal(0, 0.5, u.shape), p2, ~bad
    if mask is not None:
        valid = rng.random((b, n)) < mask
    else:
        counts = np.full(b, n) if n_valid is None else np.broadcast_to(n_valid, (b,))
        valid = np.arange(n)[None] < counts[:, None]
    return xy1, xy2, valid, truth
