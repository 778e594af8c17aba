"""The benchmark's synthetic corridor scene, frozen.

A copy of ``sfd2_torch/scripts/bench_scale.py``'s scene generator (points
and poses along a corridor; per camera, the in-frame points ranked by a
random detection score, the top-K kept, keypoint and descriptor noise
added) kept here so that a change to the program cannot move the
yardstick. Differences from the copied generator:

* everything is drawn from the run's ``--seed``: the poses from
  ``numpy.random.default_rng``, the descriptor bases and noise from
  ``torch.Generator``s on the device, one per chunk of cameras;
* the points are sorted along the corridor once, so each chunk projects
  only the points within ``SceneSize.view_x`` metres of its cameras, not
  all of them (the others are out of frame); the generator also returns each
  keypoint's ground-truth point, from which the map is built;
* descriptors are float32, the dtype the ``sfd2-n4096-r1600`` preset
  writes (``ExtractionConfig.as_half`` is off), laid out [C, K] per image
  as the feature store keeps them.

The map-build cell pairs DB images by covisibility (``portbench/covis.py``);
``pairs_from_poses`` (``sfd2_torch/sfm/pairs.py``) is not copied: no cell
pairs by pose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NOISE_PX = 0.4  # keypoint noise, pixels
DESC_NOISE = 0.05  # descriptor noise before renormalising
VIEW_X = 12.0  # metres along the corridor within which a camera can see a point, at least
Z_RANGE = (8.0, 15.0)  # the points' depth band, metres
GEN_B = 50  # cameras per generator chunk


def sub_seed(seed: int, *path: int) -> int:
    """A 62-bit seed derived from the run's seed and a path of indices."""
    return int(np.random.default_rng([int(seed) & (2**64 - 1), *path]).integers(2**62))


@dataclasses.dataclass(frozen=True)
class SceneSize:
    n_db: int
    n_q: int
    kp: int
    c: int
    points_per_image: int  # ground-truth points per DB image of corridor
    width: int
    height: int
    focal: float

    @property
    def span(self) -> float:
        return max(4.0, self.n_db * 0.2)

    @property
    def n_pts(self) -> int:
        return self.points_per_image * self.n_db

    @property
    def view_x(self) -> float:
        """Metres along the corridor beyond which no point is in frame: the
        half-width the camera sees at the far end of the depth band."""
        return max(VIEW_X, Z_RANGE[1] * self.width / 2.0 / self.focal + 1.0)

    @property
    def cam_params(self) -> list:
        return [self.focal, self.focal, self.width / 2.0, self.height / 2.0]


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """[..., 4] (w, x, y, z) → [..., 3, 3]."""
    w, x, y, z = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def make_poses(size: SceneSize, rng: np.random.Generator):
    """(pts [N, 3] sorted by x, db_q, db_t, q_x, q_q, q_t): world→camera
    poses of cameras looking down +z along the corridor, DB cameras evenly
    spaced, queries spread evenly over it."""
    from scipy.spatial.transform import Rotation

    span, n = size.span, size.n_pts
    pts = np.stack([rng.uniform(-2, span + 2, n), rng.uniform(-2.5, 2.5, n),
                    rng.uniform(*Z_RANGE, n)], 1).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]

    def poses(xs, jitter):
        r = Rotation.from_rotvec(rng.normal(size=(len(xs), 3)) * jitter)
        q = r.as_quat()[:, [3, 0, 1, 2]]
        t = -np.einsum("nij,nj->ni", r.as_matrix(), np.stack([xs, 0 * xs, 0 * xs], 1))
        return q, t

    db_x = np.arange(size.n_db) * span / max(size.n_db - 1, 1)
    db_q, db_t = poses(db_x, 0.01)
    # One query in each of n_q equal strata of the corridor's middle 90 %:
    # every seed places its queries alike, and only their order and the
    # jitter inside a stratum change.
    q_x = span * (0.05 + 0.9 * (np.arange(size.n_q) + rng.uniform(0, 1, size.n_q)) / size.n_q)
    q_q, q_t = poses(q_x, 0.008)
    return pts, db_q, db_t, q_x, q_q, q_t


def _project(pts: torch.Tensor, rot: torch.Tensor, t: torch.Tensor, cam: list):
    """Pinhole projection of pts [N, 3] by B poses → (xy [B, N, 2], z [B, N])."""
    pc = torch.einsum("bij,nj->bni", rot, pts) + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([cam[0] * pc[..., 0] / zs + cam[2], cam[1] * pc[..., 1] / zs + cam[3]],
                       -1), z


def gen_features(size: SceneSize, pts: torch.Tensor, pts_x: np.ndarray, base: torch.Tensor,
                 q: np.ndarray, t: np.ndarray, xs: np.ndarray, seed: int, chunk0: int):
    """Features of cameras (q, t) at corridor positions `xs`, GEN_B per
    chunk: yields (lo, desc [B, C, K] float32, kp [B, K, 2], valid [B, K],
    point [B, K] ground-truth point index or −1). Valid rows come first
    (the top-K is sorted by score and an invalid point scores −1)."""
    dev = pts.device
    for lo in range(0, len(q), GEN_B):
        hi = min(lo + GEN_B, len(q))
        gen = torch.Generator(dev).manual_seed(sub_seed(seed, chunk0 + lo))
        a = int(np.searchsorted(pts_x, xs[lo:hi].min() - size.view_x))
        b = int(np.searchsorted(pts_x, xs[lo:hi].max() + size.view_x))
        rot = torch.from_numpy(quat_to_rotmat(q[lo:hi]).astype(np.float32)).to(dev)
        tt = torch.from_numpy(t[lo:hi].astype(np.float32)).to(dev)
        xy, depth = _project(pts[a:b], rot, tt, size.cam_params)
        w, h = size.width, size.height
        inb = ((depth > 0.1) & (xy[..., 0] > 8) & (xy[..., 0] < w - 8)
               & (xy[..., 1] > 8) & (xy[..., 1] < h - 8))
        score = torch.rand(inb.shape, generator=gen, device=dev)
        k = min(size.kp, inb.shape[1])
        ids = torch.topk(torch.where(inb, score, -1.0), k, dim=1).indices
        valid = torch.gather(inb, 1, ids)
        kp = torch.gather(xy, 1, ids[..., None].expand(-1, -1, 2))
        kp = kp + torch.randn(kp.shape, generator=gen, device=dev) * NOISE_PX
        point = ids + a
        de = base[point.reshape(-1)].reshape(*ids.shape, size.c)
        de = de + torch.randn(de.shape, generator=gen, device=dev) * DESC_NOISE
        de = de / torch.clamp(torch.linalg.norm(de, dim=-1, keepdim=True), min=1e-8)
        if k < size.kp:  # fewer points than keypoints in view: pad invalid rows
            pad = size.kp - k
            de = torch.nn.functional.pad(de, (0, 0, 0, pad))
            kp = torch.nn.functional.pad(kp, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
            point = torch.nn.functional.pad(point, (0, pad), value=-1)
        point = torch.where(valid, point, -1)
        yield lo, de.transpose(1, 2).contiguous(), kp, valid, point


@dataclasses.dataclass
class Scene:
    """Ground truth and features of the DB and the query pool, on the host."""

    size: SceneSize
    pts: np.ndarray  # [N, 3] float32, sorted by x
    db_q: np.ndarray
    db_t: np.ndarray
    q_x: np.ndarray
    q_q: np.ndarray
    q_t: np.ndarray
    db_desc: np.ndarray  # [N_DB, C, K] float32
    db_kp: np.ndarray  # [N_DB, K, 2] float32
    db_nv: np.ndarray  # [N_DB] valid keypoints (a prefix)
    db_point: np.ndarray  # [N_DB, K] int64 ground-truth point or −1
    q_desc: np.ndarray  # [N_Q, C, K]
    q_kp: np.ndarray
    q_nv: np.ndarray


def make_scene(size: SceneSize, seed: int, device) -> Scene:
    """The scene of `seed`: poses on the host, features born on `device`
    and fetched into preallocated host arrays, one chunk at a time."""
    dev = torch.device(device)
    rng = np.random.default_rng(sub_seed(seed, 0))
    pts, db_q, db_t, q_x, q_q, q_t = make_poses(size, rng)
    pts_d = torch.from_numpy(pts).to(dev)
    base = torch.randn((len(pts), size.c), generator=torch.Generator(dev).manual_seed(
        sub_seed(seed, 1)), device=dev)
    base = base / torch.linalg.norm(base, dim=1, keepdim=True)
    db_x = np.arange(size.n_db) * size.span / max(size.n_db - 1, 1)

    def fill(q, t, xs, chunk0):
        n = len(q)
        desc = np.empty((n, size.c, size.kp), np.float32)
        kp = np.empty((n, size.kp, 2), np.float32)
        nv = np.empty(n, np.int64)
        point = np.empty((n, size.kp), np.int64)
        for lo, de, k, va, p in gen_features(size, pts_d, pts[:, 0], base, q, t, xs, seed,
                                             chunk0):
            hi = lo + len(de)  # fetched straight into the host arrays
            for dst, src in ((desc, de), (kp, k), (nv, va.sum(1)), (point, p)):
                torch.from_numpy(dst[lo:hi]).copy_(src)
        return desc, kp, nv, point

    db_desc, db_kp, db_nv, db_point = fill(db_q, db_t, db_x, 2)
    q_desc, q_kp, q_nv, _ = fill(q_q, q_t, q_x, 2 + 2**40)
    return Scene(size, pts, db_q, db_t, q_x, q_q, q_t, db_desc, db_kp, db_nv, db_point,
                 q_desc, q_kp, q_nv)


def map_arrays(scene: Scene):
    """The map from the ground-truth observations: points seen by two or
    more DB images, renumbered densely. Returns (prow [N_DB, K] point row
    or −1, point_xyz [P, 3] float64, track_len [P] int32)."""
    obs = scene.db_point
    seen = obs >= 0
    counts = np.bincount(obs[seen], minlength=len(scene.pts))
    kept = counts >= 2
    row = np.cumsum(kept) - 1
    prow = np.where(seen, row[np.maximum(obs, 0)], -1)
    prow = np.where(seen & kept[np.maximum(obs, 0)], prow, -1)
    return prow, scene.pts[kept].astype(np.float64), counts[kept].astype(np.int32)


def retrieval(scene: Scene, topk: int) -> np.ndarray:
    """Each query's `topk` DB rows nearest along the corridor, nearest
    first (the retrieval a perfect global descriptor would give)."""
    db_x = np.arange(scene.size.n_db) * scene.size.span / max(scene.size.n_db - 1, 1)
    return np.argsort(np.abs(db_x[None, :] - scene.q_x[:, None]), axis=1,
                      kind="stable")[:, :topk]
