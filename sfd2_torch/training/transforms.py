"""Homography-composing augmentation (host-side numpy).

Port of ``sfd2_tpu/training/transforms.py`` (``tools/transforms.py`` +
``tools/transforms_tools.py``): typed dataclass transforms that compose
3×3 homographies (RandomScale, RandomRotation, RandomTilt's 4-direction
perspective skew via an 8-parameter solve, RandomTranslation), the
homography algebra ``persp_apply``, and the photometric ColorJitter and
PixelNoise. A copy in host numpy: every draw from the ``Generator`` comes
in the JAX package's order, so the same seed gives the same homography,
jitter and noise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def persp_apply(h: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Apply homography [3,3] to points [..., 2]."""
    ones = np.ones((*xy.shape[:-1], 1), xy.dtype)
    p = np.concatenate([xy, ones], axis=-1) @ h.T
    return p[..., :2] / np.maximum(np.abs(p[..., 2:3]), 1e-12) * np.sign(p[..., 2:3])


def homography_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 4-point homography (8-param DLT solve,
    ``tools/transforms.py:327-343`` semantics)."""
    a = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    h8 = np.linalg.solve(np.array(a, np.float64), np.array(b, np.float64))
    return np.concatenate([h8, [1.0]]).reshape(3, 3)


@dataclasses.dataclass(frozen=True)
class RandomScale:
    min_scale: float = 0.7
    max_scale: float = 1.3

    def sample(self, rng: np.random.Generator, w: int, h: int) -> np.ndarray:
        s = rng.uniform(self.min_scale, self.max_scale)
        return np.diag([s, s, 1.0])


@dataclasses.dataclass(frozen=True)
class RandomRotation:
    max_deg: float = 15.0

    def sample(self, rng, w, h):
        a = np.radians(rng.uniform(-self.max_deg, self.max_deg))
        c, s = np.cos(a), np.sin(a)
        cx, cy = w / 2, h / 2
        t1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
        t2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
        return t2 @ r @ t1


@dataclasses.dataclass(frozen=True)
class RandomTilt:
    """4-direction perspective skew (``tools/transforms.py:255``)."""

    magnitude: float = 0.25

    def sample(self, rng, w, h):
        m = rng.uniform(0, self.magnitude)
        corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
        direction = rng.integers(0, 4)
        shift = m * (w if direction in (0, 1) else h)
        dst = corners.copy()
        if direction == 0:  # tilt left edge
            dst[0, 1] += shift * rng.uniform(0, 1)
            dst[3, 1] -= shift * rng.uniform(0, 1)
        elif direction == 1:  # right edge
            dst[1, 1] += shift * rng.uniform(0, 1)
            dst[2, 1] -= shift * rng.uniform(0, 1)
        elif direction == 2:  # top edge
            dst[0, 0] += shift * rng.uniform(0, 1)
            dst[1, 0] -= shift * rng.uniform(0, 1)
        else:  # bottom edge
            dst[3, 0] += shift * rng.uniform(0, 1)
            dst[2, 0] -= shift * rng.uniform(0, 1)
        return homography_from_points(corners, dst)


@dataclasses.dataclass(frozen=True)
class RandomTranslation:
    max_frac: float = 0.1

    def sample(self, rng, w, h):
        tx = rng.uniform(-self.max_frac, self.max_frac) * w
        ty = rng.uniform(-self.max_frac, self.max_frac) * h
        return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)


DEFAULT_PAIR_TRANSFORMS: Tuple = (
    RandomScale(),
    RandomRotation(),
    RandomTilt(),
    RandomTranslation(),
)


def sample_homography(
    rng: np.random.Generator,
    w: int,
    h: int,
    transforms: Sequence = DEFAULT_PAIR_TRANSFORMS,
) -> np.ndarray:
    hmat = np.eye(3)
    for t in transforms:
        hmat = t.sample(rng, w, h) @ hmat
    return hmat


def pixel_noise(rng, img: np.ndarray, ampl: float = 0.06) -> np.ndarray:
    """Additive uniform pixel noise (``PixelNoise``, images in [0,1])."""
    noise = rng.uniform(-ampl, ampl, size=img.shape).astype(img.dtype)
    return np.clip(img + noise, 0.0, 1.0)


def color_jitter(rng, img: np.ndarray, brightness=0.3, contrast=0.3, saturation=0.3):
    """Brightness/contrast/saturation jitter (``ColorJitter``)."""
    out = img
    b = 1 + rng.uniform(-brightness, brightness)
    out = out * b
    c = 1 + rng.uniform(-contrast, contrast)
    mean = out.mean()
    out = (out - mean) * c + mean
    s = 1 + rng.uniform(-saturation, saturation)
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * s
    return np.clip(out, 0.0, 1.0).astype(img.dtype)
