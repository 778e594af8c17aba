"""Training data pipeline: image folders → homography pair batches.

Port of ``sfd2_tpu/training/data.py``:
* ``SyntheticPairBuilder`` (``datasets/pair_dataset.py:121``: a random
  homography + jitter + noise pair with analytic absolute flow),
* ``ImageFolderDataset`` / ``CatDataset`` (``datasets/imgfolder.py``,
  ``datasets/dataset.py``), and ``ArrayDataset`` over images in memory,
* ``crop_pair`` and ``PairLoader`` (``tools/dataloader.py:22,148-188``: the
  crop-window search scored by flow validity, ImageNet-normalised pair +
  grayscale copies + aflow with NaN invalids + mask; a thread pool builds
  the next batch while the caller works on this one),
* ``PrecomputedPairBuilder`` / ``TransformedPairBuilder`` for datasets
  with ``get_pair``.

No OpenCV on the pair path: the warp and the upscale are
``warp_perspective`` / ``resize_linear`` (``torch.nn.functional`` on CPU
tensors), which draw nothing from the ``Generator``, so the homography,
jitter, noise, crop windows, flow and mask come out exactly as the JAX
package's for the same seed; the warped pixels differ from
``cv2.warpPerspective``'s only by cv2's 1/32-px rounding of the sample
position. ``ImageFolderDataset`` reads files through ``utils/image_io.py``
(OpenCV or PIL).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfd2_torch.training.transforms import (
    DEFAULT_PAIR_TRANSFORMS,
    color_jitter,
    persp_apply,
    pixel_noise,
    sample_homography,
)
from sfd2_torch.utils.image_io import read_rgb

_RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _chw(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]


def _hwc(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x[0].permute(1, 2, 0).numpy())


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR, `size` = (w, h)) on the
    CPU: bilinear at half-pixel centres, the source clamped at the edges."""
    w, h = size
    return _hwc(F.interpolate(_chw(img), size=(h, w), mode="bilinear", align_corners=False))


def warp_perspective(img: np.ndarray, hmat: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(img, hmat, size)`` on the CPU: output pixel
    (x, y) samples `img` bilinearly at hmat⁻¹·(x, y, 1), pixel centres at
    integer coordinates, taps outside the image 0. cv2 rounds the sample
    position to 1/32 px; this samples at the exact position."""
    w, h = size
    hs, ws = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(np.asarray(hmat, np.float64)).T
    with np.errstate(divide="ignore", invalid="ignore"):
        sx, sy = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    grid = np.stack([sx * (2.0 / (ws - 1)) - 1.0, sy * (2.0 / (hs - 1)) - 1.0], -1)
    grid = np.clip(np.nan_to_num(grid, nan=-9.0), -9.0, 9.0)  # far outside: taps 0
    out = F.grid_sample(_chw(img), torch.from_numpy(grid.astype(np.float32))[None],
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return _hwc(out).astype(img.dtype)


class ImageFolderDataset:
    """All images under a root directory (``datasets/imgfolder.py:11``)."""

    def __init__(self, root):
        self.root = Path(root)
        self.paths = sorted(
            p for p in self.root.rglob("*") if p.suffix.lower() in IMAGE_EXTS
        )
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def get_image(self, i: int) -> np.ndarray:
        return read_rgb(self.paths[i])


class ArrayDataset:
    """Images held in memory (a list of [H, W, 3] float RGB arrays in
    [0, 1]), with ``ImageFolderDataset``'s ``get_image``: a fixture for
    runs that read no files."""

    def __init__(self, images: Sequence[np.ndarray]):
        self.images = list(images)

    def __len__(self):
        return len(self.images)

    def get_image(self, i: int) -> np.ndarray:
        return self.images[i]


class CatDataset:
    """Concatenation with offset search (``datasets/dataset.py``)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def get_image(self, i: int) -> np.ndarray:
        d = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[d].get_image(i - int(self.offsets[d]))


@dataclasses.dataclass
class PairSample:
    img1: np.ndarray  # [R, R, 3] ImageNet-normalised
    img2: np.ndarray
    gray1: np.ndarray  # [R, R, 1] in [0, 1]
    gray2: np.ndarray
    raw1: np.ndarray  # [R, R, 3] in [0, 1] (for offline seg teachers)
    aflow: np.ndarray  # [R, R, 2] absolute flow img1→img2, NaN invalid
    mask: np.ndarray  # [R, R] bool
    seg1: Optional[np.ndarray] = None  # [R, R] int32 labels of img1, when the dataset has them


def _to_gray(img: np.ndarray) -> np.ndarray:
    g = img @ np.array([0.299, 0.587, 0.114], np.float32)
    return g[..., None]


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img - _RGB_MEAN) / _RGB_STD


def crop_pair(
    rng: np.random.Generator,
    img1_full: np.ndarray,
    img2_full: np.ndarray,
    aflow_full: np.ndarray,
    valid_full: np.ndarray,
    crop: int,
    n_tries: int = 5,
    labels_full: Optional[np.ndarray] = None,
) -> PairSample:
    """Shared crop-window search (``tools/dataloader.py:148-188``): pick
    the best valid-flow-coverage RxR window in img1, crop img2 around the
    flow target's median, re-mask, normalise. `labels_full`, img1's label
    map, is cropped to img1's window (``seg1``)."""
    r = crop
    h, w = img1_full.shape[:2]
    h2, w2 = img2_full.shape[:2]
    assert aflow_full.shape[:2] == (h, w), (aflow_full.shape, img1_full.shape)
    assert valid_full.shape == (h, w), valid_full.shape

    best = None
    for _ in range(n_tries):
        x0 = int(rng.integers(0, max(w - r, 1)))
        y0 = int(rng.integers(0, max(h - r, 1)))
        cov = valid_full[y0 : y0 + r, x0 : x0 + r].mean()
        if best is None or cov > best[0]:
            best = (cov, x0, y0)
    _, x0, y0 = best
    img1 = img1_full[y0 : y0 + r, x0 : x0 + r]
    flow = aflow_full[y0 : y0 + r, x0 : x0 + r].copy()

    med = np.nanmedian(
        np.where(valid_full[y0 : y0 + r, x0 : x0 + r, None], flow, np.nan),
        axis=(0, 1),
    )
    if not np.all(np.isfinite(med)):
        med = np.array([w2 / 2, h2 / 2])
    x1 = int(np.clip(med[0] - r / 2, 0, max(w2 - r, 0)))
    y1 = int(np.clip(med[1] - r / 2, 0, max(h2 - r, 0)))
    img2 = img2_full[y1 : y1 + r, x1 : x1 + r]
    flow[..., 0] -= x1
    flow[..., 1] -= y1
    mask = (
        (flow[..., 0] >= 0) & (flow[..., 0] < img2.shape[1])
        & (flow[..., 1] >= 0) & (flow[..., 1] < img2.shape[0])
    )
    flow[~mask] = np.nan

    return PairSample(
        img1=_normalize(img1),
        img2=_normalize(img2),
        gray1=_to_gray(img1),
        gray2=_to_gray(img2),
        raw1=img1,
        aflow=flow.astype(np.float32),
        mask=mask,
        seg1=None if labels_full is None
        else np.asarray(labels_full[y0: y0 + r, x0: x0 + r], np.int32),
    )


@dataclasses.dataclass
class SyntheticPairBuilder:
    """Single image → warped training pair with analytic flow.

    Crop-window search mirrors ``tools/dataloader.py:148-188``: several
    random candidate windows are scored by valid-flow coverage and the
    best is kept.
    """

    crop: int = 512
    n_crop_tries: int = 5
    noise: float = 0.05
    jitter: bool = True
    transforms: tuple = DEFAULT_PAIR_TRANSFORMS

    def make_full_pair(self, rng: np.random.Generator, img: np.ndarray):
        """Warp + photometric jitter WITHOUT the crop: returns
        (img1, img2_full, flow_full, valid_full) — the pre-crop half of
        `build`, reusable by get_pair-style adapters."""
        r = self.crop
        h, w = img.shape[:2]
        if h < r or w < r:
            scale = r / min(h, w) * 1.05
            img = resize_linear(img, (int(w * scale) + 1, int(h * scale) + 1))
            h, w = img.shape[:2]

        hmat = sample_homography(rng, w, h, self.transforms)
        img2_full = warp_perspective(img, hmat, (w, h))

        # Dense flow on the full image.
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        grid = np.stack([xs, ys], axis=-1)
        flow_full = persp_apply(hmat, grid.reshape(-1, 2)).reshape(h, w, 2)
        valid_full = (
            (flow_full[..., 0] >= 0)
            & (flow_full[..., 0] < w)
            & (flow_full[..., 1] >= 0)
            & (flow_full[..., 1] < h)
        )

        if self.jitter:
            img2_full = color_jitter(rng, img2_full)
        if self.noise:
            img2_full = pixel_noise(rng, img2_full, self.noise)
        return img, img2_full, flow_full, valid_full

    def build(self, rng: np.random.Generator, img: np.ndarray) -> PairSample:
        img, img2_full, flow_full, valid_full = self.make_full_pair(rng, img)
        return crop_pair(
            rng, img, img2_full, flow_full, valid_full, self.crop,
            self.n_crop_tries,
        )


@dataclasses.dataclass
class PrecomputedPairBuilder:
    """Builder over datasets exposing ``get_pair(idx)`` → (img1, img2,
    aflow, mask) — the still / optical-flow pair datasets
    (``training/flow_pairs.py`` of the JAX package). Applies the same crop-window
    search; the dataset index doubles as the 'image' index."""

    crop: int = 512
    n_crop_tries: int = 5

    def build_from_pair(self, rng, img1, img2, aflow, mask, labels=None) -> PairSample:
        """`labels`: img1's label map from a dataset that has one
        (``seg_teacher.py::LabelDirPairs``), cropped as img1 is."""
        valid = np.asarray(mask, bool) & np.isfinite(aflow).all(-1)
        return crop_pair(
            rng, img1, img2, np.where(valid[..., None], aflow, np.nan),
            valid, self.crop, self.n_crop_tries, labels,
        )


@dataclasses.dataclass
class TransformedPairBuilder(PrecomputedPairBuilder):
    """Jitter an EXISTING pair: img2 is re-warped by a fresh random
    homography (the ground-truth flow composed through it) plus
    photometric jitter/noise — ``TransformedPairs``
    (``datasets/pair_dataset.py:182-229``): the reference applies `trf`
    to img_b and maps ``aflow`` through ``persp_apply(trf, ·)``.

    Because PairLoader threads any `PrecomputedPairBuilder` subclass
    straight through, dropping this in augments still/optical-flow pair
    datasets without new loader plumbing."""

    noise: float = 0.05
    jitter: bool = True
    transforms: tuple = ()

    def __post_init__(self):
        if not self.transforms:
            self.transforms = DEFAULT_PAIR_TRANSFORMS

    def build_from_pair(self, rng, img1, img2, aflow, mask, labels=None) -> PairSample:
        h, w = img2.shape[:2]
        hmat = sample_homography(rng, w, h, self.transforms)
        img2w = warp_perspective(img2, hmat, (w, h))
        if self.jitter:
            img2w = color_jitter(rng, img2w)
        if self.noise:
            img2w = pixel_noise(rng, img2w, self.noise)
        # Compose the ground truth: new flow = H ∘ old flow.
        flow2 = persp_apply(hmat, aflow.reshape(-1, 2)).reshape(aflow.shape)
        flow2 = flow2.astype(np.float32)
        valid = np.asarray(mask, bool) & np.isfinite(aflow).all(-1)
        valid &= (
            (flow2[..., 0] >= 0)
            & (flow2[..., 0] < w)
            & (flow2[..., 1] >= 0)
            & (flow2[..., 1] < h)
        )
        return crop_pair(
            rng, img1, img2w, np.where(valid[..., None], flow2, np.nan),
            valid, self.crop, self.n_crop_tries, labels,
        )


def collate(samples: Sequence[PairSample]) -> dict:
    """Stack samples into batch arrays (``tools/dataloader.py:328``), with
    ``seg1`` when every sample has labels."""
    batch = {
        "image1": np.stack([s.img1 for s in samples]),
        "image2": np.stack([s.img2 for s in samples]),
        "gray1": np.stack([s.gray1 for s in samples]),
        "gray2": np.stack([s.gray2 for s in samples]),
        "raw1": np.stack([s.raw1 for s in samples]),
        "aflow": np.stack([s.aflow for s in samples]),
        "mask": np.stack([s.mask for s in samples]),
    }
    if all(s.seg1 is not None for s in samples):
        batch["seg1"] = np.stack([s.seg1 for s in samples])
    return batch


class PairLoader:
    """Threaded prefetching batch iterator (``threaded_loader`` parity):
    `workers` threads build the samples of batch b+1 while the caller
    works on batch b. Sample i of epoch e draws from its own generator,
    seeded ``seed + e·1_000_003 + i``, so batches do not depend on the
    threads' timing."""

    def __init__(
        self,
        dataset,
        builder: SyntheticPairBuilder,
        batch_size: int = 4,
        seed: int = 0,
        workers: int = 4,
        iters_per_epoch: Optional[int] = None,
    ):
        self.dataset = dataset
        self.builder = builder
        self.batch_size = batch_size
        self.seed = seed
        self.workers = workers
        self.iters_per_epoch = iters_per_epoch

    def epoch(self, epoch: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch * 7919)
        n = len(self.dataset)
        order = rng.permutation(n)
        n_batches = len(order) // self.batch_size
        if self.iters_per_epoch:
            n_batches = min(n_batches, self.iters_per_epoch)

        has_pairs = hasattr(self.dataset, "get_pair")

        def make(idx_seed):
            idx, s = idx_seed
            r = np.random.default_rng(s)
            if has_pairs:
                pb = (
                    self.builder
                    if isinstance(self.builder, PrecomputedPairBuilder)
                    else PrecomputedPairBuilder(
                        crop=self.builder.crop,
                        n_crop_tries=self.builder.n_crop_tries,
                    )
                )
                return pb.build_from_pair(r, *self.dataset.get_pair(int(idx)))
            return self.builder.build(r, self.dataset.get_image(int(idx)))

        with ThreadPoolExecutor(self.workers) as pool:
            def submit(b):
                idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
                return [pool.submit(make, (i, self.seed + epoch * 1_000_003 + int(i)))
                        for i in idxs]

            # Depth-1 prefetch: batch b+1 is queued before batch b is waited
            # for, so it builds while the caller runs step b.
            pending = submit(0) if n_batches else []
            try:
                for b in range(n_batches):
                    current = pending
                    pending = submit(b + 1) if b + 1 < n_batches else []
                    yield collate([f.result() for f in current])
            finally:  # a caller that stops early leaves nothing to build
                for f in pending:
                    f.cancel()
