"""Precomputed-flow pair datasets and the 16-bit flow-PNG codec.

Port of ``sfd2_tpu/training/flow_pairs.py`` (``datasets/pair_dataset.py``'s
``_flow2png`` / ``_png2flow``: flow × 16 rounded into int16, stored as the
4-channel uint8 view of the int16 pairs in a PNG; ``StillPairDataset``, the
pixel-aligned stills of ``AachenPairs_StyleTransferDayNight``; and the
per-pair flow.png + mask.png layout of ``AachenPairs_OpticalFlow``,
``datasets/aachen.py:77-142``). Files go through ``utils/image_io.py``
(OpenCV or PIL).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from sfd2_torch.utils.image_io import read_image, read_rgb, write_png

# The on-disk format is fixed-point: flow values in 1/16-px units stored
# as little-endian int16 pairs reinterpreted as a 4-channel uint8 PNG.
_FLOW_SCALE = 16.0
_I16_MIN, _I16_MAX = np.iinfo(np.int16).min, np.iinfo(np.int16).max


def flow_to_png(flow: np.ndarray, path) -> np.ndarray:
    """Encode [H, W, 2] float flow in the fixed-point PNG format.
    Returns the quantised flow actually stored (1/16-px resolution)."""
    fixed = np.rint(np.asarray(flow) * _FLOW_SCALE)
    fixed = np.clip(fixed, _I16_MIN, _I16_MAX).astype("<i2")
    write_png(path, fixed.view(np.uint8))
    return fixed.astype(np.float32) / _FLOW_SCALE


def png_to_flow(path) -> np.ndarray:
    """Decode a fixed-point flow PNG back to float32 [H, W, 2]."""
    packed = np.ascontiguousarray(read_image(path, unchanged=True), np.uint8)
    return packed.view("<i2").astype(np.float32) / _FLOW_SCALE


def read_mask(path) -> np.ndarray:
    """A mask PNG → bool [H, W]: any nonzero channel is valid."""
    mask = read_image(path, unchanged=True)
    if mask.ndim == 3:  # RGB(A)-saved masks
        mask = mask.max(axis=-1)
    return mask > 0


def absolute_flow(flow: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Relative flow + the pixel grid, NaN where the mask is off."""
    h, w = flow.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    aflow = flow + np.stack([xs, ys], axis=-1)
    aflow[~mask] = np.nan
    return aflow


class StillPairDataset:
    """Identity pairs over a base image dataset: img1 == img2, aflow is
    the (scaled) identity grid — used for style-transferred stills where
    the two renderings are pixel-aligned."""

    def __init__(self, base, pairs: Optional[Sequence[Tuple[int, int]]] = None):
        self.base = base
        self.pairs = list(pairs) if pairs is not None else [(i, i) for i in range(len(base))]

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, idx: int):
        i, j = self.pairs[idx]
        img1 = self.base.get_image(i)
        img2 = self.base.get_image(j)
        h, w = img1.shape[:2]
        sy = img2.shape[0] / h
        sx = img2.shape[1] / w
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        aflow = np.stack([xs * sx, ys * sy], axis=-1)
        mask = np.ones((h, w), bool)
        return img1, img2, aflow, mask


class FlowPairDataset:
    """Image pairs with precomputed flow/mask PNGs.

    Layout: a pair list of (name1, name2, flow_png, mask_png) relative to
    `image_root`; masks are uint8 PNGs where nonzero = valid. Invalid flow
    becomes NaN, matching the PairLoader contract."""

    def __init__(self, image_root, entries: Sequence[Tuple[str, str, str, str]]):
        self.root = Path(image_root)
        self.entries = list(entries)

    def __len__(self):
        return len(self.entries)

    def get_pair(self, idx: int):
        name1, name2, flow_png, mask_png = self.entries[idx]
        img1 = read_rgb(self.root / name1)
        img2 = read_rgb(self.root / name2)
        flow = png_to_flow(self.root / flow_png)
        mask = read_mask(self.root / mask_png)
        h, w = img1.shape[:2]
        if flow.shape[:2] != (h, w) or mask.shape != (h, w):
            raise ValueError(f"flow/mask shape {flow.shape[:2]}/{mask.shape} does not "
                             f"match image {name1} shape {(h, w)}")
        return img1, img2, absolute_flow(flow, mask), mask
