"""Concrete training datasets: Aachen Day-Night layouts, web distractors,
and the reference's W/A/S/F/D data-source letter codes.

Port of ``sfd2_tpu/training/datasets_aachen.py``:
* ``datasets/aachen.py`` — ``AachenImages`` (walk ``images_upright``,
  filter by path components 'db'/'day'/'night'),
  ``AachenPairs_StyleTransferDayNight`` (``style_transfer/`` files named
  ``<tag>.jpg.st_*`` paired with the db image of the same tag as
  pixel-aligned stills) and ``AachenPairs_OpticalFlow``
  (``optical_flow/{flow,mask}/<tagA>_<tagB>.png`` pairs).
* ``datasets/web_images.py`` — ``RandomWebImages`` (revisitop1m hex
  folder shards).
* ``train.py:24-64`` — the W/A/S/F/D data-source selection as
  `build_data_source` over typed datasets.

All classes expose the PairLoader contracts: `get_image(i)` (synthetic
warping) or `get_pair(i) → (img1, img2, aflow, mask)` (precomputed).
Synthetic pairs come from ``training/data.py::SyntheticPairBuilder``
(``grid_sample``, no OpenCV); files are read through ``utils/image_io.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from sfd2_torch.training.data import ImageFolderDataset, SyntheticPairBuilder
from sfd2_torch.training.flow_pairs import StillPairDataset, absolute_flow, png_to_flow, read_mask
from sfd2_torch.utils.image_io import read_rgb

class AachenImages:
    """Aachen images filtered by path components (``aachen.py:13-35``)."""

    def __init__(self, root, select: str = "db day night", img_dir: str = "images_upright"):
        self.root = Path(root)
        sel = set(select.split())
        base = self.root / img_dir
        self.imgs: List[str] = []
        for dirpath, _, files in os.walk(base):
            rel = os.path.relpath(dirpath, base)
            parts = set(() if rel == "." else rel.split(os.sep))
            if not (sel & parts):
                continue
            self.imgs += sorted(os.path.join(rel, f) for f in files if f.endswith(".jpg"))
        if not self.imgs:
            raise FileNotFoundError(f"no Aachen images under {base} ({select})")
        self._base = base

    def __len__(self):
        return len(self.imgs)

    def get_key(self, i: int) -> str:
        return self.imgs[i]

    def get_tag(self, i: int) -> str:
        return os.path.split(self.imgs[i][:-4])[1]

    def get_image(self, i: int) -> np.ndarray:
        return read_rgb(self._base / self.imgs[i])


class _PathImages:
    """Minimal get_image dataset over absolute paths."""

    def __init__(self, paths: Sequence[Path]):
        self.paths = list(paths)

    def __len__(self):
        return len(self.paths)

    def get_image(self, i: int) -> np.ndarray:
        return read_rgb(self.paths[i])


def aachen_style_transfer_pairs(root, aachen_root=None) -> StillPairDataset:
    """``AachenPairs_StyleTransferDayNight`` (``aachen.py:51-74``): each
    ``style_transfer/<tag>.jpg.st_*`` file pairs with the db image of the
    same tag; the renderings are pixel-aligned → identity-flow stills."""
    root = Path(root)
    st_dir = root if root.name == "style_transfer" else root / "style_transfer"
    db = AachenImages(aachen_root or root.parent, select="db")
    tag_to_idx = {db.get_tag(i): i for i in range(len(db))}
    paths = [db._base / db.imgs[i] for i in range(len(db))]
    pairs = []
    for fname in sorted(os.listdir(st_dir)):
        tag = fname.split(".jpg.st_")[0]
        if tag not in tag_to_idx:
            continue
        pairs.append((tag_to_idx[tag], len(paths)))
        paths.append(st_dir / fname)
    if not pairs:
        raise FileNotFoundError(f"no style-transfer pairs under {st_dir}")
    return StillPairDataset(_PathImages(paths), pairs)


class AachenFlowPairs:
    """``AachenPairs_OpticalFlow`` (``aachen.py:77-140``): db-image pairs
    with precomputed flow/mask PNGs named ``<tagA>_<tagB>.png``."""

    def __init__(self, root, aachen_root=None):
        root = Path(root)
        self.flow_dir = root if root.name == "optical_flow" else root / "optical_flow"
        self.db = AachenImages(aachen_root or root.parent, select="db")
        tag_to_idx = {self.db.get_tag(i): i for i in range(len(self.db))}
        flows = {f for f in os.listdir(self.flow_dir / "flow") if f.endswith(".png")}
        masks = {f for f in os.listdir(self.flow_dir / "mask") if f.endswith(".png")}
        if flows != masks:
            raise ValueError("missing flow or mask pairs")
        self.pairs = []
        for f in sorted(flows):
            a, b = f[:-4].split("_")
            self.pairs.append((tag_to_idx[a], tag_to_idx[b], f))
        if not self.pairs:
            raise FileNotFoundError(f"no flow pairs under {self.flow_dir}")

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, idx: int):
        ia, ib, f = self.pairs[idx]
        img1 = self.db.get_image(ia)
        img2 = self.db.get_image(ib)
        flow = png_to_flow(self.flow_dir / "flow" / f)
        mask = read_mask(self.flow_dir / "mask" / f)
        return img1, img2, absolute_flow(flow, mask), mask


class RandomWebImages:
    """revisitop1m distractors (``web_images.py:11-58``): hex-named shard
    folders 000..fff; `start`/`end` select cache-block ranges (each block
    spans 4 folders, as the reference's cached lists do)."""

    def __init__(self, root, start: int = 0, end: int = 1024):
        self.root = Path(root)
        self.imgs: List[str] = []
        for i in range(start, end):
            for d in range(i * 4, (i + 1) * 4):
                key = hex(d)[2:].zfill(3)
                folder = self.root / key
                if not folder.is_dir():
                    continue
                self.imgs += sorted(os.path.join(key, f) for f in os.listdir(folder)
                                    if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if not self.imgs:
            raise FileNotFoundError(f"no web images under {self.root}")

    def __len__(self):
        return len(self.imgs)

    def get_image(self, i: int) -> np.ndarray:
        return read_rgb(self.root / self.imgs[i])


class SyntheticPairAdapter:
    """A get_image dataset as get_pair through homography warping (the
    ``SyntheticPairDataset`` wrapping of the W/A/D sources,
    ``train.py:29-38``). Pairs are deterministic per (seed, index);
    crop randomness stays in the PairLoader's builder downstream."""

    def __init__(self, base, crop: int = 512, seed: int = 0,
                 builder: Optional[SyntheticPairBuilder] = None):
        self.base = base
        self.builder = builder or SyntheticPairBuilder(crop=crop)
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def get_pair(self, idx: int):
        rng = np.random.default_rng(self.seed + 7919 * idx)
        img1, img2, flow, valid = self.builder.make_full_pair(rng, self.base.get_image(idx))
        aflow = np.where(valid[..., None], flow, np.nan).astype(np.float32)
        return img1, img2, aflow, valid


class CatPairDataset:
    """Concatenate get_pair datasets (``CatPairDataset``,
    ``pair_dataset.py:239``)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def get_pair(self, idx: int):
        di = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[di].get_pair(idx - int(self.offsets[di]))


def build_data_source(codes: str, crop: int = 512, aachen_root=None, web_root=None,
                      debug_root=None, seed: int = 0):
    """W/A/S/F/D letter codes → one concatenated get_pair dataset
    (``train.py:45-51``):

      W — synthetic warps of RandomWebImages(web_root)
      A — synthetic warps of Aachen db images
      S — style-transfer day-night stills
      F — optical-flow pairs
      D — synthetic warps of an arbitrary debug image folder
    """
    parts = []
    for code in codes:
        if code == "W":
            parts.append(SyntheticPairAdapter(RandomWebImages(web_root), crop=crop, seed=seed))
        elif code == "A":
            parts.append(SyntheticPairAdapter(AachenImages(aachen_root, select="db"),
                                              crop=crop, seed=seed))
        elif code == "S":
            parts.append(aachen_style_transfer_pairs(Path(aachen_root) / "style_transfer",
                                                     aachen_root))
        elif code == "F":
            parts.append(AachenFlowPairs(Path(aachen_root) / "optical_flow", aachen_root))
        elif code == "D":
            parts.append(SyntheticPairAdapter(ImageFolderDataset(debug_root), crop=crop,
                                              seed=seed))
        else:
            raise ValueError(f"unknown data-source code {code!r}")
    return parts[0] if len(parts) == 1 else CatPairDataset(parts)
