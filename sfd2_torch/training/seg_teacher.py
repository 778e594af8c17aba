"""Online semantic-label teacher for training batches.

Port of ``sfd2_tpu/training/seg_teacher.py`` (``trainer.py:281-316``: the
reference runs mmseg's SegNet over each raw training image in a Python
loop and shifts the labels by +1). Here the whole ``raw1`` batch
[B, R, R, 3] is labelled in one device call: upload, ADE20k normalisation,
the UPerNet forward, the bilinear upsample of the logits and the argmax,
then one fetch. At the shipped R=512 the crop equals the segmentor's slide
window, so whole-image inference is mmseg's slide result at that size.
``LabelDirTeacher`` reads label maps written ahead of time
(``cli/segment_images.py``) through ``utils/image_io.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from sfd2_torch.models.upernet import (ADE20K_MEAN, ADE20K_STD, ConvNeXtUPerNet,
                                       load_mmseg_state_dict, seeded_segmentor)
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.image_io import read_image


class SegTeacher:
    """Batch labeller: raw RGB batch in [0, 1] → 1-based ADE20k labels.
    Without a model, a ConvNeXt-B UPerNet with seeded weights. float32
    unless `bf16` (the JAX package's choice off a TPU)."""

    def __init__(self, model: Optional[ConvNeXtUPerNet] = None, device="cuda",
                 bf16: bool = False, seed: int = 0):
        self.device = resolve_device(device)
        model = model or seeded_segmentor(seed=seed)
        dt = torch.bfloat16 if bf16 else torch.float32
        self.model = model.eval().requires_grad_(False).to(self.device, dt)
        self.mean = torch.from_numpy(ADE20K_MEAN).to(self.device)
        self.std = torch.from_numpy(ADE20K_STD).to(self.device)

    @classmethod
    def from_torch_checkpoint(cls, path, device="cuda", **kwargs) -> "SegTeacher":
        """An mmseg ``upernet_convnext_base`` checkpoint (``.pth``)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        return cls(load_mmseg_state_dict(ConvNeXtUPerNet(), state), device=device, **kwargs)

    @torch.no_grad()
    def label_tensor(self, raw1: np.ndarray) -> torch.Tensor:
        """[B, R, R, 3] float RGB in [0, 1] → [B, R, R] int64 labels
        1..150 on the device; nothing waits for the device."""
        raw1 = torch.from_numpy(np.ascontiguousarray(raw1, np.float32)).to(
            self.device, non_blocking=True)
        x = (raw1 * 255.0 - self.mean) / self.std
        logits = self.model(x).permute(0, 3, 1, 2)
        logits = torch.nn.functional.interpolate(logits, size=raw1.shape[1:3], mode="bilinear",
                                                 align_corners=False)
        # +1: mmseg's 0-based argmax → 1..150 (trainer.py:290; 0 stays
        # "unlabeled" in semantics.py).
        return logits.argmax(1) + 1

    def label_batch(self, raw1: np.ndarray) -> np.ndarray:
        """[B, R, R, 3] float RGB in [0, 1] → [B, R, R] int32 (1..150)."""
        return self.label_tensor(raw1).to(torch.int32).cpu().numpy()


class LabelDirTeacher:
    """Label maps written ahead of time (``cli/segment_images.py``), looked
    up by the image's relative path under `label_dir`, then by the bare
    stem; a missing map gives zeros (unlabeled, masked by the seg losses).
    A map of another size is resized by OpenCV's INTER_NEAREST rule
    (source pixel ⌊x · src/dst⌋)."""

    def __init__(self, label_dir):
        self.label_dir = Path(label_dir)

    def label_image(self, name: str, hw: tuple[int, int]) -> np.ndarray:
        p = self.label_dir / Path(name).with_suffix(".png")
        if not p.exists():  # flat layout
            p = self.label_dir / (Path(name).stem + ".png")
        if not p.exists():
            return np.zeros(hw, np.int32)
        try:
            lab = read_image(p, unchanged=True)
        except FileNotFoundError:  # undecodable
            return np.zeros(hw, np.int32)
        if lab.shape[:2] != hw:
            ys = np.minimum((np.arange(hw[0]) * (lab.shape[0] / hw[0])).astype(np.int64),
                            lab.shape[0] - 1)
            xs = np.minimum((np.arange(hw[1]) * (lab.shape[1] / hw[1])).astype(np.int64),
                            lab.shape[1] - 1)
            lab = lab[ys[:, None], xs[None, :]]
        return lab.astype(np.int32)


class LabelDirPairs:
    """A get_pair dataset whose pairs carry img1's label map from a
    `LabelDirTeacher`: ``names[i]`` is pair i's img1 path relative to the
    label folder. A ``PrecomputedPairBuilder`` crops the map with img1,
    so the loader's batches hold ``seg1`` and the trainer runs the seg
    losses without an online teacher."""

    def __init__(self, dataset, teacher: LabelDirTeacher, names):
        self.dataset = dataset
        self.teacher = teacher
        self.names = list(names)
        if len(self.names) != len(dataset):
            raise ValueError(f"{len(self.names)} names for {len(dataset)} pairs")

    def __len__(self):
        return len(self.dataset)

    def get_pair(self, idx: int):
        img1, img2, aflow, mask = self.dataset.get_pair(idx)
        return img1, img2, aflow, mask, self.teacher.label_image(self.names[idx], img1.shape[:2])


class SegTeacherLoader:
    """A PairLoader wrapper that adds ``seg1`` to every batch through a
    SegTeacher (one device call per batch); the labels stay on the device
    as a tensor."""

    def __init__(self, loader, teacher: SegTeacher):
        self.loader = loader
        self.teacher = teacher

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def epoch(self, epoch: int) -> Iterator[dict]:
        for batch in self.loader.epoch(epoch):
            batch = dict(batch)
            batch["seg1"] = self.teacher.label_tensor(batch["raw1"])
            yield batch
