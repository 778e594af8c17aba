"""Online semantic-label teacher for training batches.

Port of ``sfd2_tpu/training/seg_teacher.py`` (``trainer.py:281-316``: the
reference runs mmseg's SegNet over each raw training image in a Python
loop and shifts the labels by +1). Here the whole ``raw1`` batch
[B, R, R, 3] is labelled in one device call: upload, ADE20k normalisation,
the UPerNet forward, the bilinear upsample of the logits and the argmax,
then one fetch. At the shipped R=512 the crop equals the segmentor's slide
window, so whole-image inference is mmseg's slide result at that size.
``LabelDirTeacher`` reads label maps written ahead of time (cv2, imported
lazily).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from sfd2_torch.models.upernet import (ADE20K_MEAN, ADE20K_STD, ConvNeXtUPerNet,
                                       load_mmseg_state_dict, seeded_segmentor)
from sfd2_torch.utils.device import resolve_device


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
    """Label maps written ahead of time (``cli/segment_images.py`` of the
    JAX package), looked up by the image's relative path under
    `label_dir`, then by the bare stem; a missing map gives zeros
    (unlabeled, masked by the seg losses)."""

    def __init__(self, label_dir):
        self.label_dir = Path(label_dir)

    def label_image(self, name: str, hw: tuple[int, int]) -> np.ndarray:
        import cv2

        p = self.label_dir / Path(name).with_suffix(".png")
        if not p.exists():  # flat layout
            p = self.label_dir / (Path(name).stem + ".png")
        if not p.exists():
            return np.zeros(hw, np.int32)
        lab = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        if lab is None:
            return np.zeros(hw, np.int32)
        if lab.shape[:2] != hw:
            lab = cv2.resize(lab, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
        return lab.astype(np.int32)


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
