"""Batched feature extraction (images → feature store), single scale.

Port of ``sfd2_tpu/pipeline/extract.py``: the named conf registry
(``extract_localization.py:26-120``), cv2 BGR→RGB loading with
INTER_CUBIC max-edge resize, bucketed static batch shapes, uint8 upload
with normalisation on the device, the fused stem (kernel K1 on CUDA) →
``forward_from_out1c`` → ``extract_keypoints``, and the reference's
keypoint rescale ``(kp + 0.5) * scale − 0.5``.

Differences from the JAX pipeline: buckets are rounded to
``pad_multiple`` only (the W%256 / H%16 rounding existed for the TPU
stem kernel); the stem always runs fused; multi-scale pyramids and
semantic label maps are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.ops.resize import resize_bilinear
from sfd2_torch.ops.stem import repack_stem_params
from sfd2_torch.utils.device import resolve_device

# ImageNet normalisation (``nets/extractor.py:14-15``).
_RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class ExtractionConfig:
    max_keypoints: int = 4096
    conf_threshold: float = 0.001
    nms_radius: int = 4
    border: int = 4
    resize_max: int = 1600
    pad_multiple: int = 64  # static-shape bucketing granularity
    batch_size: int = 16
    bf16: bool | None = None  # bfloat16 trunk; None = on for CUDA, off on
    #                           CPU. The stem kernel computes in float32
    #                           either way. Pass False for parity runs: bf16
    #                           shifts keypoint ranking on near-ties.
    as_half: bool = False  # store descriptors as float16 (hloc as_half)


# Named presets of the reference registry (single-scale entries).
EXTRACTION_CONFS: Dict[str, ExtractionConfig] = {
    "sfd2-n4096-r1600": ExtractionConfig(max_keypoints=4096, resize_max=1600),
    "sfd2-n3000-r1600": ExtractionConfig(max_keypoints=3000, resize_max=1600),
    "sfd2-n2000-r1600": ExtractionConfig(max_keypoints=2000, resize_max=1600),
    "sfd2-n1000-r1600": ExtractionConfig(max_keypoints=1000, resize_max=1600),
    "sfd2-n4096-r1024": ExtractionConfig(max_keypoints=4096, resize_max=1024),
}


def load_image(path, resize_max: int | None):
    """cv2 load (BGR→RGB) + INTER_CUBIC max-edge resize; returns
    (float32 [H,W,3] in [0,1], original (w, h))."""
    import cv2

    bgr = cv2.imread(str(path))
    if bgr is None:
        raise FileNotFoundError(path)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    h, w = rgb.shape[:2]
    if resize_max and max(h, w) > resize_max:
        scale = resize_max / max(h, w)
        rgb = cv2.resize(rgb, (int(round(w * scale)), int(round(h * scale))),
                         interpolation=cv2.INTER_CUBIC)
    return rgb.astype(np.float32) / 255.0, (w, h)


def normalize_image(img: np.ndarray) -> np.ndarray:
    return (img - _RGB_MEAN) / _RGB_STD


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Extractor:
    """Batched single-scale extraction on one device."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 config: ExtractionConfig = ExtractionConfig(), device="cuda"):
        """`state_dict`: a ResSegNetV2 state_dict in the reference's names
        (``models/convert.py``)."""
        self.device = resolve_device(device)
        if config.bf16 is None:
            config = dataclasses.replace(config, bf16=self.device.type == "cuda")
        logging.getLogger(__name__).info(
            "Extractor: trunk dtype %s on %s", "bfloat16" if config.bf16 else "float32",
            self.device)
        self.cfg = config
        model = ResSegNetV2(outdim=state_dict["convDb.weight"].shape[0],
                            require_stability="ConvSta.weight" in state_dict)
        model.load_state_dict(state_dict)
        dtype = torch.bfloat16 if config.bf16 else torch.float32
        self.model = model.eval().to(self.device, dtype)
        self.stem = StemWeights(repack_stem_params(state_dict), self.device)
        self._mean = torch.as_tensor(_RGB_MEAN, device=self.device)
        self._std = torch.as_tensor(_RGB_STD, device=self.device)

    def _pad_hw(self, h: int, w: int) -> Tuple[int, int]:
        m = self.cfg.pad_multiple
        return -(-h // m) * m, -(-w // m) * m

    def _pad_batch(self, images: Sequence[np.ndarray]):
        """uint8 [B, hp, wp, 3] zero-padded batch (normalised on device)."""
        hp, wp = self._pad_hw(max(im.shape[0] for im in images),
                              max(im.shape[1] for im in images))
        batch = np.zeros((len(images), hp, wp, 3), np.uint8)
        for i, im in enumerate(images):
            batch[i, : im.shape[0], : im.shape[1]] = np.clip(
                np.rint(im * 255.0), 0, 255).astype(np.uint8)
        return batch, (hp, wp)

    @torch.inference_mode()
    def _run(self, images_u8: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        """Device program: normalise → stem → trunk/heads → keypoints; one
        packed [B, K, 4+C] float32 result (xy, score, descriptor, valid)."""
        cfg = self.cfg
        x = (images_u8.float() / 255.0 - self._mean) / self._std
        out1c = fused_stem_cuda(x, self.stem,
                                torch.bfloat16 if cfg.bf16 else torch.float32)
        out = self.model.forward_from_out1c(out1c)
        score = out.score
        h, w = images_u8.shape[1], images_u8.shape[2]
        if score.shape[1] != h or score.shape[2] != w:
            score = resize_bilinear(score[..., None], (h, w))[..., 0]
        kp = extract_keypoints(score, out.descriptors, out.stability, sizes,
                               max_keypoints=cfg.max_keypoints,
                               conf_threshold=cfg.conf_threshold,
                               nms_radius=cfg.nms_radius, border=cfg.border)
        return torch.cat([kp.xy, kp.scores[..., None], kp.descriptors.float(),
                          kp.valid[..., None].float()], dim=-1)

    def extract_batch(self, images: Sequence[np.ndarray]) -> List[ImageFeatures]:
        """Extract from a list of float [H,W,3] images in [0, 1] (possibly
        ragged); keypoints sorted by descending score."""
        batch, _ = self._pad_batch(images)
        sizes = torch.tensor([[im.shape[1], im.shape[0]] for im in images],
                             dtype=torch.int32, device=self.device)
        packed = self._run(torch.from_numpy(batch).to(self.device), sizes)
        packed = packed.cpu().numpy()  # one device→host fetch per batch
        c = packed.shape[-1] - 4
        out = []
        for i, im in enumerate(images):
            sh, sw = im.shape[:2]
            xy = packed[i, :, 0:2]
            v = (packed[i, :, 3 + c] > 0.5) & (xy[:, 0] < sw) & (xy[:, 1] < sh)
            sc = packed[i, :, 2][v]
            order = np.argsort(-sc)[: self.cfg.max_keypoints]
            out.append(ImageFeatures(xy[v][order], packed[i, :, 3:3 + c][v][order],
                                     sc[order], np.array([sw, sh])))
        return out

    def _probe_bucket(self, path) -> Tuple[int, int]:
        """Padded bucket an image lands in after load_image's resize, from a
        header-only size read."""
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        rm = self.cfg.resize_max
        if rm and max(h, w) > rm:
            s = rm / max(h, w)
            w, h = int(round(w * s)), int(round(h * s))
        return self._pad_hw(h, w)

    def extract_to_store(self, image_dir, names: Iterable[str], store: FeatureStore,
                         skip_existing: bool = True) -> int:
        """Extract `names` (paths relative to `image_dir`) into `store`;
        existing groups are skipped. The work list is grouped by padded
        bucket first, then chunked into `batch_size` batches whose batch
        dim is padded to a power of two with 1×1 dummies. Returns the
        number of images extracted."""
        cfg = self.cfg
        groups: Dict[Tuple[int, int], List[str]] = {}
        for n in names:
            if not (skip_existing and n in store):
                groups.setdefault(self._probe_bucket(Path(image_dir) / n), []).append(n)
        count = 0
        for gnames in groups.values():
            for i in range(0, len(gnames), cfg.batch_size):
                chunk = gnames[i: i + cfg.batch_size]
                loaded = [load_image(Path(image_dir) / n, cfg.resize_max) for n in chunk]
                images = [im for im, _ in loaded]
                images += [np.zeros((1, 1, 3), np.float32)] * (
                    min(cfg.batch_size, _pow2_ceil(len(chunk))) - len(chunk))
                feats = self.extract_batch(images)[: len(chunk)]
                for n, f, (im, (w0, h0)) in zip(chunk, feats, loaded):
                    scale = np.array([w0 / im.shape[1], h0 / im.shape[0]], np.float32)
                    store.write(n, ImageFeatures(
                        (f.keypoints + 0.5) * scale - 0.5, f.descriptors, f.scores,
                        np.array([w0, h0])), as_half=cfg.as_half)
                    count += 1
        return count
