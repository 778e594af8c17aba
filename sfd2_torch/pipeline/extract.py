"""Batched feature extraction (images → feature store), single or multi-scale.

Port of ``sfd2_tpu/pipeline/extract.py``: the named conf registry
(``extract_localization.py:26-120``), cv2 BGR→RGB loading with
INTER_CUBIC max-edge resize, bucketed static batch shapes, the images
quantised to uint8 and normalised on the device, the fused stem (kernel
K1 on CUDA) → ``forward_from_out1c`` → ``extract_keypoints``, and the
reference's keypoint rescale ``(kp + 0.5) * scale − 0.5``. Multi-scale
extraction (``extract.py:87-200``): a fixed scale tuple or the per-image
``auto`` pyramid, each scale resized on the device (``ops/resize.py``),
run as its own batch, and merged across scales on the host. Semantic
label maps (``nets/extractor.py:240-326``) make the top-K labelled-first
and give each keypoint its label.

With a ``mesh`` (``parallel/mesh.py``) each batch is split over the
mesh's ``data`` axis, padded with empty images to whole shares: every
device holds a replica of the model and the stem's weights, runs its
share (kernel K1 on CUDA) and returns its own packed result.

Numpy images go to the device in their own dtype and are rounded there
into the padded uint8 batch, as resized scales are: the same levels as
the JAX pipeline's rounding on the host, bit for bit.

Spans (``utils/profiling.py``): ``extract.batch`` per ``extract_batch``
(tag ``images``), and under it, per scale, ``extract.upload`` (the numpy
images' copies to the device), ``extract.round`` (the host's enqueue of
their quantisation into the padded uint8 batch; tag ``images``, from the
counter ``extract.device_rounds``: the numpy images quantised on the
device), ``extract.launch`` (the host's enqueue of normalisation, K1, the
trunk and keypoint selection) and ``extract.fetch`` (the packed result's
copy back).

Differences from the JAX pipeline: buckets are rounded to
``pad_multiple`` only (the W%256 / H%16 rounding existed for the TPU
stem kernel); the stem always runs fused.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.ops.resize import resize_bilinear
from sfd2_torch.ops.stem import repack_stem_params
from sfd2_torch.parallel.mesh import put_batch, put_replicated, shard_batch
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import count, span

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
    # Scale pyramid: a fixed tuple, or "auto" for the reference's
    # ×1/1.2-until-min-edge<256 pyramid (``extract.py:87-200``) with a
    # depth per image.
    scales: Tuple[float, ...] | str = (1.0,)
    pad_multiple: int = 64  # static-shape bucketing granularity
    batch_size: int = 16
    bf16: bool | None = None  # bfloat16 trunk; None = on for CUDA, off on
    #                           CPU. The stem kernel computes in float32
    #                           either way. Pass False for parity runs: bf16
    #                           shifts keypoint ranking on near-ties.
    as_half: bool = False  # store descriptors as float16 (hloc as_half)


# Named presets of the reference registry (``extract_localization.py:26-120``).
EXTRACTION_CONFS: Dict[str, ExtractionConfig] = {
    "sfd2-n4096-r1600": ExtractionConfig(max_keypoints=4096, resize_max=1600),
    "sfd2-n3000-r1600": ExtractionConfig(max_keypoints=3000, resize_max=1600),
    "sfd2-n2000-r1600": ExtractionConfig(max_keypoints=2000, resize_max=1600),
    "sfd2-n1000-r1600": ExtractionConfig(max_keypoints=1000, resize_max=1600),
    "sfd2-n4096-r1024": ExtractionConfig(max_keypoints=4096, resize_max=1024),
    "sfd2-n4096-r1600-ms": ExtractionConfig(max_keypoints=4096, resize_max=1600,
                                            scales=(1.0, 0.8333, 0.6944)),
    "sfd2-n4096-r1600-msauto": ExtractionConfig(max_keypoints=4096, resize_max=1600,
                                                scales="auto"),
}

_AUTO_SCALE_STEP = 1.2
_AUTO_MIN_EDGE = 256


def auto_scales(min_edges: Sequence[int]):
    """Per-image ×1/1.2 pyramid depths (``extract.py:87-200``: the scale is
    divided by 1.2 while the scaled min edge stays ≥ 256; 1.0 always).
    Returns (the scales of the deepest image, active[k][i]: whether image i
    takes part at scale step k)."""
    depths = []
    for e in min_edges:
        d = 1
        while e / _AUTO_SCALE_STEP**d >= _AUTO_MIN_EDGE:
            d += 1
        depths.append(d)
    n = max(depths)
    return (tuple(1.0 / _AUTO_SCALE_STEP**k for k in range(n)),
            [[k < d for d in depths] for k in range(n)])


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


def load_label_map(path) -> np.ndarray:
    """A semantic-mask image as a packed int32 id map [H, W]: the
    reference packs BGR as id = R·65536 + G·256 + B, 0 = unlabelled
    (``nets/extractor.py:252``)."""
    import cv2

    bgr = cv2.imread(str(path))
    if bgr is None:
        raise FileNotFoundError(path)
    b, g, r = (bgr[:, :, i].astype(np.int32) for i in range(3))
    return r * 65536 + g * 256 + b


def _resize_labels_nearest(labels: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of an id map (ids cannot be interpolated)."""
    h, w = hw
    if labels.shape[:2] == (h, w):
        return labels
    ys = np.clip((np.arange(h) + 0.5) * labels.shape[0] / h, 0, labels.shape[0] - 1)
    xs = np.clip((np.arange(w) + 0.5) * labels.shape[1] / w, 0, labels.shape[1] - 1)
    return labels[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """Float [..., 3] in [0, 1] to uint8 levels, bit for bit
    ``np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)``: the product
    and the rounding (half to even) in x's own dtype."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


class _Replica(NamedTuple):
    """What one device needs to run the extraction program."""

    model: ResSegNetV2
    stem: StemWeights
    mean: torch.Tensor
    std: torch.Tensor


class Extractor:
    """Batched extraction on one device, or split over a mesh."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 config: ExtractionConfig = ExtractionConfig(), device="cuda", mesh=None):
        """`state_dict`: a ResSegNetV2 state_dict in the reference's names
        (``models/convert.py``). `mesh`: an optional ``parallel.mesh.Mesh``
        with a 'data' axis over which every batch is split; batches are
        assembled on `device`."""
        self.device = resolve_device(device)
        self.mesh = mesh
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
        model = model.eval().to(dtype)
        stem = repack_stem_params(state_dict)
        devices = [self.device] if mesh is None else shard_batch(mesh)
        models = [model.to(self.device)] if mesh is None else put_replicated(mesh, model, "data")
        self._replicas = [_Replica(m, StemWeights(stem, d), torch.as_tensor(_RGB_MEAN, device=d),
                                   torch.as_tensor(_RGB_STD, device=d))
                          for m, d in zip(models, devices)]
        self.model = self._replicas[0].model

    def _pad_hw(self, h: int, w: int) -> Tuple[int, int]:
        m = self.cfg.pad_multiple
        return -(-h // m) * m, -(-w // m) * m

    def _pad_batch(self, images: Sequence):
        """uint8 [B, hp, wp, 3] zero-padded batch on the device (normalised
        there). Each image is float [H, W, 3] in [0, 1]: a numpy array,
        copied to the device in its own dtype, or a tensor on the device (a
        resized scale); both are rounded there by ``_quantize``."""
        hp, wp = self._pad_hw(max(im.shape[0] for im in images),
                              max(im.shape[1] for im in images))
        batch = torch.zeros((len(images), hp, wp, 3), dtype=torch.uint8, device=self.device)
        host = [i for i, im in enumerate(images) if isinstance(im, np.ndarray)]
        if host:
            # One pageable copy per image: on an H100's host this ran faster
            # than a pinned double buffer filled by the host's memcpy (PERF.md).
            with span("extract.upload"):
                staged = [torch.from_numpy(np.ascontiguousarray(images[i])).to(self.device)
                          for i in host]
            with span("extract.round"):
                for i, x in zip(host, staged):
                    batch[i, : x.shape[0], : x.shape[1]] = _quantize(x)
                count("extract.device_rounds", len(host), tag="images")
        for i, im in enumerate(images):
            if isinstance(im, torch.Tensor):
                batch[i, : im.shape[0], : im.shape[1]] = _quantize(im)
        return batch, (hp, wp)

    @torch.inference_mode()
    def _run(self, images_u8: torch.Tensor, sizes: torch.Tensor,
             label_map: torch.Tensor | None = None, replica: _Replica | None = None
             ) -> torch.Tensor:
        """Device program: normalise → stem → trunk/heads → keypoints; one
        packed [B, K, 4+C(+1)] float32 result (xy, score, descriptor, valid
        and, with a label map, the label: ids < 2^24 are exact in f32)."""
        cfg = self.cfg
        rep = replica or self._replicas[0]
        x = (images_u8.float() / 255.0 - rep.mean) / rep.std
        out1c = fused_stem_cuda(x, rep.stem, torch.bfloat16 if cfg.bf16 else torch.float32)
        out = rep.model.forward_from_out1c(out1c)
        score = out.score
        h, w = images_u8.shape[1], images_u8.shape[2]
        if score.shape[1] != h or score.shape[2] != w:
            score = resize_bilinear(score[..., None], (h, w))[..., 0]
        kp = extract_keypoints(score, out.descriptors, out.stability, sizes, label_map,
                               max_keypoints=cfg.max_keypoints,
                               conf_threshold=cfg.conf_threshold,
                               nms_radius=cfg.nms_radius, border=cfg.border)
        parts = [kp.xy, kp.scores[..., None], kp.descriptors.float(), kp.valid[..., None].float()]
        if kp.labels is not None:
            parts.append(kp.labels[..., None].float())
        return torch.cat(parts, dim=-1)

    def _run_packed(self, images_u8: torch.Tensor, sizes: torch.Tensor,
                    label_map: torch.Tensor | None) -> np.ndarray:
        """`_run` on the host's side: one fetch per device. Over a mesh the
        batch is padded with empty 1×1 images to whole shares, each device
        runs its share, and the padding is dropped."""
        if self.mesh is None:
            with span("extract.launch"):
                packed = self._run(images_u8, sizes, label_map)
            with span("extract.fetch"):
                return packed.cpu().numpy()
        b = images_u8.shape[0]
        n = len(self._replicas)
        pad = -(-b // n) * n - b
        if pad:
            images_u8 = torch.cat([images_u8, images_u8.new_zeros((pad, *images_u8.shape[1:]))])
            sizes = torch.cat([sizes, sizes.new_ones((pad, 2))])
            if label_map is not None:
                label_map = torch.cat([label_map,
                                       label_map.new_zeros((pad, *label_map.shape[1:]))])
        shares = put_batch(self.mesh, (images_u8, sizes, label_map))
        with span("extract.launch"):
            packed = [self._run(*share, replica=rep) for share, rep in zip(shares, self._replicas)]
        with span("extract.fetch"):
            return np.concatenate([p.cpu().numpy() for p in packed])[:b]

    def extract_batch(self, images: Sequence[np.ndarray],
                      label_maps: Sequence[np.ndarray] | None = None) -> List[ImageFeatures]:
        """Extract from a list of float [H,W,3] images in [0, 1] (possibly
        ragged). Each scale of the pyramid is one batch; a scaled image is
        (int(h·s), int(w·s)), resized on the device. Keypoints of every
        scale, rescaled to the input resolution, are merged on the host by
        descending score (``np.argsort``, as the JAX pipeline), at most
        ``max_keypoints``. `label_maps`: per-image int32 [H, W] id maps (any
        resolution, nearest-resized per scale): labelled-first top-K and
        merge, and per-keypoint ``labels``."""
        with span("extract.batch", images=len(images)):
            cfg = self.cfg
            with_labels = label_maps is not None
            if cfg.scales == "auto":
                scales, active = auto_scales([min(im.shape[0], im.shape[1]) for im in images])
            else:
                scales, active = cfg.scales, [[True] * len(images)] * len(cfg.scales)
            # An image below its auto-pyramid depth takes a 1×1 dummy: it never
            # widens the padded batch, its size border-masks every keypoint, and
            # it is skipped below.
            dummy = np.zeros((1, 1, 3), np.float32)
            on_device: Dict[int, torch.Tensor] = {}
            parts: List[List[tuple]] = [[] for _ in images]
            for s, act in zip(scales, active):
                scaled = []
                for i, (im, a) in enumerate(zip(images, act)):
                    if not a:
                        scaled.append(dummy)
                    elif s == 1.0:
                        scaled.append(im)
                    else:
                        if i not in on_device:
                            on_device[i] = torch.from_numpy(
                                np.ascontiguousarray(im, np.float32)).to(self.device)
                        scaled.append(resize_bilinear(on_device[i], (int(im.shape[0] * s),
                                                                     int(im.shape[1] * s))))
                batch, (hp, wp) = self._pad_batch(scaled)
                sizes = torch.tensor([[im.shape[1], im.shape[0]] for im in scaled],
                                     dtype=torch.int32, device=self.device)
                lbl = None
                if with_labels:
                    lbl_np = np.zeros((len(scaled), hp, wp), np.int32)
                    for i, im in enumerate(scaled):
                        lbl_np[i, : im.shape[0], : im.shape[1]] = _resize_labels_nearest(
                            label_maps[i], im.shape[:2])
                    lbl = torch.from_numpy(lbl_np).to(self.device)
                packed = self._run_packed(batch, sizes, lbl)  # one fetch per batch and device
                c = packed.shape[-1] - (5 if with_labels else 4)
                for i, im in enumerate(images):
                    if not act[i]:
                        continue
                    sh, sw = scaled[i].shape[:2]
                    xy = packed[i, :, 0:2]
                    v = (packed[i, :, 3 + c] > 0.5) & (xy[:, 0] < sw) & (xy[:, 1] < sh)
                    pts = xy[v]
                    if s != 1.0:
                        # Back to the input resolution (the reference multiplies
                        # by W/nw, nets/extractor.py:214-215).
                        pts = pts * np.array([im.shape[1] / sw, im.shape[0] / sh], np.float32)
                    lb = packed[i, :, 4 + c][v].astype(np.int32) if with_labels else None
                    parts[i].append((pts, packed[i, :, 3:3 + c][v], packed[i, :, 2][v], lb))

            out = []
            for i, im in enumerate(images):
                kp, de, sc = (np.concatenate([p[j] for p in parts[i]]) for j in range(3))
                lb = np.concatenate([p[3] for p in parts[i]]) if with_labels else None
                if lb is not None:
                    # The cross-scale merge keeps the labelled-first invariant.
                    boost = (sc.max() + 1.0) if sc.size else 1.0
                    order = np.argsort(-(sc + boost * (lb > 0)))[: cfg.max_keypoints]
                else:
                    order = np.argsort(-sc)[: cfg.max_keypoints]
                out.append(ImageFeatures(kp[order], de[order], sc[order],
                                         np.array([im.shape[1], im.shape[0]]),
                                         lb[order] if lb is not None else None))
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
                         skip_existing: bool = True, mask_dir=None,
                         mask_suffix: str = ".png") -> int:
        """Extract `names` (paths relative to `image_dir`) into `store`;
        existing groups are skipped. The work list is grouped by padded
        bucket first, then chunked into `batch_size` batches whose batch
        dim is padded to a power of two with 1×1 dummies. `mask_dir`: a
        directory of semantic-mask images at the same relative paths with
        the suffix `mask_suffix`; extraction is then labelled-first and a
        ``labels`` dataset is stored per image (for the NNML matcher).
        Returns the number of images extracted."""
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
                n_pad = min(cfg.batch_size, _pow2_ceil(len(chunk))) - len(chunk)
                images = [im for im, _ in loaded] + [np.zeros((1, 1, 3), np.float32)] * n_pad
                lmaps = None
                if mask_dir is not None:
                    lmaps = [load_label_map((Path(mask_dir) / n).with_suffix(mask_suffix))
                             for n in chunk] + [np.zeros((1, 1), np.int32)] * n_pad
                feats = self.extract_batch(images, lmaps)[: len(chunk)]
                for n, f, (im, (w0, h0)) in zip(chunk, feats, loaded):
                    scale = np.array([w0 / im.shape[1], h0 / im.shape[0]], np.float32)
                    store.write(n, ImageFeatures(
                        (f.keypoints + 0.5) * scale - 0.5, f.descriptors, f.scores,
                        np.array([w0, h0]), f.labels), as_half=cfg.as_half)
                    count += 1
        return count
