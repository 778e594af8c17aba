"""Feature-extraction CLI (``python -m sfd2_torch.cli.extract_features``).

Port of ``sfd2_tpu/cli/extract_features.py`` (``extract_localization.py``:
conf registry, image-list input, HDF5 export, resume) plus ``--device``
(default ``cuda``). ``--extractor sfd2`` runs the batched ``Extractor``;
the other registry names (``pipeline/extractors.py``: superpoint, r2d2,
d2net, caps, sgd2, sift) run the hloc-style baseline loop, one image at a
time at the conf's ``resize_max``, ``max_keypoints`` and
``conf_threshold``. ``--weights`` takes the extractor's reference ``.pth``
or, for sfd2, a checkpoint of the port's trainer (``last.ckpt`` /
``best.ckpt``: its model entry, the counterpart of the JAX CLI's Flax
``.ckpt`` branch); without it the network gets seeded random weights from
a ``torch.Generator``. The JAX CLI's Flax ``.ckpt`` files are refused:
they need the JAX package. ``sift`` and ``caps`` detect with OpenCV on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import torch

import numpy as np

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.models.convert import convert_checkpoint
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.pipeline.extract import EXTRACTION_CONFS, Extractor, load_image
from sfd2_torch.pipeline.extractors import (EXTRACTOR_REGISTRY, BaselineConfig, dynamic_load,
                                            reference_state_dict)
from sfd2_torch.training.trainer import load_model_state
from sfd2_torch.utils.device import resolve_device


def list_images(image_dir: Path, image_list: Path | None):
    if image_list:
        return [ln.strip() for ln in Path(image_list).read_text().splitlines() if ln.strip()]
    exts = (".jpg", ".jpeg", ".png")
    return sorted(str(p.relative_to(image_dir)) for p in image_dir.rglob("*")
                  if p.suffix.lower() in exts)


def is_torch_archive(path: Path) -> bool:
    """``torch.save`` writes a zip archive; Flax's msgpack is not one."""
    if not path.is_file():
        return False
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def seeded_state_dict(seed: int):
    """A ResSegNetV2 state_dict with random weights from a seeded
    ``torch.Generator`` (PyTorch's default initialisers)."""
    gen = torch.Generator().manual_seed(seed)
    model = ResSegNetV2()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                bound = (1.0 / (m.in_channels // m.groups * m.kernel_size[0]
                                * m.kernel_size[1])) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * bound)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * bound)
    return model.state_dict()


def extract_baseline(args, cfg, device, names) -> int:
    """The baseline plug-in loop of ``hloc/extract_features.py``: per
    image, ``load_image`` at ``resize_max``, the extractor, keypoints back
    to the original resolution as ``(kp + 0.5)·scale − 0.5``, and a store
    write; names already in the store are skipped."""
    state = reference_state_dict(args.extractor, args.weights) if args.weights else None
    extract = dynamic_load(args.extractor, BaselineConfig(max_keypoints=cfg.max_keypoints,
                                                          conf_threshold=cfg.conf_threshold),
                           state_dict=state, device=device, seed=args.seed)
    count = 0
    with FeatureStore(args.export_fn, "a") as store:
        for name in names:
            if name in store:
                continue
            im, (w0, h0) = load_image(Path(args.image_dir) / name, cfg.resize_max)
            f = extract(im)
            scale = np.array([w0 / im.shape[1], h0 / im.shape[0]], np.float32)
            store.write(name, ImageFeatures((f.keypoints + 0.5) * scale - 0.5, f.descriptors,
                                            f.scores, np.array([w0, h0]), f.labels),
                        as_half=cfg.as_half)
            count += 1
    logging.info("extracted %d images → %s", count, args.export_fn)
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--image_list", type=Path, default=None)
    parser.add_argument("--export_fn", type=Path, required=True)
    parser.add_argument("--conf", default="sfd2-n4096-r1600", choices=EXTRACTION_CONFS)
    parser.add_argument("--weights", type=Path, default=None,
                        help="reference torch .pth checkpoint, or for sfd2 a checkpoint of "
                             "sfd2_torch's trainer (seeded random weights if absent)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--as_half", action="store_true",
                        help="store descriptors as float16 (half the disk)")
    parser.add_argument("--mask_dir", type=Path, default=None,
                        help="semantic-mask dir (same relative paths); enables labelled-first "
                             "top-K and per-keypoint labels for NNML "
                             "(nets/extractor.py:240-326)")
    parser.add_argument("--mask_suffix", default=".png")
    parser.add_argument("--extractor", default="sfd2", choices=sorted(EXTRACTOR_REGISTRY),
                        help="extractor name (hloc extract_features parity)")
    parser.add_argument("--bf16", choices=["auto", "on", "off"], default="auto",
                        help="trunk numerics: auto = bfloat16 on CUDA; 'off' for parity runs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.mask_dir is not None and args.extractor != "sfd2":
        parser.error("--mask_dir (semantic labelled-first extraction) is only supported by the "
                     "sfd2 extractor; baseline extractors have no label chain "
                     "(nets/extractor.py:240-326)")
    if args.weights is not None and args.extractor == "sift":
        parser.error("--weights: the sift extractor has no network")
    trained = args.weights is not None and args.weights.suffix != ".pth"
    if trained and (args.extractor != "sfd2" or not is_torch_archive(args.weights)):
        parser.error(f"--weights {args.weights}: only reference .pth checkpoints and, for "
                     "sfd2, checkpoints of sfd2_torch's trainer load here (Flax .ckpt files "
                     "need the JAX package)")
    cfg = EXTRACTION_CONFS[args.conf]
    if args.as_half:
        cfg = dataclasses.replace(cfg, as_half=True)
    if args.bf16 != "auto":
        cfg = dataclasses.replace(cfg, bf16=args.bf16 == "on")
    device = resolve_device(args.device)
    names = list_images(args.image_dir, args.image_list)
    args.export_fn.parent.mkdir(parents=True, exist_ok=True)
    if args.extractor != "sfd2":
        return extract_baseline(args, cfg, device, names)
    if trained:
        state = load_model_state(args.weights)
    else:
        state = convert_checkpoint(args.weights) if args.weights else seeded_state_dict(args.seed)
    extractor = Extractor(state, cfg, device=device)
    with FeatureStore(args.export_fn, "a") as store:
        n = extractor.extract_to_store(args.image_dir, names, store, mask_dir=args.mask_dir,
                                       mask_suffix=args.mask_suffix)
    logging.info("extracted %d images → %s", n, args.export_fn)
    return n


if __name__ == "__main__":
    main()
