"""Feature-extraction CLI (``python -m sfd2_torch.cli.extract_features``).

Port of ``sfd2_tpu/cli/extract_features.py`` (``extract_localization.py``:
conf registry, image-list input, HDF5 export, resume), SFD2 route, plus
``--device`` (default ``cuda``). ``--weights`` takes a reference ``.pth``;
without it the model gets seeded random weights from a
``torch.Generator``. The baseline extractors and the Flax ``.ckpt``
weights of the JAX CLI are not available here.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import torch

from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.models.convert import convert_checkpoint
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.pipeline.extract import EXTRACTION_CONFS, Extractor
from sfd2_torch.utils.device import resolve_device


def list_images(image_dir: Path, image_list: Path | None):
    if image_list:
        return [ln.strip() for ln in Path(image_list).read_text().splitlines() if ln.strip()]
    exts = (".jpg", ".jpeg", ".png")
    return sorted(str(p.relative_to(image_dir)) for p in image_dir.rglob("*")
                  if p.suffix.lower() in exts)


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--image_list", type=Path, default=None)
    parser.add_argument("--export_fn", type=Path, required=True)
    parser.add_argument("--conf", default="sfd2-n4096-r1600", choices=EXTRACTION_CONFS)
    parser.add_argument("--weights", type=Path, default=None,
                        help="reference torch .pth checkpoint (seeded random weights if absent)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--as_half", action="store_true",
                        help="store descriptors as float16 (half the disk)")
    parser.add_argument("--mask_dir", type=Path, default=None,
                        help="semantic-mask dir (same relative paths); enables labelled-first "
                             "top-K and per-keypoint labels for NNML "
                             "(nets/extractor.py:240-326)")
    parser.add_argument("--mask_suffix", default=".png")
    parser.add_argument("--extractor", default="sfd2",
                        help="extractor name; only sfd2 is ported")
    parser.add_argument("--bf16", choices=["auto", "on", "off"], default="auto",
                        help="trunk numerics: auto = bfloat16 on CUDA; 'off' for parity runs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.extractor != "sfd2":
        parser.error(f"--extractor {args.extractor}: only sfd2 is ported to sfd2_torch; the "
                     "baseline extractors are ROADMAP.md item 9")
    if args.weights is not None and args.weights.suffix != ".pth":
        parser.error(f"--weights {args.weights}: only reference .pth checkpoints load here "
                     "(Flax .ckpt files need the JAX package)")
    cfg = EXTRACTION_CONFS[args.conf]
    if args.as_half:
        cfg = dataclasses.replace(cfg, as_half=True)
    if args.bf16 != "auto":
        cfg = dataclasses.replace(cfg, bf16=args.bf16 == "on")
    state = convert_checkpoint(args.weights) if args.weights else seeded_state_dict(args.seed)
    extractor = Extractor(state, cfg, device=resolve_device(args.device))
    names = list_images(args.image_dir, args.image_list)
    args.export_fn.parent.mkdir(parents=True, exist_ok=True)
    with FeatureStore(args.export_fn, "a") as store:
        n = extractor.extract_to_store(args.image_dir, names, store, mask_dir=args.mask_dir,
                                       mask_suffix=args.mask_suffix)
    logging.info("extracted %d images → %s", n, args.export_fn)
    return n


if __name__ == "__main__":
    main()
