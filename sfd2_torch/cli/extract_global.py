"""Global retrieval-descriptor extraction CLI
(``python -m sfd2_torch.cli.extract_global``).

Port of ``sfd2_tpu/cli/extract_global.py`` (``hloc/extract_features.py``
with the ``dir`` conf): one global descriptor per image, written as the
``.npz`` (names[], descriptors[N, D]) that ``python -m
sfd2_torch.cli.pairs_from retrieval`` reads. Adds ``--device`` (default
``cuda``) and ``--weights`` (a reference DIR ``.pth``, torchvision-named
ResNet plus ``whiten``, read through ``convert_dir_resnet``; seeded random
ResNet-101 weights without it).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from sfd2_torch.pipeline.extract import load_image
from sfd2_torch.pipeline.extractors import GLOBAL_EXTRACTOR_REGISTRY, reference_state_dict
from sfd2_torch.utils.device import resolve_device


def list_images(root: Path):
    exts = {".jpg", ".jpeg", ".png", ".bmp"}
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.suffix.lower() in exts)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True,
                        help=".npz with names[] and descriptors[N,D]")
    parser.add_argument("--extractor", default="dir", choices=sorted(GLOBAL_EXTRACTOR_REGISTRY))
    parser.add_argument("--image_list", type=Path, default=None,
                        help="optional file of relative image paths")
    parser.add_argument("--resize_max", type=int, default=1024)
    parser.add_argument("--weights", type=Path, default=None,
                        help="reference DIR .pth checkpoint (seeded random weights if absent)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    state = reference_state_dict(args.extractor, args.weights) if args.weights else None
    extract = GLOBAL_EXTRACTOR_REGISTRY[args.extractor](
        state_dict=state, device=resolve_device(args.device), seed=args.seed)
    names = ([ln.strip() for ln in args.image_list.read_text().splitlines() if ln.strip()]
             if args.image_list else list_images(args.image_dir))
    descs = []
    for n in names:
        img, _ = load_image(args.image_dir / n, args.resize_max)
        descs.append(extract(img))
    args.output.parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.output, names=np.array(names), descriptors=np.stack(descs))
    logging.info("wrote %d global descriptors → %s", len(names), args.output)
    return len(names)


if __name__ == "__main__":
    main()
