"""Semantic-label precompute CLI (``python -m sfd2_torch.cli.segment_images``).

Port of ``sfd2_tpu/cli/segment_images.py``: the UPerNet-ConvNeXt
segmentor (``models/upernet.py::Segmentor``, slide or whole-image
inference) over an image folder, one uint8 PNG label map per image
(1-based ADE20k ids, 0 = unlabeled, ``trainer.py:290``) at the image's
relative path under the output folder, for
``training/seg_teacher.py::LabelDirTeacher``. Adds ``--device`` (default
``cuda``) and ``--scale LONGxSHORT`` (off by default, as the JAX CLI):
mmseg's test-pipeline resize, with which the labels are SFD2's teacher's
(``--scale 2048x512``). The network is mmseg's, LayerNorm epsilon 1e-6,
when it loads a ``--checkpoint`` (mmseg's are trained with it) or runs
with ``--scale``; only seeded weights without ``--scale`` keep the JAX
CLI's 1e-5. The work is `segment_folder`, which takes a ``Segmentor``
and sends runs of images of one shape through its ``segment_batch``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from sfd2_torch.utils.image_io import read_image, write_png


def list_images(root: Path):
    exts = {".jpg", ".jpeg", ".png", ".bmp"}
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in exts)


BATCH = 8  # images a segment_batch call


def segment_folder(segmentor, image_dir, out_dir, skip_existing: bool = True) -> int:
    """Label every image under `image_dir` into `out_dir`; an existing
    label map is kept. Consecutive images of one shape go through
    ``segmentor.segment_batch`` together, up to ``BATCH`` a call. Returns
    the number of maps written."""
    image_dir, out_dir = Path(image_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    run: list = []  # (output path, image) of one shape

    def flush():
        nonlocal written
        if run:
            for (out, _), labels in zip(run, segmentor.segment_batch([im for _, im in run])):
                out.parent.mkdir(parents=True, exist_ok=True)
                write_png(out, (labels + 1).astype(np.uint8))
            written += len(run)
            run.clear()

    for p in list_images(image_dir):
        # Mirror the relative path: bare stems collide across folders
        # (db/1000.jpg and sequences/1000.jpg in Aachen layouts).
        out = out_dir / p.relative_to(image_dir).with_suffix(".png")
        if skip_existing and out.exists():
            continue
        try:
            rgb = read_image(p)
        except FileNotFoundError:
            logging.warning("unreadable image %s", p)
            continue
        if run and (rgb.shape != run[0][1].shape or len(run) >= BATCH):
            flush()
        run.append((out, rgb))
    flush()
    return written


def parse_scale(text: str) -> tuple:
    """"2048x512" → (2048, 512)."""
    long, short = (int(v) for v in text.lower().split("x"))
    return long, short


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="mmseg upernet_convnext torch checkpoint; seeded random weights "
                             "if absent (smoke runs only)")
    parser.add_argument("--mode", choices=["slide", "whole"], default="slide",
                        help="slide = shipped test_cfg (512 crop / 341 stride)")
    parser.add_argument("--scale", type=parse_scale, default=None,
                        help="LONGxSHORT: resize each image to fit, keeping its aspect, as "
                             "mmseg's test pipeline (2048x512 for SFD2's teacher); labels "
                             "come back at the image's size. Default: no resize")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from sfd2_torch.models.convnext import MMSEG_LN_EPS
    from sfd2_torch.models.upernet import (ConvNeXtUPerNet, Segmentor, SegmentorConfig,
                                           load_mmseg_state_dict, seeded_segmentor)
    from sfd2_torch.utils.device import resolve_device

    mmseg = args.checkpoint is not None or args.scale is not None
    eps = {"ln_eps": MMSEG_LN_EPS} if mmseg else {}
    if args.checkpoint is not None:
        state = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        model = load_mmseg_state_dict(ConvNeXtUPerNet(**eps), state)
    else:
        logging.warning("no --checkpoint: labeling with RANDOM weights")
        model = seeded_segmentor(**eps)
    seg = Segmentor(model, SegmentorConfig(mode=args.mode, scale=args.scale),
                    device=resolve_device(args.device))
    n = segment_folder(seg, args.image_dir, args.out_dir)
    logging.info("labeled %d images → %s", n, args.out_dir)
    return n


if __name__ == "__main__":
    main()
