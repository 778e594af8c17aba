"""Training CLI (``python -m sfd2_torch.cli.train``).

Port of ``sfd2_tpu/cli/train.py`` (``train.py``: argparse defaults
overridden by a JSON config file, dataset selection, sampler and loss
construction, the Trainer loop with resume) plus ``--device`` (default
``cuda``). The training pairs come from ``--data_sources`` (the
reference's W/A/S/F/D letter codes, ``training/datasets_aachen.py``), or
``--flow_pair_list`` (lines of ``img1 img2 flow.png mask.png`` under
``--pair_image_root``, ``training/flow_pairs.py``), or ``--image_dirs``
(image folders, concatenated, homography pairs by
``SyntheticPairBuilder``), in that order. ``--segmentor_ckpt`` (an mmseg
UPerNet-ConvNeXt checkpoint) or ``--segmentor_random`` turn on the online
semantic teacher.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from sfd2_torch.training.data import (CatDataset, ImageFolderDataset, PairLoader,
                                      PrecomputedPairBuilder, SyntheticPairBuilder)
from sfd2_torch.training.losses import SegLossConfig
from sfd2_torch.training.sampler import make_sampler
from sfd2_torch.training.train_step import TrainConfig
from sfd2_torch.training.trainer import Trainer, TrainerConfig
from sfd2_torch.utils.config import apply_json_overlay, save_args
from sfd2_torch.utils.device import resolve_device

def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=Path, default=None,
                        help="JSON file overriding any argument")
    parser.add_argument("--image_dirs", nargs="+", default=[])
    parser.add_argument("--flow_pair_list", type=Path, default=None,
                        help="file of 'img1 img2 flow.png mask.png' lines "
                             "(precomputed-flow pairs, e.g. Aachen optical-flow)")
    parser.add_argument("--pair_image_root", type=Path, default=None)
    parser.add_argument("--data_sources", default=None,
                        help="reference W/A/S/F/D letter codes (train.py:45-51) "
                             "over --aachen_root/--web_root/--debug_root")
    parser.add_argument("--aachen_root", type=Path, default=None)
    parser.add_argument("--web_root", type=Path, default=None)
    parser.add_argument("--debug_root", type=Path, default=None)
    parser.add_argument("--save_dir", default="runs/sfd2")
    parser.add_argument("--run_name", default=None)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--iters_per_epoch", type=int, default=4000)
    parser.add_argument("--bs", type=int, default=4)
    parser.add_argument("--R", type=int, default=512, help="training crop size")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--det_weight", type=float, default=1.0)
    parser.add_argument("--score_th", type=float, default=0.001)
    parser.add_argument("--det_loss", default="ce",
                        help="ce|l1|bce|sce ('cel' raises a config-time error pointing at "
                             "the README deviation)")
    parser.add_argument("--sampler", default="ngh2ds",
                        help="ngh2ds|ngh2|full|sub|ngh|farnear (nets/sampler.py family)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--segmentor_ckpt", type=Path, default=None,
                        help="mmseg upernet_convnext checkpoint: the ONLINE semantic teacher "
                             "labels every batch on the device (trainer.py:281-316)")
    parser.add_argument("--segmentor_random", action="store_true",
                        help="online teacher with seeded random weights (smoke runs)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args = apply_json_overlay(args, args.config)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    if args.data_sources:
        from sfd2_torch.training.datasets_aachen import build_data_source

        dataset = build_data_source(args.data_sources, crop=args.R, aachen_root=args.aachen_root,
                                    web_root=args.web_root, debug_root=args.debug_root)
        builder = PrecomputedPairBuilder(crop=args.R)
    elif args.flow_pair_list:
        from sfd2_torch.training.flow_pairs import FlowPairDataset

        entries = [tuple(line.split(" ")[:4])
                   for line in Path(args.flow_pair_list).read_text().splitlines() if line.strip()]
        dataset = FlowPairDataset(args.pair_image_root or Path("."), entries)
        builder = PrecomputedPairBuilder(crop=args.R)
    else:
        datasets = [ImageFolderDataset(d) for d in args.image_dirs]
        if not datasets:
            parser.error("give --data_sources, --flow_pair_list or --image_dirs")
        dataset = datasets[0] if len(datasets) == 1 else CatDataset(datasets)
        builder = SyntheticPairBuilder(crop=args.R)
    loader = PairLoader(dataset, builder, batch_size=args.bs, workers=args.workers,
                        iters_per_epoch=args.iters_per_epoch)
    if args.segmentor_ckpt or args.segmentor_random:
        from sfd2_torch.training.seg_teacher import SegTeacher, SegTeacherLoader

        teacher = (SegTeacher.from_torch_checkpoint(args.segmentor_ckpt, device=device)
                   if args.segmentor_ckpt else SegTeacher(device=device))
        loader = SegTeacherLoader(loader, teacher)
    cfg = TrainerConfig(
        epochs=args.epochs, iters_per_epoch=args.iters_per_epoch, batch_size=args.bs,
        save_dir=args.save_dir, run_name=args.run_name,
        train=TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                          det_weight=args.det_weight, score_th=args.score_th,
                          loss=SegLossConfig(det_loss=args.det_loss),
                          sampler=make_sampler(args.sampler)))
    trainer = Trainer(loader, cfg, device=device)
    save_args(args, trainer.run_dir / "args.json")
    trainer.train(resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
