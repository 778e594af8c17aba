"""Pair-generation CLI (``python -m sfd2_torch.cli.pairs_from``).

Port of ``sfd2_tpu/cli/pairs_from.py``. Capability parity:
``hloc/pairs_from_covisibility.py``, ``hloc/pairs_from_poses.py`` and
``hloc/pairs_from_retrieval.py`` — merged into one sub-command CLI. The
work is host-side numpy, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from sfd2_torch.io.colmap_model import read_model
from sfd2_torch.io.pairs import write_pairs
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.sfm.pairs import pairs_from_covisibility, pairs_from_poses, pairs_from_retrieval


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="mode", required=True)

    p_cov = sub.add_parser("covisibility")
    p_cov.add_argument("--model", type=Path, required=True)
    p_cov.add_argument("--output", type=Path, required=True)
    p_cov.add_argument("--num_matched", type=int, default=20)

    p_pose = sub.add_parser("poses")
    p_pose.add_argument("--model", type=Path, required=True)
    p_pose.add_argument("--output", type=Path, required=True)
    p_pose.add_argument("--num_matched", type=int, default=20)
    p_pose.add_argument("--rotation_threshold", type=float, default=30.0)

    p_ret = sub.add_parser("retrieval")
    p_ret.add_argument("--query_descriptors", type=Path, required=True,
                       help=".npz with names[] and descriptors[N,D]")
    p_ret.add_argument("--db_descriptors", type=Path, required=True)
    p_ret.add_argument("--output", type=Path, required=True)
    p_ret.add_argument("--num_matched", type=int, default=20)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.mode == "covisibility":
        cams, images, points = read_model(args.model)
        pairs = pairs_from_covisibility(MapIndex(cams, images, points), args.num_matched)
    elif args.mode == "poses":
        _, images, _ = read_model(args.model)
        pairs = pairs_from_poses(images, args.num_matched, args.rotation_threshold)
    else:
        q = np.load(args.query_descriptors, allow_pickle=True)
        db = np.load(args.db_descriptors, allow_pickle=True)
        pairs = pairs_from_retrieval(list(q["names"]), q["descriptors"], list(db["names"]),
                                     db["descriptors"], args.num_matched)
    write_pairs(args.output, pairs)
    logging.info("wrote %d pairs → %s", len(pairs), args.output)


if __name__ == "__main__":
    main()
