"""Incremental-SfM CLI (``python -m sfd2_torch.cli.reconstruction``).

Port of ``sfd2_tpu/cli/reconstruction.py``. Capability parity:
``hloc/reconstruction.py`` — from-scratch mapping from features + matches
with known per-image intrinsics (single shared camera via
--camera "MODEL w h params…"). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from sfd2_torch.geometry.cameras import Camera
from sfd2_torch.io.colmap_model import write_model
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.io.pairs import read_pairs
from sfd2_torch.sfm.reconstruction import ReconstructionConfig, incremental_reconstruction
from sfd2_torch.sfm.stats import format_stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sfm_dir", type=Path, required=True)
    parser.add_argument("--features", type=Path, required=True)
    parser.add_argument("--matches", type=Path, required=True)
    parser.add_argument("--pairs", type=Path, required=True)
    parser.add_argument("--camera", required=True,
                        help='e.g. "PINHOLE 640 480 500 500 320 240"')
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    parts = args.camera.split(" ")
    cam = Camera(1, parts[0], int(parts[1]), int(parts[2]), np.array(parts[3:], np.float64))
    pairs = read_pairs(args.pairs)
    names = sorted({n for p in pairs for n in p})
    with FeatureStore(args.features, "r") as fs, MatchStore(args.matches, "r") as ms:
        cams, images, points, stats = incremental_reconstruction(
            fs, ms, pairs, {n: cam for n in names}, ReconstructionConfig(), device=args.device)
    write_model(cams, images, points, args.sfm_dir, ext=".bin")
    logging.info("\n%s", format_stats(stats))


if __name__ == "__main__":
    main()
