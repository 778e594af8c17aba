"""Pair matching CLI (``python -m sfd2_torch.cli.match_features``).

Port of ``sfd2_tpu/cli/match_features.py``. Capability parity:
``hloc/match_features.py`` — pair-list or exhaustive matching into an HDF5
match store, resumable. Runs on the card unless ``--device cpu``; with
``--max_keypoints`` of 68,992 or more (C = 128) NNM runs on kernel K5 and
NNR on K6 (``ops/matching.py::tiled_route``), below that on K2 and K4.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.io.pairs import read_pairs
from sfd2_torch.pipeline.match import MATCHER_CONFS, MatchConfig, match_pairs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--features", type=Path, required=True)
    parser.add_argument("--export_fn", type=Path, required=True)
    parser.add_argument("--pairs", type=Path, default=None)
    parser.add_argument("--exhaustive", action="store_true")
    parser.add_argument("--conf", default="NNM", choices=MATCHER_CONFS)
    parser.add_argument("--max_keypoints", type=int, default=4096)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    with FeatureStore(args.features, "r") as fs:
        if args.exhaustive:
            names = sorted(fs.keys())
            pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
        else:
            pairs = read_pairs(args.pairs)
        args.export_fn.parent.mkdir(parents=True, exist_ok=True)
        with MatchStore(args.export_fn, "a") as ms:
            cfg = MatchConfig(matcher=args.conf, max_keypoints=args.max_keypoints,
                              batch_size=args.batch_size)
            n = match_pairs(fs, pairs, ms, cfg, device=args.device)
    logging.info("matched %d pairs → %s", n, args.export_fn)


if __name__ == "__main__":
    main()
