"""Map-building CLI (``python -m sfd2_torch.cli.triangulation``).

Port of ``sfd2_tpu/cli/triangulation.py``. Capability parity:
``hloc/triangulation.py``'s argparse main — build a 3D model from a
reference model (poses), features and matches; writes the COLMAP model +
statics.txt and optionally a COLMAP database export. Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from sfd2_torch.io.database import export_to_database
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.io.pairs import read_pairs
from sfd2_torch.sfm.pipeline import TriangulationConfig, triangulate_map
from sfd2_torch.sfm.stats import format_stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sfm_dir", type=Path, required=True)
    parser.add_argument("--reference_sfm_model", type=Path, required=True)
    parser.add_argument("--pairs", type=Path, required=True)
    parser.add_argument("--features", type=Path, required=True)
    parser.add_argument("--matches", type=Path, required=True)
    parser.add_argument("--max_reproj_error", type=float, default=4.0)
    parser.add_argument("--min_tri_angle", type=float, default=1.5)
    parser.add_argument("--export_database", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    pairs = read_pairs(args.pairs)
    cfg = TriangulationConfig(max_reproj_error=args.max_reproj_error,
                              min_tri_angle_deg=args.min_tri_angle)
    with FeatureStore(args.features, "r") as fs, MatchStore(args.matches, "r") as ms:
        cams, images, points, stats = triangulate_map(
            args.reference_sfm_model, fs, ms, pairs, args.sfm_dir, cfg, device=args.device)
        if args.export_database:
            export_to_database(cams, images, fs, args.sfm_dir / "database.db")
    logging.info("\n%s", format_stats(stats))


if __name__ == "__main__":
    main()
