"""NVM → COLMAP conversion CLI (``python -m sfd2_torch.cli.colmap_from_nvm``).

Port of ``sfd2_tpu/cli/colmap_from_nvm.py`` (``hloc/colmap_from_nvm.py``):
a VisualSfM NVM_V3 model and an intrinsics list become a COLMAP model.
``--database`` takes image and camera ids from a COLMAP database so the
model lines up with the features imported there. Host only.
"""

from __future__ import annotations

import argparse
import logging
import sqlite3
from pathlib import Path

from sfd2_torch.io.colmap_model import write_model
from sfd2_torch.io.nvm import read_nvm_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nvm", type=Path, required=True)
    parser.add_argument("--intrinsics", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--database", type=Path, default=None,
                        help="COLMAP database.db to source image/camera ids")
    parser.add_argument("--skip_points", action="store_true")
    parser.add_argument("--ext", default=".bin", choices=(".bin", ".txt"))
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    image_ids = camera_ids = None
    if args.database:
        with sqlite3.connect(str(args.database)) as db:
            rows = db.execute("SELECT image_id, name, camera_id FROM images").fetchall()
        image_ids = {name: iid for iid, name, _ in rows}
        camera_ids = {name: cid for _, name, cid in rows}
    cameras, images, points = read_nvm_model(args.nvm, args.intrinsics, image_ids=image_ids,
                                              camera_ids=camera_ids,
                                              skip_points=args.skip_points)
    args.output.mkdir(parents=True, exist_ok=True)
    write_model(cameras, images, points, args.output, ext=args.ext)
    logging.info("wrote %d cameras, %d images, %d points → %s", len(cameras), len(images),
                 len(points), args.output)


if __name__ == "__main__":
    main()
