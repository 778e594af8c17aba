"""Localization serving daemon (``python -m sfd2_torch.cli.serve``).

Port of ``sfd2_tpu/cli/serve.py``: loads the SfM model and the feature
store once, warms the service up (banks, the PnP and refinement graphs),
then serves ``POST /localize`` until stopped. See
``sfd2_torch/serving/server.py`` for the API. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from sfd2_torch.io.colmap_model import read_model
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization.engine import LocalizerConfig
from sfd2_torch.serving.server import LocalizationService, make_server
from sfd2_torch.sfm.map_index import MapIndex


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reference_sfm", type=Path, required=True)
    parser.add_argument("--features", type=Path, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--ransac_thresh", type=float, default=15.0)
    parser.add_argument("--opt_thresh", type=float, default=15.0)
    parser.add_argument("--inlier_thresh", type=int, default=10)
    parser.add_argument("--covisibility_frame", type=int, default=50)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--radius", type=float, default=30.0)
    parser.add_argument("--obs_thresh", type=int, default=3)
    parser.add_argument("--max_keypoints", type=int, default=4096)
    parser.add_argument("--pnp_pad_floor", type=int, default=4096,
                        help="pin PnP and the refinement to one padded size (one graph each)")
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> LocalizerConfig:
    return LocalizerConfig(
        ransac_thresh=args.ransac_thresh, opt_thresh=args.opt_thresh,
        inlier_thresh=args.inlier_thresh, covisibility_frame=args.covisibility_frame,
        iters=args.iters, radius=args.radius, obs_thresh=args.obs_thresh,
        max_keypoints=args.max_keypoints, pnp_pad_floor=args.pnp_pad_floor)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cameras, images, points3d = read_model(args.reference_sfm)
    mi = MapIndex(cameras, images, points3d)
    with FeatureStore(args.features, "r") as fs:
        service = LocalizationService(mi, fs, config_from_args(args), device=args.device)
        if not args.no_warmup:
            logging.info("warmup (banks, PnP and refinement graphs)…")
            logging.info("warmup done in %.1fs", service.warmup())
        server = make_server(service, args.host, args.port)
        logging.info("serving on http://%s:%d (POST /localize)", *server.server_address)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        finally:
            server.server_close()


if __name__ == "__main__":
    main()
