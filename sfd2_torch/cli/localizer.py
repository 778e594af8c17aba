"""Localization CLI (``python -m sfd2_torch.cli.localizer``).

Port of ``sfd2_tpu/cli/localizer.py`` (``it_loc/localizer.py``'s argparse
main with the benchmark scripts' knobs, ``test_aachenv_1_1:59-80``), plus
``--device`` (default ``cuda``). ``--profile_dir`` writes a
``torch.profiler`` Chrome trace of the query loop there.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
from pathlib import Path

from sfd2_torch.localization.engine import LocalizerConfig
from sfd2_torch.localization.localizer import LocalizerRun, run
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import trace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="aachen_v1.1",
                        choices=["aachen", "aachen_v1.1", "robotcar", "ecmu"])
    parser.add_argument("--reference_sfm", type=Path, required=True)
    parser.add_argument("--queries", type=Path, required=True)
    parser.add_argument("--retrieval", type=Path, required=True)
    parser.add_argument("--features", type=Path, required=True)
    parser.add_argument("--results", type=Path, required=True)
    parser.add_argument("--gt_pose_fn", type=Path, default=None)
    parser.add_argument("--init_type", default="sng", choices=["sng", "clu"])
    parser.add_argument("--ransac_thresh", type=float, default=15.0)
    parser.add_argument("--opt_thresh", type=float, default=15.0)
    parser.add_argument("--inlier_thresh", type=int, default=10)
    parser.add_argument("--covisibility_frame", type=int, default=50)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--radius", type=float, default=30.0)
    parser.add_argument("--obs_thresh", type=int, default=3)
    parser.add_argument("--opt_type", default="clurefobs")
    parser.add_argument("--no_covisible_opt", action="store_true")
    parser.add_argument("--max_keypoints", type=int, default=4096)
    parser.add_argument("--query_prefix", default="")
    parser.add_argument("--db_prefix", default="")
    parser.add_argument("--profile_dir", type=Path, default=None,
                        help="write a torch.profiler Chrome trace of the query loop here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    run_cfg = LocalizerRun(
        dataset=args.dataset, init_type=args.init_type,
        config=LocalizerConfig(
            ransac_thresh=args.ransac_thresh, opt_thresh=args.opt_thresh,
            inlier_thresh=args.inlier_thresh, covisibility_frame=args.covisibility_frame,
            iters=args.iters, radius=args.radius, obs_thresh=args.obs_thresh,
            opt_type=args.opt_type, do_covisibility_opt=not args.no_covisible_opt,
            max_keypoints=args.max_keypoints),
        query_prefix=args.query_prefix, db_prefix=args.db_prefix)
    ctx = trace(args.profile_dir, device) if args.profile_dir else contextlib.nullcontext()
    with ctx:
        stats = run(args.dataset, args.reference_sfm, args.queries, args.retrieval,
                    args.features, args.results, run_cfg, args.gt_pose_fn, device=device)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
