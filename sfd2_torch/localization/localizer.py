"""Benchmark localizer front end (``it_loc/localizer.py`` parity).

Port of ``sfd2_tpu/localization/localizer.py``: ground-truth pose loading
for the success counters at (0.25 m, 2°), (0.5 m, 5°) and (5 m, 10°),
retrieval parsing, singleton ('sng') or covisibility-clustered ('clu')
candidates per query, per-query localization through
``LocalizationEngine`` (kernel K2 on CUDA), and the output files: the
poses txt (Aachen basename, RobotCar ``rear/<img>``, ECMU raw name), the
``.failed`` list and ``_full.log``. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.colmap_model import read_model
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.io.pairs import (parse_image_lists_with_intrinsics,
                                 parse_img_lists_for_extended_cmu_seasons, parse_retrieval)
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig, QueryResult
from sfd2_torch.sfm.map_index import MapIndex

ERROR_THRESHOLDS = ((0.25, 2.0), (0.5, 5.0), (5.0, 10.0))

logger = logging.getLogger(__name__)


def load_gt_poses(path) -> Dict[str, dict]:
    """'name qw qx qy qz tx ty tz' per line, keyed by basename
    (``it_loc/localizer.py:29-36``)."""
    gt = {}
    for line in Path(path).read_text().splitlines():
        parts = line.strip().split(" ")
        if len(parts) < 8:
            continue
        gt[parts[0].split("/")[-1]] = {"qvec": np.array(parts[1:5], float),
                                       "tvec": np.array(parts[5:8], float)}
    return gt


def result_name(qname: str, dataset: str) -> str:
    if dataset in ("aachen", "aachen_v1.1"):
        return qname.split("/")[-1]
    if dataset == "robotcar":
        parts = qname.split("/")
        return parts[-2] + "/" + parts[-1]
    return qname


@dataclasses.dataclass
class LocalizerRun:
    dataset: str = "aachen_v1.1"
    init_type: str = "sng"  # sng | clu
    config: LocalizerConfig = dataclasses.field(default_factory=LocalizerConfig)
    query_prefix: str = ""  # ECMU query/database name prefixes
    db_prefix: str = ""


def localize_queries(queries: Sequence[Tuple[str, tuple]], retrievals: Dict[str, List[str]],
                     map_index: MapIndex, features: FeatureStore, run_cfg: LocalizerRun,
                     gt_poses: Optional[Dict[str, dict]] = None, device="cuda",
                     engine: Optional[LocalizationEngine] = None):
    """The query loop. Returns (poses, failed, stats, full_log). `engine`
    reuses a warm engine (its banks and CUDA graphs) over the same map."""
    engine = engine or LocalizationEngine(map_index, features, run_cfg.config, device=device)
    name_to_id = map_index.name_to_image_id

    poses: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    failed: List[str] = []
    full_log: List[str] = []
    success = [0, 0, 0]
    n_gt = 0
    t0 = time.time()

    for qname, qinfo in queries:
        # ECMU-style stores key query features under a prefix; fall back to
        # the raw name.
        qkey = qname
        if run_cfg.query_prefix and run_cfg.query_prefix + qname in engine.features:
            qkey = run_cfg.query_prefix + qname
        frame_ids = []
        for c in retrievals.get(qname, []):
            cn = run_cfg.db_prefix + c if run_cfg.db_prefix else c
            if cn not in name_to_id:
                logger.warning("retrieved %s not in database", cn)
                continue
            frame_ids.append(name_to_id[cn])
        if not frame_ids:
            failed.append(qname)
            full_log.append(f"{qname}: no retrieval candidates")
            continue

        if run_cfg.init_type == "sng":
            clusters = [[i] for i in frame_ids]
        else:  # 'clu'
            clusters = map_index.covisibility_clustering(frame_ids)

        try:
            engine.features.read(qkey)
            q_ok = True
        except KeyError:
            q_ok = False
        if not q_ok:
            # Missing or partial query features do not abort the run (the reference
            # would crash on h5py's KeyError, it_loc/localize_cv2.py:677):
            # the query gets the reference's last fallback, the top
            # retrieved frame's pose (:1266-1272), and counts as a miss.
            # Missing DB features propagate from the engine.
            logger.warning("query %s: no features in store", qname)
            top = map_index.images[clusters[0][0]]
            res = QueryResult(np.array(top.qvec), np.array(top.tvec), -1,
                              "missing query features; using top retrieved pose",
                              source="retrieval_fallback")
        else:
            res = engine.localize(qkey, qinfo, clusters)
        poses[qname] = (res.qvec, res.tvec)
        if res.num_inliers < 0:
            failed.append(qname)
        full_log.append(f"{qname}: {res.source} inliers={res.num_inliers}")
        full_log.append(res.log.rstrip())

        key = qname.split("/")[-1]
        if gt_poses and key in gt_poses:
            n_gt += 1
            qe, te = pose_error(res.qvec, res.tvec, gt_poses[key]["qvec"], gt_poses[key]["tvec"])
            for i, (t_th, q_th) in enumerate(ERROR_THRESHOLDS):
                if te <= t_th and qe <= q_th:
                    success[i] += 1

    stats = {"num_queries": len(queries), "num_localized": len(poses),
             "num_failed": len(failed), "elapsed_s": time.time() - t0}
    if n_gt:
        stats["recall"] = [s / n_gt for s in success]
        stats["num_gt"] = n_gt
    return poses, failed, stats, full_log


def write_results(poses: Dict[str, Tuple[np.ndarray, np.ndarray]], failed: Sequence[str],
                  full_log: Sequence[str], results_path, dataset: str):
    results_path = Path(results_path)
    results_path.parent.mkdir(parents=True, exist_ok=True)
    with open(results_path, "w") as f:
        for q, (qvec, tvec) in poses.items():
            qs = " ".join(str(float(v)) for v in qvec)
            ts = " ".join(str(float(v)) for v in tvec)
            f.write(f"{result_name(q, dataset)} {qs} {ts}\n")
    Path(str(results_path) + ".failed").write_text("\n".join(failed) + "\n")
    Path(str(results_path).replace(".txt", "") + "_full.log").write_text(
        "\n".join(full_log) + "\n")


def run(dataset: str, reference_sfm, queries_path, retrieval_path, features_path, results_path,
        run_cfg: Optional[LocalizerRun] = None, gt_pose_path=None, device="cuda"):
    """The CLI's body (``it_loc/localizer.py`` run)."""
    run_cfg = run_cfg or LocalizerRun(dataset=dataset)
    if dataset == "ecmu":
        queries = parse_img_lists_for_extended_cmu_seasons(Path(queries_path))
    else:
        queries = parse_image_lists_with_intrinsics(Path(queries_path))
    retrievals = parse_retrieval(retrieval_path)
    map_index = MapIndex(*read_model(reference_sfm))
    gt = load_gt_poses(gt_pose_path) if gt_pose_path else None
    with FeatureStore(features_path, "r") as fs:
        poses, failed, stats, full_log = localize_queries(queries, retrievals, map_index, fs,
                                                          run_cfg, gt, device=device)
    write_results(poses, failed, full_log, results_path, dataset)
    logger.info("localized %d/%d", stats["num_localized"], stats["num_queries"])
    if "recall" in stats:
        logger.info("recall @ (0.25m,2°)/(0.5m,5°)/(5m,10°): %s",
                    "/".join(f"{100 * r:.1f}" for r in stats["recall"]))
    return stats


def localize_sfm(reference_sfm, queries_path, retrieval_path, features_path, results_path,
                 ransac_thresh: float = 12.0, covisibility_clustering: bool = True,
                 device="cuda"):
    """hloc-style entry point (``hloc/localize_sfm.py``: covisibility
    clustering and per-cluster PnP, no iterative covisibility refinement;
    the reference's own copy of that is dead code, ``:54,67``)."""
    cfg = LocalizerRun(dataset="generic", init_type="clu" if covisibility_clustering else "sng",
                       config=LocalizerConfig(ransac_thresh=ransac_thresh,
                                              do_covisibility_opt=False))
    return run("generic", reference_sfm, queries_path, retrieval_path, features_path,
               results_path, cfg, device=device)
