"""Serve cells (float32 matching and pose): TF32. Over the same sample of
queries a run checks, each query's matches against its retrieved DB
images and its pose (Gauss-Newton from the TF32 matches), every product
of TF32 operands summed in float32."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.localize import correspondences, reference_pose
from portbench.reference.match import bank_valid, mutual_matches, similarities
from portbench.scene import make_scene, map_arrays, retrieval, sub_seed


CONTROLS = ("tf32",)


def control(cell, seed: int, device, which: str) -> dict:
    """The compared numbers of TF32 answers to the first queries of the seed's order."""
    serve = cell.driver()
    loc = cell.config["localizer"]
    size = serve.scene_size(cell.config)
    scene = make_scene(size, seed, device)
    prow, point_xyz, track_len = map_arrays(scene)
    retr = retrieval(scene, loc["retrieval_topk"])
    order = np.random.default_rng(sub_seed(seed, 3)).permutation(size.n_q)
    dev = torch.device(device)
    answered, replies, recorded = [], {}, {}
    for i, q in enumerate(order[:cell.mix["check_requests"] + 1]):
        q, rows = int(q), retr[q]
        qd = torch.from_numpy(np.ascontiguousarray(scene.q_desc[q].T)).to(dev)
        qv = torch.arange(size.kp, device=dev) < int(scene.q_nv[q])
        ms = []
        for lo in range(0, len(rows), serve.BANK_BLOCK):
            r = rows[lo:lo + serve.BANK_BLOCK]
            banks = torch.from_numpy(np.ascontiguousarray(
                scene.db_desc[r].transpose(0, 2, 1))).to(dev)
            bv = torch.from_numpy(bank_valid(scene.db_nv[r], prow[r])).to(dev)
            ms.append(mutual_matches(similarities(qd, banks, qv, bv, "tf32")).cpu().numpy())
        recorded[serve.query_name(q)] = [(list(rows + 1), np.concatenate(ms).astype(np.int32))]
        uv, xyz = correspondences(scene.q_desc[q], scene.q_nv[q], scene.q_kp[q],
                                  scene.db_desc[rows], scene.db_nv[rows], prow[rows],
                                  point_xyz, track_len, loc["obs_thresh"], "tf32", device)
        qvec, tvec, _ = reference_pose(scene.q_q[q], scene.q_t[q], uv, xyz, size.cam_params,
                                       loc["opt_thresh"], "tf32", device)
        replies[i] = {"qvec": np.asarray(qvec).tolist(), "tvec": np.asarray(tvec).tolist()}
        answered.append((i, q, 0.0, 1.0, 200, b""))
    ctx = dict(cell=cell, seed=seed, device=device)
    return serve.verify(ctx, scene, prow, point_xyz, track_len, retr, answered, replies,
                        recorded)
