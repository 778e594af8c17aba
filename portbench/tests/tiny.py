"""Tiny cells of the benchmark for CPU tests: the manifest's cells with
their sizes cut so that a run takes seconds on the CPU (the plain
versions of the kernels run there)."""

from __future__ import annotations

import copy
import io
import json
import time

from portbench import harness
from portbench.run import run_cell


def serve_cell(name: str = "aachen-serve-c4", kp: int = 256, c: int = 32):
    cell = harness.resolve(harness.load_manifest(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["map"].update(n_db=40, n_queries=30, keypoints=kp, descriptor_dim=c, width=640,
                              height=480, focal=800.0, points_per_db_image=8)
    loc = cell.config["localizer"]
    loc.update(retrieval_topk=min(loc["retrieval_topk"], 8), covisibility_frame=8,
               max_keypoints=kp, pnp_pad_floor=64, db_cache_images=12, num_hypotheses=128,
               inlier_thresh=min(loc["inlier_thresh"], 20))
    cell.mix = dict(cell.mix, check_requests=3)
    return cell


def extract_cell(name: str = "aachen-extract-r1600"):
    cell = harness.resolve(harness.load_manifest(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["extraction"].update(max_keypoints=64, bf16=False)
    cell.mix = dict(cell.mix, height=96, width=128, batch_images=2, pool_images=4,
                    check_images=2)
    return cell


def run_line(cell, seed: int = 2**33 + 5, seconds: float = 2.0, trace: bool = False):
    """Run a cell on the CPU and return the parsed result line, as printed."""
    result, compared = run_cell(cell, seed, seconds, trace, "cpu", time.time())
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, compared, out, err)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return json.loads(lines[0])
