"""Benchmark: per-stage device times of the localization pipeline on one
card, an extraction roofline estimate, a kernel exactness self-check on the
card, and an end-to-end ``LocalizationEngine`` wall-clock measurement, as
one JSON line.

Port of ``bench.py``. Prints ONE JSON line, last on stdout:
  {"metric": "localization_pipeline_frames_per_s_per_chip", "value": N, ...}

Headline: frames/s over the north-star pipeline,
  per-frame time = extract + 50 × match + PnP-RANSAC + LM refinement
                 + map BA / ba_frames,
each term the device time of its stage (CUDA-event fenced windows; the
fence cost cancelled by paired-window differencing, ``utils/benchtime.py``).

Stages, registered in ``bench.py``'s order, each measured once at
registration and then in every pass (a stage's time is its minimum over
the windows; ``fps_per_pass`` comes from each complete pass):
  gemm         ``torch.matmul`` chain in the trunk's dtype: the ``mfu``
               denominator, not a kernel of the pipeline
  match        K2 (``ops/cuda_match.py``) over distinct banks [50, 4096, 128]
  extract      ``Extractor``'s device program: K1 (``ops/cuda_stem.py``) →
               ``forward_from_out1c`` → keypoints, on a device-resident batch
  pnp          PnP-RANSAC from ``localization/graphs.py`` (graph · SVD step ·
               graph · SVD step · graph), 1024 hypotheses, threshold 15 px
  refine       5 × LM(2 iterations) on the inliers, captured as one graph
  ba           ``sfm/ba.py``'s LM setup and iteration (``bundle_adjust``'s),
               the iteration captured once at warm-up and replayed 3 times
               per call; K3 (``ops/cuda_gather.py``) runs there
  extract1600  the extract program at [8, 1600, 1216, 3] (card only)
  verify       batched F-RANSAC (``sfm/twoview.py``)
  triang       ``sfm/triangulation.py::triangulate_tracks``
Every graph is captured during a stage's warm call; the passes must
capture none (``graph_captures_in_passes``).

The roofline numerators are counted by hand from the model's convolutions
at the input shape (``extract_cost``): ``mfu`` is the extraction's FLOP rate
over the measured GEMM rate (``bench.py``'s definition), ``mfu_vs_peak`` the
same rate over the H100 SXM's dense bf16 peak of 989 TFLOP/s, and
``extract_membw_frac`` the byte rate over its HBM3 peak of 3.35 TB/s (both
shares only on the card).

Differences from ``bench.py``: no ``vs_baseline``, ``vs_baseline_ref``,
``prev_round_fps``, ``vs_r01`` or ``r01_note`` (they compared TPU files);
``fence_ms`` (a fenced empty launch) replaces ``relay_rtt_ms``; the card's
``device_name`` and ``power_limit_w`` (nvidia-smi); ``matcher`` and
``fused_stem`` name the CUDA paths (``"cuda"``, else ``"plain"`` / ``"off"``);
the exactness check holds the port's contract (K2 and K4: ≥ 99.9 % identical
indices, scores within 1e-5, the f32 matchers being 3×TF32; K3 exact; K1
relative error ≤ 1e-4), and on the CPU, where no kernel runs, reports
``kernels_exact: null``, ``kernel_deltas: "plain"``; stage inputs come from
``np.random.default_rng``, not ``jax.random``; the r1600 input pads
1600 × 1200 to 1216 columns (``pad_multiple`` 64, no TPU bucket). The exit
code is 1 when the line has ``error``, ``partial``, ``stage_errors`` or
``kernels_exact: false``.

Usage (from the repository root):
  python -m sfd2_torch.scripts.bench                     # the card, full shapes
  python -m sfd2_torch.scripts.bench --quick --device cpu
Environment: BENCH_BUDGET_S (default 2400), BENCH_PASSES (3; ``--passes``),
BENCH_E2E / BENCH_EXACT (1), BENCH_QUICK=1 (``--quick``). Attempts are
appended to ``chiprun_out/BENCH_ATTEMPTS_torch.jsonl``; the line is also
written to ``--out`` (default ``chiprun_out/BENCH_torch.json``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from sfd2_torch.cli.extract_features import seeded_state_dict
from sfd2_torch.geometry.cameras import canonicalize_params, project_points
from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization import graphs
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.localization.pnp import _refine_pose_lm
from sfd2_torch.localization.ransac import pnp_ransac
from sfd2_torch.ops.cuda_gather import count_graph_replays, gather_rows_cuda
from sfd2_torch.ops.cuda_match import mutual_nn_match_cuda
from sfd2_torch.ops.cuda_match_ratio import mutual_nn_ratio_match_cuda
from sfd2_torch.ops.cuda_stem import StemWeights, fused_stem_cuda
from sfd2_torch.ops.gather import gather_rows_plain
from sfd2_torch.ops.matching import mutual_nn_match, mutual_nn_ratio_match
from sfd2_torch.ops.stem import PackedStem, fused_stem_apply, repack_stem_params
from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor
from sfd2_torch.sfm.ba import BAProblem, capture_iteration, lm_result, lm_setup
from sfd2_torch.sfm.triangulation import triangulate_tracks
from sfd2_torch.sfm.twoview import verify_fundamental_ransac
from sfd2_torch.utils.benchtime import cuda_fence, measure_rtt, timed_per_item
from sfd2_torch.utils.device import resolve_device
from sfd2_torch.utils.profiling import counter, recording
from sfd2_torch.utils.synth import build_corridor_scene

METRIC = "localization_pipeline_frames_per_s_per_chip"
STAGES = ("extract", "match", "pnp", "refine", "ba")  # the headline's terms
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet, 700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
ATTEMPTS = Path("chiprun_out/BENCH_ATTEMPTS_torch.jsonl")
SEED = 0
KERNELS = {"fused_stem": fused_stem_cuda, "mutual_nn_match": mutual_nn_match_cuda,
           "gather_rows": gather_rows_cuda, "mutual_nn_ratio_match": mutual_nn_ratio_match_cuda}
# Pass-through keys of the line: bench.py's, then the port's own.
PASS_THROUGH = ("fused_stem", "kernel_deltas", "e2e_query_ms", "e2e_recall_025m_2deg",
                "e2e_recall_05m_5deg", "e2e_med_terr_m", "e2e_med_rerr_deg",
                "e2e_qps_sequential", "e2e_qps_pipelined", "e2e_qps_batched",
                "e2e_accept_batched", "e2e_recall_batched", "e2e_pipeline_speedup",
                "e2e_batched_breakdown", "e2e_note", "stage_errors",
                "device_name", "power_limit_w", "gemm_dtype", "peak_mem_mb", "launches",
                "graph_captures_in_passes", "e2e_graphs")


def _append_attempt(record: dict) -> None:
    try:
        record = dict(record, ts=time.time(), iso=time.strftime("%Y-%m-%dT%H:%M:%S"))
        ATTEMPTS.parent.mkdir(parents=True, exist_ok=True)
        with open(ATTEMPTS, "a") as f:
            f.write(json.dumps(record) + "\n")
    except Exception:
        pass


def _compose(shared: dict) -> dict:
    """The emittable line from whatever has been measured so far
    (``bench.py::_compose`` without its TPU-file comparisons)."""
    times = shared.get("times", {})
    n_db = shared.get("n_db", 50)
    have = [s for s in STAGES if s in times]
    stage_s = {
        "extract": times.get("extract"),
        "match": times.get("match", 0.0) * n_db if "match" in times else None,
        "pnp": times.get("pnp"),
        "refine": times.get("refine"),
        "ba": (times.get("ba", 0.0) / shared.get("ba_frames", n_db) if "ba" in times else None),
    }
    frame_time = sum(stage_s[s] for s in have)
    fps = 1.0 / frame_time if frame_time > 0 else 0.0
    complete = len(have) == len(STAGES)

    unit = ("frames/s (1024px extract@4096kp + 50-pair mutual-NN + "
            "PnP-RANSAC + 5-iter LM refine + map-BA/50 frames; device "
            "time, fence/RTT cancelled by paired-window differencing)")
    if not complete:
        unit = (f"frames/s over PARTIAL stages [{'+'.join(have)}] "
                "(run ended early — see error/stage_errors; device time, "
                "fence/RTT cancelled)")
    if shared.get("quick"):
        unit = "QUICK MODE (256px/512kp smoke shapes, NOT the headline) " + unit

    out = {
        "metric": METRIC,
        "value": round(fps, 3),
        "unit": unit,
        "platform": shared.get("platform", "?"),
        "passes_completed": shared.get("passes_completed", 0),
    }
    if not complete:
        out["partial"] = True
        out["stages_measured"] = have
    if shared.get("quick"):
        out["quick"] = True
    fatal = (shared.get("stage_errors") or {}).get("fatal")
    if fatal:
        out["error"] = fatal

    for s in have:
        key = {"match": "match50_ms"}.get(s, f"{s}_ms")
        val = stage_s[s] if s != "ba" else times["ba"]
        out[key] = round(val * 1e3, 2)
    if "ba" in have:
        out["ba_ms_per_frame"] = round(stage_s["ba"] * 1e3, 3)

    on_card = shared.get("platform") == "cuda"
    ex_flops = shared.get("extract_flops", 0.0)
    ex_bytes = shared.get("extract_bytes", 0.0)
    if "gemm" in times and shared.get("gemm_flops_total"):
        gemm_rate = shared["gemm_flops_total"] / times["gemm"]
        out["measured_gemm_tflops"] = round(gemm_rate / 1e12, 1)
        if ex_flops and "extract" in times:
            out["extract_gflops"] = round(ex_flops / shared["ex_batch"] / 1e9, 1)
            out["mfu"] = round((ex_flops / shared["ex_batch"]) / times["extract"] / gemm_rate, 3)
        if ex_bytes and "extract" in times:
            gbs = ex_bytes / shared["ex_batch"] / times["extract"] / 1e9
            out["extract_hbm_gb_per_s"] = round(gbs, 1)
            if on_card:  # the byte rate's share of the H100's HBM3 peak
                out["extract_membw_frac"] = round(gbs * 1e9 / PEAK_HBM_BYTES, 3)
    if on_card and ex_flops and "extract" in times:
        out["mfu_vs_peak"] = round(
            (ex_flops / shared["ex_batch"]) / times["extract"] / PEAK_BF16_FLOPS, 3)
    if "fence" in shared:
        out["fence_ms"] = round(shared["fence"] * 1e3, 4)
    if "matcher" in shared:
        out["matcher"] = shared["matcher"]

    if "extract1600" in times:
        out["extract1600_ms"] = round(times["extract1600"] * 1e3, 2)
        if complete:
            frame_1600 = frame_time - stage_s["extract"] + times["extract1600"]
            out["fps_1600"] = round(1.0 / frame_1600, 3)
            out["fps_1600_note"] = ("Aachen production config: 1600x1200 "
                                    "extract@4096kp + same match/pnp/"
                                    "refine/ba terms")
    if "verify" in times:
        out["verify_pair_ms"] = round(times["verify"] * 1e3, 3)
        out["verify_pairs_per_s"] = round(1.0 / times["verify"], 1)
    if "triang" in times:
        out["triang_pt_us"] = round(times["triang"] * 1e6, 3)
        out["triang_pts_per_s"] = round(1.0 / times["triang"], 1)

    fps_passes = []
    for tp in shared.get("times_by_pass") or []:
        if all(s in tp for s in STAGES):
            ft = (tp["extract"] + tp["match"] * n_db + tp["pnp"]
                  + tp["refine"] + tp["ba"] / shared.get("ba_frames", n_db))
            fps_passes.append(round(1.0 / ft, 3))
    if fps_passes:
        out["fps_per_pass"] = fps_passes
        out["fps_median_passes"] = round(float(np.median(fps_passes)), 3)
        if len(fps_passes) > 1 and max(fps_passes) > 0:
            out["fps_spread_pct"] = round(
                100.0 * (max(fps_passes) - min(fps_passes)) / max(fps_passes), 1)

    if "kernels_exact" in shared:  # null on the CPU: no kernel ran
        out["kernels_exact"] = shared["kernels_exact"]
    for k in PASS_THROUGH:
        if shared.get(k) is not None and shared.get(k) != {}:
            out[k] = shared[k]
    return out


def failed(line: dict) -> bool:
    """A line that measured less than a whole run: exit code 1."""
    return bool(line.get("error") or line.get("partial") or line.get("stage_errors")
                or line.get("kernels_exact") is False)


# ---------------------------------------------------------------------------
# stage inputs
# ---------------------------------------------------------------------------


class Shapes(NamedTuple):
    """``bench.py``'s two branches: its accelerator shapes (``full``) and
    the shapes of its CPU or quick run."""

    hw: int  # extraction images hw × hw
    k: int  # keypoints per image
    ex_batch: int
    match_chunk: int  # DB banks per match call
    gemm_n: int
    gemm_reps: int
    ba_points: int
    ba_obs_per_cam: int
    verify_matches: int
    verify_hyp: int
    verify_pairs: int
    triang_tracks: int
    r1600: bool


FULL = Shapes(1024, 4096, 16, 50, 4096, 8, 8192, 1024, 1024, 2048, 16, 8192, True)
SMALL = Shapes(256, 512, 1, 10, 512, 1, 1024, 128, 128, 128, 2, 512, False)
C = 128  # descriptor width
N_DB = 50  # candidate DB frames per query (NetVLAD top-50), BA's cameras
N_CORR, N_HYP = 2048, 1024  # PnP correspondences and hypotheses
R1600 = (8, 1600, 1200)  # batch, H, W of the Aachen production extraction
CAM = ("SIMPLE_RADIAL", [1200.0, 800.0, 600.0, 0.0])


def _project(pts: np.ndarray, qvec, tvec, cam8: np.ndarray) -> np.ndarray:
    """Pixels of world points [..., N, 3] (float32 arithmetic, as the JAX
    bench projects on the device)."""
    xy, _ = project_points(*(torch.as_tensor(np.asarray(a, np.float32))
                             for a in (pts, qvec, tvec, cam8)))
    return xy.numpy()


def _unit(rng: np.random.Generator, shape) -> np.ndarray:
    d = rng.standard_normal(shape, dtype=np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def stage_inputs(shapes: Shapes, seed: int = SEED) -> dict:
    """Every stage's input as numpy arrays drawn from
    ``np.random.default_rng(seed)``, at ``bench.py``'s shapes and
    distributions (``bench.py:306-633``)."""
    rng = np.random.default_rng(seed)
    s, inp = shapes, {}
    cam8 = canonicalize_params(*CAM).astype(np.float32)
    inp["cam8"] = cam8
    inp["gemm_a"] = rng.standard_normal((s.gemm_n, s.gemm_n), dtype=np.float32)
    inp["gemm_b"] = rng.standard_normal((s.gemm_n, s.gemm_n), dtype=np.float32)
    inp["match_q"] = _unit(rng, (s.match_chunk, s.k, C))
    inp["match_db"] = _unit(rng, (s.match_chunk, s.k, C))
    inp["images"] = rng.integers(0, 256, (s.ex_batch, s.hw, s.hw, 3), dtype=np.uint8)

    # PnP: one query, 2048 correspondences, identity pose, 1 px noise.
    pts = np.stack([rng.uniform(-5, 5, N_CORR), rng.uniform(-4, 4, N_CORR),
                    rng.uniform(8, 16, N_CORR)], 1).astype(np.float32)
    xy = _project(pts, [1.0, 0, 0, 0], np.zeros(3), cam8)
    inp["pnp_xy"] = (xy + rng.standard_normal(xy.shape)).astype(np.float32)
    inp["pnp_pts"] = pts
    inp["pnp_valid"] = np.ones(N_CORR, bool)

    # Map BA: 50 cameras along x, cameras 0 and 1 fixed, 0.5 px observation
    # noise, points perturbed by 0.05.
    n_pts, n_obs = s.ba_points, N_DB * s.ba_obs_per_cam
    ba_pts = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-6, 6, n_pts),
                       rng.uniform(10, 25, n_pts)], 1).astype(np.float32)
    obs_cam = np.repeat(np.arange(N_DB, dtype=np.int32), s.ba_obs_per_cam)
    obs_pt = rng.integers(0, n_pts, n_obs).astype(np.int32)
    cam_t = np.stack([np.linspace(-5, 5, N_DB), np.zeros(N_DB), np.zeros(N_DB)],
                     1).astype(np.float32)
    qvecs = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (N_DB, 1))
    obs_xy = _project(ba_pts[obs_pt][:, None], qvecs[obs_cam], cam_t[obs_cam], cam8)[:, 0]
    fixed = np.zeros(N_DB, bool)
    fixed[:2] = True
    inp["ba"] = dict(
        obs_xy=(obs_xy + rng.standard_normal((n_obs, 2)) * 0.5).astype(np.float32),
        obs_cam=obs_cam, obs_point=obs_pt, obs_w=np.ones(n_obs, np.float32), qvecs=qvecs,
        tvecs=cam_t, cam_params=np.tile(cam8[None], (N_DB, 1)),
        points=(ba_pts + rng.standard_normal(ba_pts.shape) * 0.05).astype(np.float32),
        fixed_cams=fixed)

    # Two-view verification: pairs of 1024 matches, 30 % outliers, 85 % valid.
    vb, n_m = s.verify_pairs, s.verify_matches
    vpts = np.stack([rng.uniform(-5, 5, (vb, n_m)), rng.uniform(-4, 4, (vb, n_m)),
                     rng.uniform(8, 16, (vb, n_m))], -1).astype(np.float32)
    vxy1 = _project(vpts, [1.0, 0, 0, 0], np.zeros(3), cam8)
    vxy2 = _project(vpts, [0.9995, 0.0, 0.0312, 0.0], [0.8, 0.05, 0.0], cam8)
    vxy2 = vxy2 + rng.standard_normal(vxy2.shape) * 0.6
    outlier = rng.uniform(size=(vb, n_m)) < 0.3
    rxy = np.stack([rng.uniform(0, 2400, (vb, n_m)), rng.uniform(0, 1600, (vb, n_m))], -1)
    inp["verify_xy1"] = vxy1.astype(np.float32)
    inp["verify_xy2"] = np.where(outlier[..., None], rxy, vxy2).astype(np.float32)
    inp["verify_valid"] = rng.uniform(size=(vb, n_m)) < 0.85

    # Triangulation: tracks of 8 views along x, 75 % observed, the first two always.
    p_tr, t_tr = s.triang_tracks, 8
    tpts = np.stack([rng.uniform(-8, 8, p_tr), rng.uniform(-6, 6, p_tr),
                     rng.uniform(10, 25, p_tr)], 1).astype(np.float32)
    tqv = np.tile(np.array([1.0, 0, 0, 0], np.float32), (p_tr, t_tr, 1))
    ttv = np.tile(np.stack([np.linspace(-4, 4, t_tr), np.zeros(t_tr), np.zeros(t_tr)],
                           1)[None].astype(np.float32), (p_tr, 1, 1))
    tcams = np.tile(cam8[None, None], (p_tr, t_tr, 1))
    toxy = _project(np.repeat(tpts[:, None, None], t_tr, 1), tqv, ttv, tcams)[:, :, 0]
    tmask = rng.uniform(size=(p_tr, t_tr)) < 0.75
    tmask[:, :2] = True
    inp["triang"] = dict(obs_xy=(toxy + rng.standard_normal(toxy.shape) * 0.4).astype(np.float32),
                         obs_mask=tmask, qvecs=tqv, tvecs=ttv, cam_params=tcams)

    if s.r1600:  # 1600 × 1200 images padded to whole multiples of 64 (1216 columns)
        b, h, w = R1600
        imgs = np.zeros((b, h, -(-w // 64) * 64, 3), np.uint8)
        imgs[:, :, :w] = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        inp["images1600"] = imgs
    return inp


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------


class Stage(NamedTuple):
    """fn() launches one call; items: work items per call; inner: calls in
    the short window of ``timed_per_item``."""

    name: str
    fn: Callable
    items: int
    inner: int


def _t(a, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def gemm_stage(inp: dict, dev, dtype, reps: int) -> Stage:
    a, b = _t(inp["gemm_a"], dev, dtype), _t(inp["gemm_b"], dev, dtype)

    def gemm():
        x = a
        for _ in range(reps):
            x = torch.matmul(x, b)
        return x

    return Stage("gemm", gemm, 1, 8)


def match_stage(inp: dict, dev) -> Stage:
    """K2 over distinct f32 banks, no validity masks."""
    q, db = _t(inp["match_q"], dev), _t(inp["match_db"], dev)
    return Stage("match", lambda: mutual_nn_match_cuda(q, db), q.shape[0], 8)


def make_extractor(state_dict, k: int, dev) -> Extractor:
    """The production extractor: bf16 trunk on the card, f32 on the CPU."""
    return Extractor(state_dict, ExtractionConfig(max_keypoints=k, conf_threshold=0.001), dev)


def extract_stage(ex: Extractor, images: np.ndarray, name: str, inner: int,
                  width: int | None = None) -> Stage:
    """``Extractor``'s device program on a device-resident uint8 batch (the
    upload is not timed, as in ``bench.py``); `width`: the images' true width
    inside the padded batch."""
    b, h, w = images.shape[:3]
    imgs = _t(images, ex.device)
    sizes = torch.tensor([[width or w, h]] * b, dtype=torch.int32, device=ex.device)
    return Stage(name, lambda: ex._run(imgs, sizes), b, inner)


def pnp_stage(inp: dict, dev) -> Stage:
    """PnP-RANSAC as the engine runs it, the same sample draws every call."""
    args = (_t(inp["pnp_xy"], dev), _t(inp["pnp_pts"], dev), _t(inp["cam8"], dev),
            _t(inp["pnp_valid"], dev))

    def pnp():
        return pnp_ransac(*args, threshold=15.0, generator=torch.Generator(dev).manual_seed(1),
                          num_hypotheses=N_HYP)

    return Stage("pnp", pnp, 1, 24)


def refine_program(qvec, tvec, points3d, points2d, cam_params, weights) -> graphs.Program:
    """5 × ``refine_pose_lm(iterations=2)`` over a leading query axis as one
    captured segment (``bench.py:472-483``); packed result [Q, 7]."""

    def packed(inputs, _):
        q, t, p3, xy, cam, w = inputs
        for _ in range(5):
            q, t = _refine_pose_lm(q, t, p3, xy, cam, w, 2, 1e-3)
        return (torch.cat([q, t], dim=-1),)

    return graphs.Program(("bench_refine", 5, 2), ((True, packed),),
                          (qvec, tvec, points3d, points2d, cam_params, weights))


def refine_stage(inp: dict, dev, qvec: torch.Tensor, tvec: torch.Tensor,
                 inliers: torch.Tensor) -> Stage:
    """The refinement of a PnP result on its inlier mask."""
    program = refine_program(qvec.reshape(1, 4).contiguous(), tvec.reshape(1, 3).contiguous(),
                             _t(inp["pnp_pts"], dev)[None], _t(inp["pnp_xy"], dev)[None],
                             _t(inp["cam8"], dev)[None], inliers.reshape(1, -1).float())
    return Stage("refine", lambda: graphs.run(program), 1, 24)


class GraphBA:
    """``bundle_adjust(problem, lm_iters, cg_iters)`` with the LM iteration
    captured once: each call runs ``lm_setup`` (the state before the first
    iteration) and, on the card, replays the iteration's graph ``lm_iters``
    times; on the CPU it steps the iteration eagerly. ``bundle_adjust``
    captures anew on every call (each call may bring a new problem); the
    bench repeats one problem, so it captures during its warm call only.
    K3's launches are counted per replay."""

    def __init__(self, problem: BAProblem, lm_iters: int = 3, cg_iters: int = 10):
        self.problem, self.lm_iters, self.cg_iters = problem, lm_iters, cg_iters
        self.iterate, state = lm_setup(problem, cg_iters)
        self.graph = None
        if not problem.points.is_cuda:
            return
        dev = problem.points.device
        caller, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            self.iterate(state)  # eager first: module loads, cuBLAS's workspace
            self.graph, self.static, self.captured = capture_iteration(self.iterate, state)
        caller.wait_stream(side)

    def __call__(self):
        _, state = lm_setup(self.problem, self.cg_iters)
        if self.graph is None:
            for _ in range(self.lm_iters):
                state = self.iterate(state)
            return lm_result(state)
        for dst, src in zip(self.static, state):
            dst.copy_(src)
        for _ in range(self.lm_iters):
            self.graph.replay()
        count_graph_replays(self.captured, self.lm_iters)
        return lm_result(self.static)


def ba_problem(inp: dict, dev) -> BAProblem:
    return BAProblem(**{k: _t(v, dev) for k, v in inp["ba"].items()})


def ba_stage(inp: dict, dev) -> Stage:
    return Stage("ba", GraphBA(ba_problem(inp, dev), lm_iters=3, cg_iters=10), 1, 3)


def verify_stage(inp: dict, dev, hyp: int) -> Stage:
    args = (_t(inp["verify_xy1"], dev), _t(inp["verify_xy2"], dev), _t(inp["verify_valid"], dev))

    def verify():
        return verify_fundamental_ransac(*args, 4.0, torch.Generator(dev).manual_seed(32),
                                         num_hypotheses=hyp)

    return Stage("verify", verify, args[0].shape[0], 4)


def triang_stage(inp: dict, dev) -> Stage:
    args = {k: _t(v, dev) for k, v in inp["triang"].items()}
    return Stage("triang", lambda: triangulate_tracks(**args), args["obs_mask"].shape[0], 4)


# ---------------------------------------------------------------------------
# roofline numerators
# ---------------------------------------------------------------------------


def conv_layers(model: torch.nn.Module, b: int, h: int, w: int) -> list:
    """(weight shape, groups, input shape, output shape, dtype) of every
    convolution of `model` (the unfused forward, so the stem's two convs
    are its first two) at input [b, h, w, 3], from a forward on the meta
    device: shapes only, no arithmetic."""
    meta = copy.deepcopy(model).to("meta")
    layers = []

    def hook(mod, args, out):
        layers.append((tuple(mod.weight.shape), mod.groups, tuple(args[0].shape),
                       tuple(out.shape), out.dtype))

    handles = [m.register_forward_hook(hook) for m in meta.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            meta(torch.empty((b, h, w, 3), device="meta"))
    finally:
        for hd in handles:
            hd.remove()
    return layers


def extract_cost(model: torch.nn.Module, b: int, h: int, w: int) -> tuple:
    """(FLOPs, bytes) of the extraction network on a [b, h, w, 3] batch,
    counted by hand: 2 · kh · kw · Cin · Cout · Hout · Wout / groups over
    every convolution (the stem counted as conv1a and conv1b, whatever runs
    them), and each layer's input, weights and output once in the dtype it
    runs in, the stem as K1 moves them (the f32 image in, its f32 weights,
    out1c out in the trunk's dtype). The keypoint ops' elementwise work is
    not counted."""
    layers = conv_layers(model, b, h, w)
    flops = sum(2 * np.prod(wt) * np.prod(out[2:]) * out[0] for wt, _, _, out, _ in layers)
    size = torch.empty((), dtype=layers[0][4]).element_size()
    nbytes = b * h * w * 3 * 4 + sum(np.prod(wt) * 4 for wt, *_ in layers[:2]) \
        + np.prod(layers[1][3]) * size
    for wt, _, inp, out, dt in layers[2:]:
        size = torch.empty((), dtype=dt).element_size()
        nbytes += (np.prod(inp) + np.prod(wt) + np.prod(out)) * size
    return float(flops), float(nbytes)


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0
        k.shapes.clear()


def read_launches() -> dict:
    """{kernel: {launch shape as a JSON list: count}} of the launches so far."""
    return {name: {json.dumps(list(key)): n for key, n in k.shapes.items()}
            for name, k in KERNELS.items() if k.launches}


@contextlib.contextmanager
def uncounted():
    """Launches inside (a kernel held against its plain version) leave the
    launch counts as they were."""
    saved = {name: (k.launches, collections.Counter(k.shapes)) for name, k in KERNELS.items()}
    try:
        yield
    finally:
        for name, k in KERNELS.items():
            k.launches = saved[name][0]
            k.shapes.clear()
            k.shapes.update(saved[name][1])


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def _peak_mb(dev) -> float | None:
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**20


def _nvidia_smi() -> tuple:
    """(name, power limit in W) as nvidia-smi reports the card."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    name, limit = (p.strip() for p in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def run_bench(shared: dict, device="cuda", quick: bool = False, n_passes: int = 3) -> dict:
    """Every stage, the passes, the exactness check and the end-to-end run;
    the line is kept current in ``shared["result"]``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    shapes = FULL if on_card and not quick else SMALL
    shared.update(platform=dev.type, quick=quick, phase="setup", n_db=N_DB,
                  matcher="cuda" if on_card else "plain",
                  fused_stem="cuda" if on_card else "off")
    times = shared.setdefault("times", {})
    errors = shared.setdefault("stage_errors", {})
    peak = shared.setdefault("peak_mem_mb", {})
    if on_card:
        shared["device_name"], shared["power_limit_w"] = _nvidia_smi()
    fence = cuda_fence if on_card else (lambda _out=None: None)
    reset_launches()
    shared["fence"] = measure_rtt(device=dev, fence=fence)
    shared["result"] = _compose(shared)

    def fence_min():
        shared["fence"] = min(shared["fence"], measure_rtt(4, device=dev, fence=fence))
        return shared["fence"]

    stages = []

    def add_stage(make: Callable[[], Stage]):
        """Build a stage (its warm call captures what it captures), register
        it and measure one window pair at once."""
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        stage = make()
        fence(stage.fn())  # warm
        stages.append(stage)
        shared["phase"] = f"measure:{stage.name}:pass0"
        try:
            t = timed_per_item(stage.fn, fence, stage.items, iters=1, inner=stage.inner,
                               rtt=fence_min())
            times[stage.name] = min(times.get(stage.name, float("inf")), t)
        except Exception as e:
            errors[stage.name] = f"{type(e).__name__}: {e}"
        if on_card:
            peak[stage.name] = _peak_mb(dev)
        shared["result"] = _compose(shared)
        return stage

    inp = stage_inputs(shapes)
    ex_dtype = torch.bfloat16 if on_card else torch.float32
    shared["phase"] = "build:gemm"
    add_stage(lambda: gemm_stage(inp, dev, ex_dtype, shapes.gemm_reps))
    shared["gemm_flops_total"] = shapes.gemm_reps * 2 * shapes.gemm_n ** 3
    shared["gemm_dtype"] = str(ex_dtype).replace("torch.", "")
    shared["phase"] = "build:match"
    add_stage(lambda: match_stage(inp, dev))

    shared["phase"] = "build:extract"
    ex = make_extractor(seeded_state_dict(SEED), shapes.k, dev)
    flops, nbytes = extract_cost(ex.model, shapes.ex_batch, shapes.hw, shapes.hw)
    shared.update(extract_flops=flops, extract_bytes=nbytes, ex_batch=shapes.ex_batch)
    add_stage(lambda: extract_stage(ex, inp["images"], "extract", 8))

    shared["phase"] = "build:pnp"
    pnp = add_stage(lambda: pnp_stage(inp, dev))
    shared["phase"] = "build:refine"
    res = pnp.fn()
    add_stage(lambda: refine_stage(inp, dev, res.qvec, res.tvec, res.inliers))
    shared["phase"] = "build:ba"
    add_stage(lambda: ba_stage(inp, dev))
    shared["ba_frames"] = N_DB

    if shapes.r1600:
        shared["phase"] = "build:extract1600"
        try:
            add_stage(lambda: extract_stage(ex, inp["images1600"], "extract1600", 4,
                                            width=R1600[2]))
        except Exception as e:  # an extra stage never ends the run
            errors["extract1600"] = f"{type(e).__name__}: {e}"[:400]
    try:
        shared["phase"] = "build:verify"
        add_stage(lambda: verify_stage(inp, dev, shapes.verify_hyp))
        shared["phase"] = "build:triang"
        add_stage(lambda: triang_stage(inp, dev))
    except Exception as e:
        errors["mapbuild"] = f"{type(e).__name__}: {e}"[:400]
    shared["result"] = _compose(shared)

    def captures():  # the localization programs' graphs and BA's
        return counter("graphs.captures") + counter("ba.captures")

    before = captures()
    by_pass = shared.setdefault("times_by_pass", [])
    for p in range(n_passes):
        pass_times: dict = {}
        by_pass.append(pass_times)
        for stage in stages:
            shared["phase"] = f"measure:{stage.name}:pass{p + 1}"
            try:
                t = timed_per_item(stage.fn, fence, stage.items, inner=stage.inner,
                                   rtt=fence_min())
                times[stage.name] = min(times.get(stage.name, float("inf")), t)
                pass_times[stage.name] = t
            except Exception as e:
                errors[stage.name] = f"{type(e).__name__}: {e}"
            shared["result"] = _compose(shared)
        shared["passes_completed"] = p + 1
        shared["result"] = _compose(shared)
        if p == 0 and os.environ.get("BENCH_EXACT", "1") == "1":
            shared["phase"] = "kernels_exact"
            try:
                with uncounted():
                    kernel_exactness(shared, dev)
            except Exception as e:
                errors["kernels_exact"] = f"{type(e).__name__}: {e}"
            shared["result"] = _compose(shared)
    shared["graph_captures_in_passes"] = captures() - before
    if shared["graph_captures_in_passes"]:
        errors["graphs"] = f"{shared['graph_captures_in_passes']} graphs captured in the passes"
    shared["launches"] = read_launches()
    shared["result"] = _compose(shared)

    if os.environ.get("BENCH_E2E", "1") == "1":
        shared["phase"] = "e2e"
        try:
            e2e_localize(shared, dev, quick)
        except Exception as e:
            errors["e2e"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        shared["launches"] = read_launches()
        shared["result"] = _compose(shared)
    shared["phase"] = "done"
    return shared["result"]


@contextlib.contextmanager
def _exact_f32():
    """f32 products and convolutions without TF32, for comparisons."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def kernel_exactness(shared: dict, device) -> None:
    """Each kernel of the path against its plain version on the card, at
    ``bench.py``'s shapes (``bench.py:677-764``). On the CPU no kernel can
    run: ``kernels_exact`` is None and ``kernel_deltas`` "plain"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        shared["kernels_exact"], shared["kernel_deltas"] = None, "plain"
        return
    rng = np.random.default_rng(7)
    b, k = 2, 512
    d0, d1 = (_t(_unit(rng, (b, k, C)), dev) for _ in range(2))
    v0, v1 = (_t(rng.uniform(size=(b, k)) > 0.1, dev) for _ in range(2))
    deltas = {"rows": b * k}
    with _exact_f32():
        for key, kernel, plain in (
                ("nnm", mutual_nn_match_cuda, mutual_nn_match),
                ("nnr", lambda *a: mutual_nn_ratio_match_cuda(a[0], a[1], 0.95, *a[2:]),
                 lambda *a: mutual_nn_ratio_match(a[0], a[1], 0.95, *a[2:]))):
            m_k, s_k = kernel(d0, d1, v0, v1)
            m_p, s_p = plain(d0, d1, v0, v1)
            deltas[f"{key}_idx"] = int((m_k != m_p).sum())
            deltas[f"{key}_score"] = float((s_k - s_p).abs().max())

        table = _t(rng.standard_normal((1000, 3), dtype=np.float32), dev)
        idx = _t(rng.integers(0, 1000, 333).astype(np.int32), dev)
        deltas["gather"] = float((gather_rows_cuda(table, idx)
                                  - gather_rows_plain(table, idx)).abs().max())
        big = _t(rng.standard_normal((100_000, 3), dtype=np.float32), dev)
        bidx = _t(np.sort(rng.integers(0, 100_000, 4096)).astype(np.int32), dev)
        deltas["gather_big_sorted"] = float((gather_rows_cuda(big, bidx)
                                             - gather_rows_plain(big, bidx)).abs().max())

        # K1 reads the folded direct 3x3 weights, so its PackedStem is a
        # real stem's (random packed entries would be no 3x3 conv).
        packed = PackedStem(*(t.to(dev) for t in repack_stem_params(seeded_state_dict(7))))
        xs = _t(rng.standard_normal((1, 64, 256, 3), dtype=np.float32), dev)
        ref = fused_stem_apply(xs, packed, torch.float32)
        got = fused_stem_cuda(xs, StemWeights(packed, dev), torch.float32)
        deltas["stem_rel"] = float((got - ref).abs().max() / max(1e-6, float(ref.abs().max())))

    shared["kernel_deltas"] = deltas
    shared["kernels_exact"] = bool(
        deltas["nnm_idx"] <= 0.001 * deltas["rows"] and deltas["nnm_score"] <= 1e-5
        and deltas["nnr_idx"] <= 0.001 * deltas["rows"] and deltas["nnr_score"] <= 1e-5
        and deltas["gather"] == 0.0 and deltas["gather_big_sorted"] == 0.0
        and deltas["stem_rel"] <= 1e-4)


# localize_throughput's phases: breakdown key → the span that times it.
BATCHED_PHASES = {"assemble_ms": "engine.assemble", "covis_ms": "engine.frames",
                  "lm_ms": "engine.refine", "match_dispatch_ms": "engine.batched_match.dispatch",
                  "match_fetch_ms": "engine.batched_match.fetch",
                  "pnp_dispatch_ms": "engine.batched_pnp.dispatch",
                  "pnp_fetch_ms": "engine.batched_pnp.fetch", "setup_ms": "engine.query_feats"}


def batched_breakdown(records: list, wall_s: float) -> dict:
    """Milliseconds of each of ``localize_throughput``'s phases in the
    records of one call, the megabytes its matches fetched, and the rest of
    its wall time (``other_ms``)."""
    out = {k: sum(r.t1 - r.t0 for r in records if r.name == name) / 1e6
           for k, name in BATCHED_PHASES.items()}
    out["match_fetch_mb"] = sum(r.tags["mb"] for r in records
                                if r.name == "engine.batched_match.fetch")
    out["other_ms"] = wall_s * 1e3 - sum(out[k] for k in BATCHED_PHASES)
    return out


def _recall(results, queries) -> tuple:
    errs = np.array([pose_error(r.qvec, r.tvec, q_gt, t_gt)
                     for r, (_, q_gt, t_gt, _) in zip(results, queries)])
    return errs[:, 0], errs[:, 1]


def e2e_localize(shared: dict, device, quick: bool) -> None:
    """Wall-clock ``LocalizationEngine`` over the synthetic corridor map
    (``bench.py:767-891``): host orchestration, transfers and device work,
    nothing subtracted. On the card the production shapes (4096 kp, 50
    retrieved frames, C=128; the ``localize`` phase of ``chip_smoke.py``),
    else ``bench.py``'s quick scene. The sequential pass leaves query 0 out
    of ``e2e_query_ms`` (it captures the graphs), then ``localize_many`` (4
    workers) and ``localize_throughput``, warmed and then timed."""
    dev = torch.device(device)
    production = dev.type == "cuda" and not quick
    if production:
        n_img, n_q = 60, 8
        scene_kw = dict(n_points=14000, kp_per_image=4096, kp_per_query=4096, desc_dim=128,
                        retrieval_k=50)
        cfg = LocalizerConfig(max_keypoints=4096, pnp_pad_floor=4096)
    else:
        n_img, n_q = (20, 4) if quick else (60, 12)
        scene_kw = dict(n_points=2000, kp_per_image=700, kp_per_query=500, retrieval_k=10)
        cfg = LocalizerConfig(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10,
                              covisibility_frame=10, iters=2, radius=12.0, obs_thresh=3,
                              max_keypoints=1024, num_hypotheses=512, pnp_pad_floor=4096)
    store = FeatureStore()
    scene = build_corridor_scene(store, n_images=n_img, n_queries=n_q, seed=7, **scene_kw)
    eng = LocalizationEngine(scene.map_index, store, cfg, device=dev)
    g0 = counter("graphs.captures")
    per_q, seq = [], []
    for i, (qname, _, _, near) in enumerate(scene.queries):
        t0 = time.perf_counter()
        seq.append(eng.localize(qname, scene.qinfo, [[j] for j in near]))
        if i > 0:  # the first query captures the graphs
            per_q.append(time.perf_counter() - t0)
            shared["e2e_query_ms"] = round(float(np.median(per_q)) * 1e3, 1)
            shared["result"] = _compose(shared)
    q_err, t_err = _recall(seq, scene.queries)
    shared["e2e_recall_025m_2deg"] = round(float(np.mean((t_err < 0.25) & (q_err < 2.0))), 3)
    shared["e2e_recall_05m_5deg"] = round(float(np.mean((t_err < 0.5) & (q_err < 5.0))), 3)
    shared["e2e_med_terr_m"] = round(float(np.median(t_err)), 4)
    shared["e2e_med_rerr_deg"] = round(float(np.median(q_err)), 3)
    shared["result"] = _compose(shared)

    jobs = [(qname, scene.qinfo, [[j] for j in near]) for qname, _, _, near in scene.queries]
    t0 = time.perf_counter()
    results_p = eng.localize_many(jobs, workers=4)
    wall_p = time.perf_counter() - t0
    seq_qps = 1.0 / float(np.median(per_q)) if per_q else 0.0
    pip_qps = len(jobs) / wall_p
    shared["e2e_qps_sequential"] = round(seq_qps, 2)
    shared["e2e_qps_pipelined"] = round(pip_qps, 2)
    shared["result"] = _compose(shared)
    eng.localize_throughput(jobs)  # warm: the batched shapes' graphs
    g1 = counter("graphs.captures")
    with recording() as recs:
        t0 = time.perf_counter()
        results_b = eng.localize_throughput(jobs)
        wall_b = time.perf_counter() - t0
    bat_qps = len(jobs) / wall_b
    shared["e2e_qps_batched"] = round(bat_qps, 2)
    shared["e2e_batched_breakdown"] = {
        k: round(v, 2 if k == "match_fetch_mb" else 1)
        for k, v in batched_breakdown(recs, wall_b).items()}
    shared["e2e_pipeline_speedup"] = round(max(pip_qps, bat_qps) / seq_qps, 2) if seq_qps else 0.0
    acc_p = sum(r.source == "accepted" for r in results_p)
    acc_b = sum(r.source == "accepted" for r in results_b)
    n_acc = sum(r.source == "accepted" for r in seq)
    shared["e2e_accept_batched"] = f"{acc_b}/{len(jobs)}"
    qe_b, te_b = _recall(results_b, scene.queries)
    shared["e2e_recall_batched"] = round(float(np.mean((te_b < 0.25) & (qe_b < 2.0))), 3)
    shared["e2e_graphs"] = dict(captures_sequential_and_pipelined=g1 - g0,
                                captures_timed_batched=counter("graphs.captures") - g1)
    shared["e2e_note"] = (
        f"median wall-clock over {len(per_q)} queries ({n_img}-img map"
        f"{', PRODUCTION 4096kp/50-frame shapes' if production else ''}, "
        f"{n_acc}/{len(scene.queries)} accepted seq, {acc_p} pipelined; "
        "host orchestration + transfers + device; first query (graph capture) excluded)")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--quick", action="store_true",
                        help="the CPU branch's small shapes (BENCH_QUICK=1)")
    parser.add_argument("--passes", type=int, default=None,
                        help="measurement passes (BENCH_PASSES, default 3)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", type=Path, default=Path("chiprun_out/BENCH_torch.json"))
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Run the bench under a budgeted watchdog (the work runs in a daemon
    thread that keeps the line current; at the budget the watchdog emits
    what was measured). Prints exactly one JSON line, last on stdout, and
    returns the exit code: 1 if ``failed(line)``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)  # no card where one is asked for: raises here
    quick = args.quick or os.environ.get("BENCH_QUICK") == "1"
    passes = args.passes if args.passes is not None else int(os.environ.get("BENCH_PASSES", "3"))
    budget = float(os.environ.get("BENCH_BUDGET_S", "2400"))
    shared: dict = {}
    stdout = sys.stdout  # the line's stream: the work writes to stderr
    _append_attempt({"event": "start", "budget_s": budget, "argv": sys.argv[1:]})
    done = threading.Event()

    def work():
        try:
            with contextlib.redirect_stdout(sys.stderr):  # stdout holds the line alone
                run_bench(shared, dev, quick, passes)
        except Exception as e:  # never end without the line
            shared.setdefault("stage_errors", {})["fatal"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            shared["result"] = _compose(shared)
        finally:
            done.set()

    t0 = time.time()
    threading.Thread(target=work, daemon=True).start()
    last_phase = None
    while time.time() - t0 < budget and not done.is_set():
        done.wait(5.0)
        phase = shared.get("phase")
        if phase != last_phase:
            print(f"[bench +{time.time() - t0:.0f}s] {phase}", file=sys.stderr, flush=True)
            last_phase = phase
    result = shared.get("result")
    if result is None:
        result = {"metric": METRIC, "value": 0.0, "unit": "frames/s (bench produced nothing)",
                  "error": f"no stage completed within {budget:.0f}s ({shared.get('phase')})"}
    elif not done.is_set():
        result = dict(result, error=f"watchdog budget {budget:.0f}s expired during "
                                    f"{shared.get('phase')!r}; emitting stages measured so far")
    _append_attempt({"event": "end", "elapsed_s": round(time.time() - t0, 1),
                     "completed": done.is_set(), "phase": shared.get("phase"),
                     "platform": shared.get("platform"), "quick": quick,
                     "value": result.get("value"), "error": result.get("error")})
    line = json.dumps(result)
    try:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    except OSError as e:
        print(f"bench: could not write {args.out}: {e}", file=sys.stderr)
    print(line, file=stdout, flush=True)
    return 1 if failed(result) or not done.is_set() else 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # a watchdog expiry leaves the work thread behind
