"""Map building from covisibility pairs: ``match_pairs``, then
``geometric_verification``, over the DB of the configuration's map.

Set-up, all from the seed: the corridor scene's DB images
(``portbench/scene.py``, built as the serve cells build it; no query is
drawn) in an in-memory ``FeatureStore`` as the preset writes them; the
covisibility pair list of the mix (``portbench/covis.py``); one call on
the ``warmup_pairs`` pairs before the window's start, into a match store
that is then dropped.

Window: calls of ``chunk_pairs`` consecutive pairs of the list, from a
start drawn from the seed, the next call when the last has returned.
Each call is the map builder's path: ``pipeline/match.py::match_pairs``
with the mix's matcher and batch at the configuration's keypoints fills
one in-memory ``MatchStore`` kept across calls (a pair whose reverse an
earlier call matched is read, not matched again, as hloc does), then
``sfm/pipeline.py::geometric_verification`` with the mix's thresholds
verifies every pair of the call. A call that would pass the list's end
goes on from its start; once the whole list has been matched, the next
call starts a new store. ``map_pairs_per_s`` is the pairs of every
finished call over the time to the last one's end.

Check, once the window has closed and the device's caches are freed: a
sample of the window's pairs drawn from the seed. For each, the matches
the matcher wrote (``match_gap``, ``reference/match.py``, as in the serve
cells) and what verification kept of the matches it was given, against
the scene's ground truth (``verified_outlier_share``,
``verified_drop_share``, ``reference/mapbuild.py``), pooled over the
sample. The share of the window's pairs verified and their mean inliers
are printed beside them.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench.covis import pairs_from_covisibility
from portbench.drivers.serve import db_name, scene_size
from portbench.reference.mapbuild import given_matches, verification_counts
from portbench.reference.match import match_gap, similarities
from portbench.scene import make_scene, sub_seed
from portbench.trace import DeviceTrace, Spans


def db_size(config: dict):
    """The configuration's map with no query pool."""
    return dataclasses.replace(scene_size(config), n_q=0)


def feature_store(scene):
    """Every DB image's keypoints and descriptors, as the preset writes them."""
    from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures

    size = scene.size
    store = FeatureStore()
    scores = np.linspace(1.0, 0.5, size.kp, dtype=np.float32)
    wh = np.array([size.width, size.height])
    for i in range(size.n_db):
        n = int(scene.db_nv[i])
        store.write(db_name(i), ImageFeatures(scene.db_kp[i, :n], scene.db_desc[i][:, :n].T,
                                              scores[:n], wh))
    return store


def match_store():
    """An in-memory ``MatchStore``, and the set of (name0, name1) in the
    direction the matcher wrote each pair."""
    from sfd2_torch.io.feature_store import MatchStore

    store, written = MatchStore(), set()
    inner = store.write

    def write(name0, name1, *args, **kwargs):
        written.add((name0, name1))
        return inner(name0, name1, *args, **kwargs)

    store.write = write
    return store, written


def configs(cell):
    """(MatchConfig, TriangulationConfig, max_matches) of the mix."""
    from sfd2_torch.pipeline.match import MatchConfig
    from sfd2_torch.sfm.pipeline import TriangulationConfig

    mix, v = cell.mix, cell.mix["verify"]
    mcfg = MatchConfig(matcher=mix["match"]["matcher"], batch_size=mix["match"]["batch_size"],
                       max_keypoints=cell.config["map"]["keypoints"])
    tcfg = TriangulationConfig(verify_threshold=v["threshold_px"],
                               verify_min_inliers=v["min_inliers"],
                               verify_min_inlier_ratio=v["min_inlier_ratio"],
                               verify_batch=v["batch"])
    return mcfg, tcfg, v["max_matches"]


def take(pairs: np.ndarray, start: int, n: int) -> np.ndarray:
    """`n` consecutive rows of the list from `start`, going on from its start."""
    return pairs[(start + np.arange(n)) % len(pairs)]


def start_of(pairs: np.ndarray, seed: int) -> int:
    """The row of the list at which the seed's window starts."""
    return int(np.random.default_rng(sub_seed(seed, 9)).integers(len(pairs)))


def keep_rng(seed: int) -> np.random.Generator:
    """Draws, call after call, the positions whose answers a check may sample."""
    return np.random.default_rng(sub_seed(seed, 10))


def names(rows: np.ndarray) -> list:
    return [(db_name(int(i)), db_name(int(j))) for i, j in rows]


def setup(cell, seed: int, device, stages: dict | None = None, t0: float = 0.0):
    """(scene, features, pair list [M, 2]) of the seed."""
    stages = {} if stages is None else stages
    scene = make_scene(db_size(cell.config), seed, device)
    stages["scene"] = time.time() - t0
    features = feature_store(scene)
    stages["feature_store"] = time.time() - t0
    pairs = pairs_from_covisibility(scene.db_point, cell.mix["num_matched"], device)
    stages["pairs"] = time.time() - t0
    return scene, features, pairs


def run(ctx: dict) -> dict:
    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    mix = cell.mix
    from sfd2_torch.pipeline.match import match_pairs
    from sfd2_torch.sfm.pipeline import geometric_verification

    stages = {"start": time.time() - ctx["t_process"]}
    scene, features, pairs = setup(cell, seed, device, stages, ctx["t_process"])
    mcfg, tcfg, max_matches = configs(cell)
    chunk, check = mix["chunk_pairs"], mix["check_pairs"]
    start = start_of(pairs, seed)
    warm = names(take(pairs, start - mix["warmup_pairs"], mix["warmup_pairs"]))
    scratch, _ = match_store()
    match_pairs(features, warm, scratch, mcfg, device=device)  # every kernel, once
    geometric_verification(features, scratch, warm, tcfg, max_matches, device=device)
    del scratch
    if device != "cpu":
        torch.cuda.synchronize()
    stages["warmup"] = time.time() - ctx["t_process"]

    spans = Spans()
    store, written = match_store()
    stores = [(store, written)]
    keeps = keep_rng(seed)
    kept = []  # (row of the list, its store, the verification's inliers or None)
    pos, listed, steps, done, n_verified, n_inliers = start, 0, 0, 0, 0, 0
    t_start = time.perf_counter()
    setup_s = time.time() - ctx["t_process"]
    t_trace = t_start + seconds * mix["trace_from"] if ctx["trace"] else None
    trace = None
    while True:
        if t_trace is not None and trace is None and time.perf_counter() >= t_trace:
            trace, written_before = DeviceTrace(), len(written)
            trace.start()
        if listed + chunk > len(pairs):  # the whole list matched: a new map build
            store, written = match_store()
            stores.append((store, written))
            listed = 0
        rows = take(pairs, pos, chunk)
        call = names(rows)
        t0 = time.perf_counter_ns()
        match_pairs(features, call, store, mcfg, device=device)
        t1 = time.perf_counter_ns()
        verified = geometric_verification(features, store, call, tcfg, max_matches,
                                          device=device)
        t2 = time.perf_counter_ns()
        spans.add("mapbuild.match", t0, t1)
        spans.add("mapbuild.verify", t1, t2)
        got = {(n0, n1): inl for n0, n1, inl in verified}
        for p in keeps.choice(len(rows), min(check, len(rows)), replace=False):
            kept.append((rows[p], stores[-1], got.get(call[p])))
        n_verified += len(verified)
        n_inliers += sum(len(inl) for _, _, inl in verified)
        pos = (pos + chunk) % len(pairs)
        listed += chunk
        steps += 1
        done += len(rows)
        # The profiler's start holds the loop for seconds: the traced part
        # is counted from the trace's own start.
        if trace is not None and trace.t1 is None and \
                time.perf_counter_ns() >= trace.t0 + seconds * mix["trace_share"] * 1e9:
            trace.stop()
            k2_pairs = len(written) - written_before
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    if trace is not None and trace.t1 is None:
        trace.stop()
        k2_pairs = len(written) - written_before
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False  # the reference runs in full precision
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = verify(ctx, scene, program_answers(kept, seed, check))
    numbers.update(check_s=time.perf_counter() - t_check, setup_stages_s=stages, calls=steps,
                   verified_pair_share=n_verified / max(done, 1),
                   mean_inliers=n_inliers / max(n_verified, 1))
    size = scene.size
    layer_ctx = dict(spans=spans, window_s=window_s, pairs_done=done)
    if trace is not None:
        layer_ctx["trace"] = trace.summary(spans)
        # K2's work as the traced calls needed it: one [K, K, C] product
        # per pair the matcher wrote there.
        layer_ctx["k2_work"] = [(k2_pairs, size.kp, size.kp, size.c)]
    return dict(e2e={"map_pairs_per_s": done / window_s, "setup_s": setup_s}, numbers=numbers,
                attempted=done, failed=0, memory_peak_bytes=int(peak), layer_ctx=layer_ctx,
                trace=layer_ctx.get("trace"))


def program_answers(kept: list, seed: int, n: int) -> list:
    """A seeded sample of `n` kept pairs, each as (i0, i1, reversed, the
    matcher's answer in the direction it wrote, kept inliers or None)."""
    rng = np.random.default_rng(sub_seed(seed, 11))
    out = []
    for k in sorted(rng.choice(len(kept), min(n, len(kept)), replace=False)):
        (i0, i1), (store, written), inliers = kept[k]
        n0, n1 = db_name(int(i0)), db_name(int(i1))
        rev = (n0, n1) not in written
        m = store.read(n1, n0)[0] if rev else store.read(n0, n1)[0]
        out.append((int(i0), int(i1), rev, m, inliers))
    return out


def verify(ctx, scene, answers: list) -> dict:
    """The compared numbers over the sampled pairs' answers."""
    cell, device = ctx["cell"], ctx["device"]
    dev = torch.device(device)
    max_matches = cell.mix["verify"]["max_matches"]
    k = scene.size.kp
    cols = torch.arange(k, device=dev)
    gaps, totals = [], np.zeros(4, np.int64)
    for i0, i1, rev, m, inliers in answers:
        a, b = (i1, i0) if rev else (i0, i1)
        q = torch.from_numpy(np.ascontiguousarray(scene.db_desc[a].T)).to(dev)
        bank = torch.from_numpy(np.ascontiguousarray(scene.db_desc[b].T)).to(dev)
        s = similarities(q, bank[None], cols < int(scene.db_nv[a]),
                         (cols < int(scene.db_nv[b]))[None])
        full = np.full(k, -1, np.int64)
        full[:len(m)] = m
        gaps.append(match_gap(s, torch.from_numpy(full)[None]))
        given = given_matches(full, rev, max_matches)
        totals += verification_counts(scene.db_point[i0], scene.db_point[i1], given, inliers)
    if not answers:
        return {"match_gap": None, "verified_outlier_share": None, "verified_drop_share": None,
                "pairs_checked": 0}
    kept, outliers, true_given, dropped = (int(t) for t in totals)
    return {"match_gap": max(gaps), "verified_outlier_share": outliers / max(kept, 1),
            "verified_drop_share": dropped / max(true_given, 1), "pairs_checked": len(answers),
            "kept_checked": kept, "true_given_checked": true_given}
